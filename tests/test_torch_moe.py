"""The port's MoE family against the JAX package at reduced size:
llama4-maverick (top-1, a dense/MoE interleave of 2) and arctic (top-2,
every layer MoE), both with a dense residual.

The MoE layer alone (``repro_torch.models.moe.MoE`` against
``repro.models.moe.apply_moe``, the same parameters, inputs from a numpy
seed): output within 1e-5 and aux loss within 1e-6, the dispatch masks
identical and the combine weights within 1e-6, read from the
reference's ``moe_dispatch`` sharding hints.  The cases cover top-1 and
top-2, with and without the dense residual, S = 1 (a decode step), an S
that the routing group does not divide (12 tokens in groups of 8 ->
groups of 6) and a batch that overflows an expert's capacity, so that
tokens drop.  The whole reduced models: ``api.init(PRNGKey(0))``
parameters through ``params_from_jax``; prefill logits and 4
teacher-forced decode steps within 2e-3, ``train_loss`` (cross-entropy
and aux) within 2e-4, with the JAX side on its XLA backend and on its
Pallas kernels in interpret mode; greedy tokens through both generate
programs equal.  The layer's gradients (parameters and input) against
``jax.grad`` of ``apply_moe`` at 1e-5, random and skewed; ``remat=True``
training gives ``remat=False``'s gradients bit for bit.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.models.moe as jmoe
import repro_torch.configs as tcfgs
from repro import kernels as jkernels
from repro.models import build as jbuild
from repro_torch.interop import params_from_jax
from repro_torch.models import build as tbuild
from repro_torch.models import moe as tmoe

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards, as in the other tight-tolerance port tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ARCHS = ["llama4_maverick_400b_a17b", "arctic_480b"]
TOL, LOSS_TOL = 2e-3, 2e-4
LAYER_TOL, AUX_TOL = 1e-5, 1e-6
B, T = 2, 12


def _cfgs(arch, **moe):
    """The reduced config of ``arch`` in both packages, MoE fields replaced."""
    cj, ct = jcfgs.reduced(jcfgs.get(arch)), tcfgs.reduced(tcfgs.get(arch))
    if moe:
        cj = cj.replace(moe=dataclasses.replace(cj.moe, **moe))
        ct = ct.replace(moe=dataclasses.replace(ct.moe, **moe))
    return cj, ct


def _models(arch):
    cfg_j, cfg_t = _cfgs(arch)
    api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
    params = api_j.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    return api_j, params, api_t, model


@pytest.fixture(scope="module")
def models():
    return {arch: _models(arch) for arch in ARCHS}


def _backend(name):
    return (jkernels.backend("pallas", interpret=True) if name == "pallas"
            else contextlib.nullcontext())


def _port_moe(p, cfg_t):
    """A port MoE layer holding the reference layer's parameters ``p``."""
    layer = tmoe.MoE(cfg_t, torch.Generator().manual_seed(0))
    for name, param in layer.named_parameters():
        a = p
        for key in name.split("."):
            a = a[key]
        assert tuple(a.shape) == tuple(param.shape), name
        with torch.no_grad():
            param.copy_(torch.tensor(np.asarray(a, np.float32)))
    return layer


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_mirror_the_reference(arch):
    for full in (True, False):
        cj, ct = jcfgs.get(arch), tcfgs.get(arch)
        if not full:
            cj, ct = jcfgs.reduced(cj), tcfgs.reduced(ct)
        for f in dataclasses.fields(ct):
            a, b = getattr(ct, f.name), getattr(cj, f.name)
            if f.name == "pattern":
                assert [(s.mixer, s.mlp, s.window) for s in a] == \
                       [(s.mixer, s.mlp, s.window) for s in b]
            elif f.name == "moe":
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, f.name


def test_default_pattern_of_an_moe_config_is_attention_and_moe():
    cfg = tcfgs.reduced(tcfgs.get("arctic_480b")).replace(pattern=())
    assert [(s.mixer, s.mlp) for s in cfg.pattern] == [("attn", "moe")]
    assert [(s.mixer, s.mlp) for s in cfg.replace(moe=None, pattern=()).pattern] == \
        [("attn", "dense")]


def test_routing_group_size_and_capacity_match_the_reference():
    for arch in ARCHS:
        for group in (0, 1, 8, 256):
            cj, ct = _cfgs(arch, group_size=group)
            for s in range(1, 300):
                g = tmoe.routing_group_size(ct, s)
                assert g == jmoe.routing_group_size(cj, s), (arch, group, s)
                assert tmoe.expert_capacity(ct, g) == jmoe.expert_capacity(cj, g)


def test_top_k_takes_the_lower_index_first_among_equals():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    for k in (1, 2, 3):
        vals_j, idx_j = jax.lax.top_k(jnp.asarray(probs), k)
        vals_t, idx_t = tmoe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))


# (arch, S, MoE fields replaced, inputs): "random" is unit normal; "skewed"
# is one shared direction plus 1% noise, so that every token picks the same
# experts and the capacity drops most of them
LAYER_CASES = [
    ("llama4_maverick_400b_a17b", 12, {}, "random"),
    ("arctic_480b", 12, {}, "random"),
    ("llama4_maverick_400b_a17b", 1, {}, "random"),
    ("arctic_480b", 1, {}, "random"),
    ("llama4_maverick_400b_a17b", 12, {"group_size": 8}, "random"),
    ("arctic_480b", 12, {"group_size": 8}, "random"),
    ("llama4_maverick_400b_a17b", 32, {}, "skewed"),
    ("arctic_480b", 32, {}, "skewed"),
    ("llama4_maverick_400b_a17b", 12, {"dense_residual": False}, "random"),
    ("arctic_480b", 12, {"dense_residual": False, "dense_residual_ff": 0}, "random"),
]


@pytest.mark.parametrize("case", LAYER_CASES, ids=lambda c: f"{c[0][:6]}-S{c[1]}-{c[3]}"
                         + "".join(f"-{k}={v}" for k, v in c[2].items()))
def test_moe_layer_matches_jax(case, monkeypatch):
    arch, S, fields, kind = case
    cfg_j, cfg_t = _cfgs(arch, **fields)
    p = jmoe.init_moe(jax.random.PRNGKey(1), cfg_j)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, cfg_t.d_model)).astype(np.float32)
    if kind == "skewed":
        x = rng.standard_normal((1, 1, cfg_t.d_model)).astype(np.float32) + 0.01 * x
    hints = {}
    monkeypatch.setattr(jmoe, "shard_hint",
                        lambda a, name: hints.setdefault(name, []).append(a) or a)
    out_j, aux_j = jmoe.apply_moe(p, jnp.asarray(x), cfg_j)
    dispatch_j, combine_j = (np.asarray(a) for a in hints["moe_dispatch"])

    layer = _port_moe(p, cfg_t)
    assert hasattr(layer, "residual") == cfg_t.moe.dense_residual
    xt = torch.from_numpy(x)
    out_t, aux_t = layer(xt)
    _, _, onehot, keep, dispatch_t, combine_t = layer.route(xt)
    np.testing.assert_array_equal(dispatch_t.numpy(), dispatch_j)
    np.testing.assert_allclose(combine_t.numpy(), combine_j, atol=AUX_TOL, rtol=0)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=LAYER_TOL,
                               rtol=LAYER_TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), atol=AUX_TOL, rtol=0)
    assert out_t.shape == (B, S, cfg_t.d_model) and aux_t.dtype == torch.float32
    G = tmoe.routing_group_size(cfg_t, S)
    assert dispatch_t.shape == (B * S // G, G, cfg_t.moe.n_experts,
                                tmoe.expert_capacity(cfg_t, G))
    dropped = int(onehot.sum() - keep.sum())
    assert int(keep.sum()) == int(dispatch_t.sum())
    if kind == "skewed":
        assert dropped > 0  # the capacity was exceeded
    if "group_size" in fields:
        assert G == 6  # 12 tokens in groups of 8 -> the divisor loop -> 6


GRAD_CASES = [c for c in LAYER_CASES if c[1] > 1 and not c[2]]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: f"{c[0][:6]}-S{c[1]}-{c[3]}")
def test_moe_layer_grads_match_jax(case):
    """d/d(params, x) of sum(out * w) + aux, the layer alone, against
    ``jax.grad`` of ``apply_moe`` at 1e-5: the gradient runs through the
    chosen gates and the combine, into the fp32 router through the
    load-balance and z losses, never through the dispatch, dropped tokens
    included (the skewed inputs)."""
    arch, S, _, kind = case
    cfg_j, cfg_t = _cfgs(arch)
    p = jmoe.init_moe(jax.random.PRNGKey(1), cfg_j)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, cfg_t.d_model)).astype(np.float32)
    if kind == "skewed":
        x = rng.standard_normal((1, 1, cfg_t.d_model)).astype(np.float32) + 0.01 * x
    w = rng.standard_normal(x.shape).astype(np.float32)

    def f(p, x):
        out, aux = jmoe.apply_moe(p, x, cfg_j)
        return jnp.sum(out * w) + aux

    gp_j, gx_j = jax.grad(f, argnums=(0, 1))(p, jnp.asarray(x))
    layer = _port_moe(p, cfg_t)
    layer.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = layer(xt)
    _, _, onehot, keep, _, _ = layer.route(xt.detach())
    if kind == "skewed":  # over a third of the (token, choice) pairs dropped
        assert 3 * int(onehot.sum() - keep.sum()) > int(onehot.sum())
    named = dict(layer.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                list(named.values()) + [xt])
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(gx_j), atol=LAYER_TOL,
                               rtol=LAYER_TOL, err_msg="x")
    for (name, param), g in zip(named.items(), grads):
        ref = gp_j
        for key in name.split("."):
            ref = ref[key]
        assert g.dtype == param.dtype, name
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=LAYER_TOL,
                                   rtol=LAYER_TOL, err_msg=name)


def test_aux_loss_alone_reaches_only_the_router():
    """The load-balance and z losses depend on the router's product and
    nothing downstream of the dispatch: their gradient is the router's
    alone, fp32 under bf16 weights, and nonzero."""
    _, cfg_t = (c.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
                for c in _cfgs("arctic_480b"))
    layer = tmoe.MoE(cfg_t, torch.Generator().manual_seed(0))
    layer.requires_grad_(True)
    x = torch.randn(B, 12, cfg_t.d_model, generator=torch.Generator().manual_seed(1))
    _, aux = layer(x.to(torch.bfloat16))
    named = dict(layer.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(aux, list(named.values()),
                                                allow_unused=True)))
    assert grads["router"].dtype == torch.float32
    assert float(grads["router"].abs().max()) > 0
    assert all(g is None for n, g in grads.items() if n != "router")


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(models, arch, jax_backend):
    api_j, params, api_t, model = models[arch]
    cfg = api_t.cfg
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T + 4))
    with _backend(jax_backend):
        lg_j, caches_j = api_j.prefill(params, {"tokens": jnp.asarray(tokens[:, :T])},
                                       seq_budget=T + 8)
        lg_t, caches_t = api_t.prefill(model, {"tokens": torch.from_numpy(tokens[:, :T])},
                                       seq_budget=T + 8)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=TOL, rtol=TOL,
                                   err_msg=f"{arch} prefill")
        for i in range(4):
            step = tokens[:, T + i:T + i + 1]
            lg_j, caches_j = api_j.decode(
                params, {"tokens": jnp.asarray(step, jnp.int32),
                         "cache_index": jnp.asarray(T + i, jnp.int32)}, caches_j)
            lg_t, caches_t = api_t.decode(
                model, {"tokens": torch.from_numpy(step), "cache_index": T + i}, caches_t)
            assert lg_t.dtype == torch.float32 and lg_t.shape == (B, cfg.vocab_size)
            np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=TOL,
                                       rtol=TOL, err_msg=f"{arch} step {i}")


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_jax(models, arch, jax_backend):
    """The total, the cross-entropy and the aux loss (the MoE layers'
    load-balance and z losses, summed over the blocks) of the reference's
    ``forward_train``."""
    api_j, params, api_t, model = models[arch]
    rng = np.random.default_rng(4)
    tokens, targets = (rng.integers(0, api_t.cfg.vocab_size, (B, 16)) for _ in range(2))
    with _backend(jax_backend):
        loss_j, met_j = api_j.train_loss(params, {"tokens": jnp.asarray(tokens),
                                                  "targets": jnp.asarray(targets)})
    loss_t, met_t = api_t.train_loss(model, {"tokens": torch.from_numpy(tokens),
                                             "targets": torch.from_numpy(targets)})
    assert float(met_t["aux_loss"]) > 0
    for got, want in ((loss_t, loss_j), (met_t["ce_loss"], met_j["ce_loss"]),
                      (met_t["aux_loss"], met_j["aux_loss"])):
        np.testing.assert_allclose(float(got), float(want), atol=LOSS_TOL, rtol=LOSS_TOL)


# prompts (default_rng(seed)) whose top-2 logit gap exceeds the logit
# tolerance at every step, asserted first: greedy tokens compare only
# where no step is a near-tie
GREEDY_SEEDS = {"llama4_maverick_400b_a17b": 5, "arctic_480b": 31}


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_through_both_generate_programs(models, arch):
    from repro.runtime.serve_loop import ServeConfig as JServeConfig
    from repro.runtime.serve_loop import make_generate_program as jprogram
    from repro_torch.runtime.serve_loop import ServeConfig, make_generate_program

    api_j, params, api_t, model = models[arch]
    prompts = np.random.default_rng(GREEDY_SEEDS[arch]).integers(
        0, api_t.cfg.vocab_size, (4, 16))
    new = 8
    lg, caches = api_t.prefill(model, {"tokens": torch.from_numpy(prompts)},
                               seq_budget=16 + new)
    gaps = []
    for i in range(new):
        top2 = torch.topk(lg, 2, dim=-1).values
        gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
        lg, caches = api_t.decode(model, {"tokens": lg.argmax(-1)[:, None],
                                          "cache_index": 16 + i}, caches)
    assert min(gaps) > TOL
    gen_j = jprogram(api_j, JServeConfig(max_new_tokens=new, prompt_len=16), params).fn(
        {"tokens": jnp.asarray(prompts)})["generated"]
    gen_t = make_generate_program(api_t, ServeConfig(max_new_tokens=new, prompt_len=16),
                                  model).fn({"tokens": torch.from_numpy(prompts)})["generated"]
    np.testing.assert_array_equal(gen_t.numpy(), np.asarray(gen_j))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_uses_every_leaf_and_keeps_the_router_fp32(arch):
    cfg_j, cfg_t = (c.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
                    for c in _cfgs(arch))
    params = jax.tree.map(np.asarray, jbuild(cfg_j).init(jax.random.PRNGKey(0)))
    model = params_from_jax(params, cfg_t, "cpu")
    i = next(i for i, s in enumerate(cfg_t.pattern) if s.mlp == "moe")
    ref = params["blocks"][f"b{i}"]["moe"]
    for r in range(cfg_t.n_repeats):
        moe = model.blocks[r * len(cfg_t.pattern) + i].moe
        assert moe.router.dtype == torch.float32
        assert ref["router"].dtype == np.float32
        np.testing.assert_array_equal(moe.router.numpy(), ref["router"][r])
        assert moe.experts.wi.dtype == torch.bfloat16
        np.testing.assert_array_equal(moe.experts.wg.float().numpy(),
                                      np.asarray(ref["experts"]["wg"][r], np.float32))
        np.testing.assert_array_equal(moe.residual.wo.float().numpy(),
                                      np.asarray(ref["residual"]["wo"][r], np.float32))
    # every leaf has its place, and a leaf the port has no place for raises
    extra = dict(params, stray={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="stray/w"):
        params_from_jax(extra, cfg_t, "cpu")
    short = jax.tree.map(lambda a: a, params)
    del short["blocks"][f"b{i}"]["moe"]["experts"]["wg"]
    with pytest.raises(ValueError, match="experts/wg"):
        params_from_jax(short, cfg_t, "cpu")


def test_stacked_experts_are_initialised_by_their_own_fan_in():
    """Each (d, ff) expert of a stack draws with std d^-0.5 (``wo``:
    ff^-0.5), not E^-0.5 (the stack's leading axis): the spread of the
    port's init equals the reference's within 5%, and is far from E's."""
    cfg_j, cfg_t = _cfgs("arctic_480b")
    cfg_j = cfg_j.replace(d_model=128, d_ff=256)
    cfg_t = cfg_t.replace(d_model=128, d_ff=256)
    layer = tmoe.MoE(cfg_t, torch.Generator().manual_seed(0))
    p = jmoe.init_moe(jax.random.PRNGKey(0), cfg_j)
    E, d, ff = cfg_t.moe.n_experts, cfg_t.d_model, cfg_t.d_ff
    for name, fan_in in (("wi", d), ("wg", d), ("wo", ff)):
        got = getattr(layer.experts, name).std().item()
        want = float(np.std(np.asarray(p["experts"][name])))
        assert abs(got / want - 1) < 0.05, (name, got, want)
        # a 2-std truncated normal keeps 0.88 of the std
        assert abs(got / (0.8796 * fan_in ** -0.5) - 1) < 0.05, name
        assert abs(got - 0.8796 * E ** -0.5) > 0.1
        for e in range(E):  # every expert drawn anew
            assert not torch.equal(getattr(layer.experts, name)[e],
                                   getattr(layer.experts, name)[(e + 1) % E])
    assert layer.router.dtype == torch.float32


def test_remat_is_carried_for_serving_and_trains_to_the_same_gradients(models):
    """Both MoE configs carry ``remat=True``: serving ignores it (the same
    logits), and training checkpoints each pattern repeat, with the loss,
    the aux loss and every gradient of ``remat=False`` bit for bit."""
    from repro_torch.runtime.train_loop import loss_and_grads

    _, _, _, model = models["arctic_480b"]
    cfg = model.cfg.replace(remat=True)
    api = tbuild(cfg)
    assert tcfgs.get("arctic_480b").remat and tcfgs.get("llama4_maverick_400b_a17b").remat
    carried = params_from_jax(
        jax.tree.map(np.asarray, jbuild(_cfgs("arctic_480b")[0]).init(
            jax.random.PRNGKey(0))), cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (B, T)))
    lg, _ = api.prefill(carried, {"tokens": tokens})
    ref, _ = tbuild(model.cfg).prefill(model, {"tokens": tokens})
    torch.testing.assert_close(lg, ref, atol=0, rtol=0)
    batch = {"tokens": tokens, "targets": tokens.roll(1, 1)}
    carried.requires_grad_(True)
    loss_r, met_r, grads_r = loss_and_grads(api, carried, batch)
    plain = params_from_jax(
        jax.tree.map(np.asarray, jbuild(_cfgs("arctic_480b")[0]).init(
            jax.random.PRNGKey(0))), model.cfg, "cpu")
    plain.requires_grad_(True)
    loss_p, met_p, grads_p = loss_and_grads(tbuild(model.cfg), plain, batch)
    assert torch.equal(loss_r, loss_p) and torch.equal(met_r["aux_loss"], met_p["aux_loss"])
    assert grads_r.keys() == grads_p.keys()
    for name, g in grads_p.items():
        assert torch.equal(grads_r[name], g), name


def test_hybrid_family_is_still_refused():
    """Since jamba's slice the hybrid family builds; a family outside the
    registry's ``FAMILIES`` is still refused."""
    from repro_torch.models.registry import FAMILIES

    cfg = tcfgs.reduced(tcfgs.get("arctic_480b"))
    assert "hybrid" in FAMILIES
    tbuild(cfg.replace(family="hybrid"))
    with pytest.raises(NotImplementedError, match="not ported"):
        tbuild(cfg.replace(family="diffusion"))


def test_serve_launcher_serves_llama4_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama4-maverick-400b-a17b", "--reduced", "--device", "cpu", "--requests", "4",
         "--services", "2"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "generated (4, 8) on cpu" in proc.stdout
