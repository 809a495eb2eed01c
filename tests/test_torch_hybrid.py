"""The port's hybrid family, jamba-1.5-large-398b, against the JAX package
at reduced size: a period of 8 blocks (attention at position 0, Mamba at
1-7; an MoE MLP at odd positions, dense at even ones), repeated twice,
with the reduced config's long-context window of 32.

Configs: jamba's, full and reduced, field for field the reference's;
``param_counts``, ``uses_attention``, ``uses_mamba`` and ``subquadratic``
equal to the reference's for every arch, and jamba's total and active
share in the reference suite's bounds.  The reduced model, from the JAX
package's ``api.init(PRNGKey(0))`` through ``params_from_jax``, inputs
from numpy seeds: prefill logits and 4 teacher-forced decode steps
within 2e-3 with the JAX side on its XLA backend and on its Pallas
kernels in interpret mode; ``train_loss`` within 2e-4; gradients against
``jax.grad`` at 1e-3 with ``remat`` off and on (remat's equal to no
remat's bit for bit); ``long_context=True`` (the window of 32) at a
48-token prompt and at decode steps past the window within 2e-3; the
reference's serve-consistency check (capacity 8.0, so that no routing
group drops) on the port; greedy tokens through both generate programs;
``block_skip=True`` changing no bit (whisper's loss too); the launchers
on the CPU; and no touched module importing JAX or the reference
package.
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
import repro_torch.configs as tcfgs
from repro import kernels as jkernels
from repro.models import build as jbuild
from repro_torch.interop import params_from_jax
from repro_torch.models import build as tbuild
from repro_torch.runtime.train_loop import loss_and_grads

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards, as in the other tight-tolerance port tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ARCH = "jamba_1p5_large_398b"
TOL, LOSS_TOL, GRAD_TOL = 2e-3, 2e-4, 1e-3
B, T = 2, 12


def _cfgs(**kw):
    cj, ct = jcfgs.reduced(jcfgs.get(ARCH)), tcfgs.reduced(tcfgs.get(ARCH))
    return cj.replace(**kw), ct.replace(**kw)


def _models(**kw):
    cfg_j, cfg_t = _cfgs(**kw)
    api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
    params = api_j.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    return api_j, params, api_t, model


@pytest.fixture(scope="module")
def models():
    return _models()


def _backend(name):
    return (jkernels.backend("pallas", interpret=True) if name == "pallas"
            else contextlib.nullcontext())


def _close(got, want, err_msg, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=err_msg)


# --------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_config_mirrors_the_reference(full):
    cj, ct = jcfgs.get(ARCH), tcfgs.get("jamba-1.5-large-398b")
    if not full:
        cj, ct = jcfgs.reduced(cj), tcfgs.reduced(ct)
    assert [f.name for f in dataclasses.fields(ct)] == [f.name for f in dataclasses.fields(cj)]
    for f in dataclasses.fields(ct):
        a, b = getattr(ct, f.name), getattr(cj, f.name)
        if f.name == "pattern":
            assert [(s.mixer, s.mlp, s.window) for s in a] == \
                   [(s.mixer, s.mlp, s.window) for s in b]
        elif f.name in ("moe", "ssm"):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert ct.long_context_window == (2048 if full else 32)
    assert [(s.mixer, s.mlp) for s in ct.pattern] == [
        ("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe")]


def test_every_reference_arch_is_ported():
    assert tcfgs.ARCH_IDS == jcfgs.ARCH_IDS
    assert tcfgs.canonical("jamba-1.5-large-398b") == ARCH


@pytest.mark.parametrize("arch", jcfgs.ARCH_IDS)
def test_counts_and_flags_equal_the_references(arch):
    for cj, ct in ((jcfgs.get(arch), tcfgs.get(arch)),
                   (jcfgs.reduced(jcfgs.get(arch)), tcfgs.reduced(tcfgs.get(arch)))):
        assert ct.param_counts() == cj.param_counts()
        assert (ct.uses_attention, ct.uses_mamba, ct.subquadratic) == \
            (cj.uses_attention, cj.uses_mamba, cj.subquadratic)


def test_jamba_param_counts_are_in_the_reference_suites_bounds():
    total, active = tcfgs.get(ARCH).param_counts()
    assert 360e9 < total < 440e9
    assert 0.15 < active / total < 0.35  # 16 experts, top-2
    cfg = tcfgs.get(ARCH)
    assert (cfg.uses_attention, cfg.uses_mamba, cfg.subquadratic) == (True, True, True)
    # the period the card serves: one repeat, experts cut 16 -> 8
    period = cfg.replace(n_layers=8, moe=dataclasses.replace(cfg.moe, n_experts=8))
    ref = jcfgs.get(ARCH)
    assert period.param_counts() == ref.replace(
        n_layers=8, moe=dataclasses.replace(ref.moe, n_experts=8)).param_counts()
    assert 25.9e9 < period.param_counts()[0] < 25.92e9


def test_reduced_model_counts_its_own_parameters(models):
    """``param_counts`` counts what the port's model holds, less what the
    reference's count leaves out: the norms' scales and the Mamba layers'
    conv and dt biases."""
    _, _, api_t, model = models
    left_out = sum(p.numel() for n, p in model.named_parameters()
                   if "norm" in n or n.endswith(("mamba.conv_b", "mamba.dt_proj_b")))
    assert left_out > 0
    assert sum(p.numel() for p in model.parameters()) - left_out == \
        api_t.cfg.param_counts()[0]


# --------------------------------------------------------------------- #
# the model against the reference
# --------------------------------------------------------------------- #
def _prefill_and_decode(api_j, params, api_t, model, tokens, prompt, budget, *,
                        long_context=False, steps=4):
    """Prefill ``prompt`` tokens and ``steps`` teacher-forced decode steps
    in both packages; the logits of each held within TOL."""
    kw = {"long_context": True} if long_context else {}
    lg_j, caches_j = api_j.prefill(params, {"tokens": jnp.asarray(tokens[:, :prompt])},
                                   seq_budget=budget, **kw)
    lg_t, caches_t = api_t.prefill(model, {"tokens": torch.from_numpy(tokens[:, :prompt])},
                                   seq_budget=budget, **kw)
    _close(lg_t, lg_j, "prefill")
    for i in range(steps):
        step = tokens[:, prompt + i:prompt + i + 1]
        lg_j, caches_j = api_j.decode(
            params, {"tokens": jnp.asarray(step, jnp.int32),
                     "cache_index": jnp.asarray(prompt + i, jnp.int32)}, caches_j, **kw)
        lg_t, caches_t = api_t.decode(
            model, {"tokens": torch.from_numpy(step), "cache_index": prompt + i},
            caches_t, **kw)
        assert lg_t.dtype == torch.float32 and lg_t.shape == (tokens.shape[0],
                                                              api_t.cfg.vocab_size)
        _close(lg_t, lg_j, f"step {i}")
    return lg_t


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_prefill_and_decode_logits_match_jax(models, jax_backend):
    api_j, params, api_t, model = models
    tokens = np.random.default_rng(3).integers(0, api_t.cfg.vocab_size, (B, T + 4))
    with _backend(jax_backend):
        _prefill_and_decode(api_j, params, api_t, model, tokens, T, T + 8)


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_train_loss_matches_jax(models, jax_backend):
    """The total, the cross-entropy and the aux loss (the four MoE
    layers' load-balance and z losses a repeat)."""
    api_j, params, api_t, model = models
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


def _train_batch(cfg):
    rng = np.random.default_rng(7)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, 16)),
            "targets": rng.integers(0, cfg.vocab_size, (B, 16))}


def _port_grads(remat, **kw):
    """The port's loss, metrics and gradients of ``_train_batch``; with
    ``kw`` (``block_skip``) through ``train_loss`` itself, which takes it."""
    api_j, params, api_t, model = _models(remat=remat)
    model.requires_grad_(True)
    batch = _train_batch(api_t.cfg)
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    if not kw:
        loss, metrics, grads = loss_and_grads(api_t, model, batch_t)
    else:
        named = dict(model.named_parameters())
        loss, metrics = api_t.train_loss(model, batch_t, **kw)
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    return api_j, params, api_t, batch, loss, metrics, grads


@pytest.mark.parametrize("remat", [False, True])
def test_train_grads_match_jax(remat):
    """Every parameter's gradient against ``jax.grad`` of the reference's
    ``train_loss`` (remat there: ``jax.checkpoint`` of its scan body),
    mapped onto the port's parameters by ``params_from_jax``."""
    api_j, params, api_t, batch, loss_t, metrics, grads_t = _port_grads(remat)
    assert api_j.cfg.remat == api_t.cfg.remat == remat
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: api_j.train_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=LOSS_TOL, rtol=LOSS_TOL)
    assert float(metrics["aux_loss"]) > 0
    ref = dict(params_from_jax(jax.tree.map(np.asarray, grads_j), api_t.cfg,
                               "cpu").named_parameters())
    assert ref.keys() == grads_t.keys()
    kinds = {kind: 0 for kind in ("attn", "mamba", "mlp", "moe")}
    for name, g in grads_t.items():
        assert g.shape == ref[name].shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), ref[name].detach().numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)
        for kind in kinds:
            kinds[kind] += f".{kind}." in name
    assert all(kinds.values()), kinds  # every kind of block was held


def test_remat_and_block_skip_change_no_bit():
    """``remat=True`` (each pattern repeat checkpointed) gives
    ``remat=False``'s loss and gradients bit for bit, and so does
    ``block_skip=True``, which the port accepts and discards, as the
    reference's attention dispatch ignores it."""
    *_, loss, met, grads = _port_grads(False)
    for remat, kw in ((True, {}), (False, {"block_skip": True}), (True, {"block_skip": True})):
        *_, loss_o, met_o, grads_o = _port_grads(remat, **kw)
        assert torch.equal(loss_o, loss) and torch.equal(met_o["aux_loss"], met["aux_loss"])
        assert grads_o.keys() == grads.keys()
        for name, g in grads.items():
            assert torch.equal(grads_o[name], g), (remat, kw, name)


def test_train_step_takes_block_skip():
    from repro_torch.runtime.train_loop import TrainConfig, make_train_state, make_train_step

    _, _, api_t, model = _models()
    tc = TrainConfig(total_steps=2, warmup_steps=1)
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(api_t.cfg).items()}
    losses = []
    for skip in (False, True):
        fresh = params_from_jax(jax.tree.map(np.asarray, jbuild(_cfgs()[0]).init(
            jax.random.PRNGKey(0))), api_t.cfg, "cpu")
        state = make_train_state(api_t, tc, params=fresh)
        _, metrics = make_train_step(api_t, tc, block_skip=skip)(state, batch)
        losses.append(metrics["loss"])
    assert torch.equal(losses[0], losses[1])


def test_encdec_train_loss_discards_the_lm_keywords():
    """Whisper's ``train_loss`` accepts ``long_context`` and ``block_skip``,
    as the reference's encoder-decoder takes ``**_``, and its loss is
    unchanged bit for bit."""
    api = tbuild(tcfgs.reduced(tcfgs.get("whisper_tiny")))
    model = api.init(torch.Generator().manual_seed(0))
    cfg, g = api.cfg, np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(g.integers(0, cfg.vocab_size, (B, T))),
             "targets": torch.from_numpy(g.integers(0, cfg.vocab_size, (B, T))),
             "enc_frames": torch.from_numpy(g.standard_normal(
                 (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))}
    with torch.no_grad():
        loss, _ = api.train_loss(model, batch)
        for kw in ({"block_skip": True}, {"long_context": True},
                   {"block_skip": True, "long_context": True}):
            assert torch.equal(api.train_loss(model, batch, **kw)[0], loss), kw


# --------------------------------------------------------------------- #
# long context: the window
# --------------------------------------------------------------------- #
def test_window_applies_to_attention_blocks_only_at_long_context():
    from repro_torch.models.blocks import _window_for
    from repro_torch.models.common import BlockSpec

    _, cfg = _cfgs()
    attn, mamba = cfg.pattern[0], cfg.pattern[1]
    assert _window_for(cfg, attn, False) is None
    assert _window_for(cfg, attn, True) == 32
    assert _window_for(cfg, mamba, True) is None
    assert _window_for(cfg, BlockSpec(window=5), False) == 5  # a block's own wins
    assert _window_for(cfg, BlockSpec(window=5), True) == 5
    assert _window_for(cfg.replace(long_context_window=None), attn, True) is None


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_long_context_prefill_and_decode_past_the_window_match_jax(models, jax_backend):
    """A 48-token prompt (the window is 32) and 4 decode steps at 48..51,
    all with ``long_context=True``: the attention blocks see only the
    last 32 positions, as in the reference (whose Pallas branch also
    sends windowed calls to its chunked path)."""
    api_j, params, api_t, model = models
    S = 48
    tokens = np.random.default_rng(8).integers(0, api_t.cfg.vocab_size, (B, S + 4))
    with _backend(jax_backend):
        lg = _prefill_and_decode(api_j, params, api_t, model, tokens, S, S + 8,
                                 long_context=True)
    # the window bites: without it the last logits differ
    full = _prefill_and_decode(api_j, params, api_t, model, tokens, S, S + 8)
    assert float((lg - full).abs().max()) > 10 * TOL


@pytest.mark.parametrize("S,window", [(37, 8), (41, None), (53, 20)])
def test_chunked_attention_takes_a_ragged_last_chunk(S, window):
    """The plain windowed path at a length its chunk sizes do not divide
    (a prime: the reference's chunks shrink to its largest divisor, 1):
    within the fp32 attention tolerance of the reference's, the port
    stepping in whole chunks and one ragged last."""
    from repro.models.attention import chunked_attention as jchunked
    from repro_torch.models.attention import chunked_attention

    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal(s, np.float32)
               for s in ((2, S, 4, 16), (2, S, 2, 16), (2, S, 2, 16)))
    ref = jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                   window=window, q_chunk=8, kv_chunk=16)
    got = chunked_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                            window=window, q_chunk=8, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_long_context_within_the_window_changes_nothing(models):
    _, _, api_t, model = models
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, api_t.cfg.vocab_size, (B, 32)))
    lg, _ = api_t.prefill(model, {"tokens": tokens})
    lg_lc, _ = api_t.prefill(model, {"tokens": tokens}, long_context=True)
    torch.testing.assert_close(lg_lc, lg, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("long_context", [False, True])
def test_decode_matches_incremental_prefill(long_context):
    """The reference's serve-consistency check of jamba
    (``tests/test_serve_consistency.py``: capacity 8.0, so that no
    routing group drops a token) on the port: prefill then one token at a
    time equals prefilling the longer prefix; at long context too, with
    the prompt past the window."""
    _, ct = _cfgs()
    _, _, api, model = _models(moe=dataclasses.replace(ct.moe, capacity_factor=8.0))
    T0 = 40 if long_context else T
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, api.cfg.vocab_size, (B, T0 + 4)))
    kw = {"long_context": long_context}
    ref = [api.prefill(model, {"tokens": tokens[:, :t + 1]}, seq_budget=T0 + 8, **kw)[0]
           for t in range(T0, T0 + 4)]
    _, caches = api.prefill(model, {"tokens": tokens[:, :T0]}, seq_budget=T0 + 8, **kw)
    for i in range(4):
        lg, caches = api.decode(model, {"tokens": tokens[:, T0 + i:T0 + i + 1],
                                        "cache_index": T0 + i}, caches, **kw)
        torch.testing.assert_close(lg, ref[i], atol=TOL, rtol=TOL)


# prompts (default_rng(GREEDY_SEED), 4 x 16 tokens, 8 new tokens) whose
# top-2 logit gap exceeds the logit tolerance at every step, asserted
# first: greedy tokens compare only where no step is a near-tie
GREEDY_SEED = 0


def test_greedy_tokens_through_both_generate_programs(models):
    from repro.runtime.serve_loop import ServeConfig as JServeConfig
    from repro.runtime.serve_loop import make_generate_program as jprogram
    from repro_torch.runtime.serve_loop import ServeConfig, make_generate_program

    api_j, params, api_t, model = models
    prompts = np.random.default_rng(GREEDY_SEED).integers(0, api_t.cfg.vocab_size, (4, 16))
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
    gen_j = jprogram(api_j, JServeConfig(max_new_tokens=new, prompt_len=16, greedy=True),
                     params).fn({"tokens": jnp.asarray(prompts)})["generated"]
    gen_t = make_generate_program(api_t, ServeConfig(max_new_tokens=new, prompt_len=16,
                                                     greedy=True),
                                  model).fn({"tokens": torch.from_numpy(prompts)})["generated"]
    np.testing.assert_array_equal(gen_t.numpy(), np.asarray(gen_j))


def test_params_from_jax_maps_every_kind_of_block():
    """bf16 weights: each pattern position's leaves under ``blocks/b{i}``,
    the Mamba layers' ``A_log`` and ``D`` and the routers fp32, every leaf
    used."""
    cfg_j, cfg_t = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16")
    params = jax.tree.map(np.asarray, jbuild(cfg_j).init(jax.random.PRNGKey(0)))
    model = params_from_jax(params, cfg_t, "cpu")
    n = len(cfg_t.pattern)
    for r in range(cfg_t.n_repeats):
        for i, spec in enumerate(cfg_t.pattern):
            blk, ref = model.blocks[r * n + i], params["blocks"][f"b{i}"]
            if spec.mixer == "attn":
                np.testing.assert_array_equal(blk.attn.wq.float().numpy(),
                                              np.asarray(ref["attn"]["wq"][r], np.float32))
            else:
                assert blk.mamba.A_log.dtype == blk.mamba.D.dtype == torch.float32
                np.testing.assert_array_equal(blk.mamba.A_log.numpy(),
                                              ref["mamba"]["A_log"][r])
            if spec.mlp == "moe":
                assert blk.moe.router.dtype == torch.float32
                np.testing.assert_array_equal(blk.moe.router.numpy(), ref["moe"]["router"][r])
            else:
                np.testing.assert_array_equal(blk.mlp.wo.float().numpy(),
                                              np.asarray(ref["mlp"]["wo"][r], np.float32))


# --------------------------------------------------------------------- #
# launchers, imports
# --------------------------------------------------------------------- #
def _launch(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", module, "--arch", "jamba-1.5-large-398b",
                           "--reduced", "--device", "cpu", *args],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_serve_launcher_serves_jamba_on_the_cpu():
    out = _launch("repro_torch.launch.serve", "--requests", "4", "--services", "2")
    assert "generated (4, 8) on cpu" in out


def test_train_launcher_trains_jamba_on_the_cpu():
    out = _launch("repro_torch.launch.train", "--steps", "2", "--batch", "2",
                  "--seq-len", "16")
    assert "jamba-1.5-large-398b (16 layers) on cpu: final loss" in out


# the modules this slice adds or changes
TOUCHED = ["repro_torch.configs", "repro_torch.configs.jamba_1p5_large_398b",
           "repro_torch.models.common", "repro_torch.models.blocks", "repro_torch.models.lm",
           "repro_torch.models.encdec", "repro_torch.models.attention",
           "repro_torch.models.registry", "repro_torch.kernels",
           "repro_torch.runtime.train_loop", "repro_torch.runtime.serve_loop",
           "repro_torch.interop", "repro_torch.launch.serve", "repro_torch.launch.train"]


def test_touched_modules_import_neither_jax_nor_repro():
    code = ("import importlib, sys\n"
            f"for name in {TOUCHED!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
