"""The port's training path against the JAX package on the CPU: the
chunked cross-entropy, AdamW and its schedules, the datasets, the
checkpointer, reduced models' loss and gradients, the ``Trainer``, farm-
mode local SGD and the training launcher.

Inputs are drawn with numpy or converted from the JAX package's
``api.init(PRNGKey(0))`` parameters through ``params_from_jax``.
Tolerances are the reference suites' own: loss values 1e-5 and grads
1e-6 (``tests/test_loss.py``), AdamW 1e-5 / 1e-6 (``tests/test_optim.py``),
model loss 2e-4 and parameter grads 1e-3 (``tests/test_pallas_backend.py``);
trainer and local-SGD losses 1e-3.
"""

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
from repro.checkpoint import save as jsave
from repro.data import make_dataset as jmake_dataset
from repro.models import build as jbuild
from repro.models.loss import fused_cross_entropy as jce
from repro.models.loss import token_nll as jnll
from repro.optim import adamw_update as jadamw
from repro.optim import init_opt_state as jinit_opt
from repro.optim import schedules as jsched
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import Trainer as JTrainer
from repro.runtime.local_sgd import LocalSGDConfig as JLocalSGDConfig
from repro.runtime.local_sgd import _synthetic_batch
from repro.runtime.local_sgd import make_local_round_program as jround
from repro.runtime.train_loop import make_train_state as jmake_state
from repro_torch.checkpoint import (AsyncCheckpointer, Checkpointer,
                                    latest_step, restore, save)
from repro_torch.core import LookupService, Service
from repro_torch.data import MarkovDataset, ShardedLoader, make_dataset
from repro_torch.interop import params_from_jax
from repro_torch.models import build as tbuild
from repro_torch.models.loss import fused_cross_entropy, token_nll
from repro_torch.optim import adamw, adamw_update, init_opt_state, schedules
from repro_torch.runtime.local_sgd import (LocalSGDConfig, LocalSGDTrainer,
                                           make_local_round_program,
                                           markov_batch)
from repro_torch.runtime.train_loop import (TrainConfig, Trainer,
                                            loss_and_grads, make_train_state)


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards (set per test, not at import: every xdist worker imports
    every test file).  On the CPUs these tests run on, torch's second
    thread has been seen under load to compute exp on its half of a
    tensor with errors far above an ulp, which breaks the tight
    tolerances here at random; with one thread it has not."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3_1p7b", "llama3p2_1b"]


def _models(arch):
    cfg_j = jcfgs.reduced(jcfgs.get(arch))
    cfg_t = tcfgs.reduced(tcfgs.get(arch))
    api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
    params = api_j.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    return api_j, params, api_t, model


def _jax_paths(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(leaf, np.float32)
            for path, leaf in flat}


def _stacked_like_jax(named: dict, cfg) -> dict:
    """The port's per-layer tensors stacked along the reference's repeats
    axis: layer r * len(pattern) + i is ``blocks/b{i}/...[r]``."""
    groups: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            r, i = divmod(int(parts[1]), len(cfg.pattern))
            key = "/".join(("blocks", f"b{i}") + tuple(parts[2:]))
            groups.setdefault(key, {})[r] = t.detach().float().numpy()
        else:
            groups["/".join(parts)] = t.detach().float().numpy()
    return {k: np.stack([v[r] for r in sorted(v)]) if isinstance(v, dict) else v
            for k, v in groups.items()}


# --------------------------------------------------------------------- #
# loss
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("B,S,d,V,chunk", [(2, 24, 16, 50, 8), (1, 64, 32, 97, 1000),
                                           (3, 8, 16, 11, 16)])
def test_token_nll_matches_reference(B, S, d, V, chunk):
    rng = np.random.default_rng(B * S + V)
    x = rng.standard_normal((B, S, d), np.float32)
    table = (rng.standard_normal((V, d)) * 0.2).astype(np.float32)
    t = rng.integers(0, V, (B, S)).astype(np.int32)
    ref = jnll(jnp.asarray(x), jnp.asarray(table), jnp.asarray(t), chunk)
    got = token_nll(torch.from_numpy(x), torch.from_numpy(table),
                    torch.from_numpy(t), chunk)
    assert got.dtype == torch.float32 and got.shape == (B, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_cross_entropy_grads_match_reference(masked):
    rng = np.random.default_rng(7)
    B, S, d, V = 2, 32, 16, 53
    x = rng.standard_normal((B, S, d), np.float32)
    table = (rng.standard_normal((V, d)) * 0.2).astype(np.float32)
    t = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = rng.random((B, S)) > 0.5 if masked else None
    loss_j, grads_j = jax.value_and_grad(
        lambda x_, w_: jce(x_, w_, jnp.asarray(t),
                           None if mask is None else jnp.asarray(mask), chunk=8),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(table))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(table).requires_grad_()
    loss = fused_cross_entropy(xt, wt, torch.from_numpy(t),
                               None if mask is None else torch.from_numpy(mask),
                               chunk=8)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=1e-5, rtol=1e-5)
    for a, b in zip((xt.grad, wt.grad), grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-5)


def test_bf16_inputs_give_fp32_loss_and_bf16_grads():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 16, 32), np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((40, 32), np.float32) * 0.2).bfloat16()
    x.requires_grad_()
    w.requires_grad_()
    loss = fused_cross_entropy(x, w, torch.from_numpy(rng.integers(0, 40, (2, 16))))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    loss.backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.bfloat16


# --------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_reference(dtype, master):
    """Four clipped steps on the same arrays, each moment dtype."""
    rng = np.random.default_rng(0)
    P = {"w": rng.standard_normal((8, 300)).astype(np.float32),
         "b": rng.standard_normal((16,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in P.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in P.items()}
    js = jinit_opt(jp, moment_dtype=dtype, master_fp32=master)
    ts = init_opt_state(tp, moment_dtype=dtype, master_fp32=master)
    for _ in range(4):
        G = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in P.items()}
        jp, js, jm = jadamw({k: jnp.asarray(v) for k, v in G.items()}, js, jp,
                            lr=1e-2, moment_dtype=dtype, clip_norm=1.0)
        # copies: the port clips its gradients in place, and JAX may still
        # be reading the numpy buffers it was given (dispatch is asynchronous)
        _, ts, tm = adamw_update({k: torch.from_numpy(v.copy()) for k, v in G.items()},
                                 ts, tp, lr=1e-2, moment_dtype=dtype, clip_norm=1.0)
    assert int(ts["step"]) == int(js["step"]) == 4
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-5)
    for k in P:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    if dtype == "int8":
        assert ts["m"]["w"]["codes"].dtype == torch.int8
        assert tuple(ts["m"]["w"]["codes"].shape) == (8, 512)
    else:
        assert ts["v"]["w"].dtype == getattr(torch, dtype)


def _whole_tensor_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                         weight_decay=0.1, moment_dtype="float32"):
    """The unclipped AdamW update one whole tensor at a time, as the port
    wrote it before its update went slice by slice: the reference for the
    sliced one's bit-identity."""
    step = state["step"] + 1
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), step.float())
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), step.float())
    lr = torch.as_tensor(lr, dtype=torch.float32)
    masters = state.get("master", params)
    for k, p in params.items():
        g32 = grads[k].float()
        m32 = adamw._read_moment(state["m"][k], p, moment_dtype)
        v32 = adamw._read_moment(state["v"][k], p, moment_dtype, log_domain=True)
        m32 = b1 * m32 + (1 - b1) * g32
        v32 = b2 * v32 + (1 - b2) * g32 * g32
        new = masters[k].float() - lr * (m32 / c1 / (torch.sqrt(v32 / c2) + eps)
                                         + weight_decay * masters[k].float())
        if "master" in state:
            state["master"][k] = new
        p.copy_(new)
        state["m"][k] = adamw._write_moment(m32, moment_dtype)
        state["v"][k] = adamw._write_moment(v32, moment_dtype, log_domain=True)
    state["step"] = step


def _stacked_params(pdtype, seed):
    """An expert stack (6, 16, 40), a table (50, 24), a (2, 800) tensor
    whose one row exceeds a 700-element slice and a 1-D (1000,)."""
    rng = np.random.default_rng(seed)
    shapes = {"experts.wi": (6, 16, 40), "embed.table": (50, 24), "wide": (2, 800),
              "bias": (1000,)}
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(pdtype)
            for k, s in shapes.items()}


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_sliced_adamw_update_equals_the_whole_tensor_one(dtype, master, monkeypatch):
    """Three unclipped steps through slices of at most 700 elements equal
    the whole-tensor update bit for bit: parameters, moments (int8 codes,
    scales and offsets) and fp32 masters."""
    monkeypatch.setattr(adamw, "SLICE", 700)
    pdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    P = _stacked_params(pdtype, 0)
    assert [len(adamw._slices(t)) for t in P.values()] == [6, 2, 2, 1]
    sliced = {k: t.clone() for k, t in P.items()}
    whole = {k: t.clone() for k, t in P.items()}
    s_state = init_opt_state(sliced, moment_dtype=dtype, master_fp32=master)
    w_state = init_opt_state(whole, moment_dtype=dtype, master_fp32=master)
    for i in range(3):
        G = _stacked_params(pdtype, i + 1)
        adamw_update({k: g.clone() for k, g in G.items()}, s_state, sliced, lr=1e-2,
                     moment_dtype=dtype, clip_norm=None)
        _whole_tensor_update(G, w_state, whole, lr=1e-2, moment_dtype=dtype)
    for k in P:
        assert torch.equal(sliced[k], whole[k]), k
        for mom in ("m", "v"):
            a, b = s_state[mom][k], w_state[mom][k]
            for part in (("codes", "scale", "offset") if dtype == "int8" else (None,)):
                assert torch.equal(a if part is None else a[part],
                                   b if part is None else b[part]), (k, mom, part)
        if master:
            assert torch.equal(s_state["master"][k], w_state["master"][k]), k
    assert int(s_state["step"]) == 3


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
def test_in_place_clip_equals_the_copying_clip(pdtype, sliced, monkeypatch):
    """The clip scales the caller's tensors in place (the same objects come
    back) and gives the copying clip's values bit for bit at the same norm.
    The norm sums squares a slice at a time: unsliced it is the per-tensor
    sum's bit for bit, sliced it moves by summation order only, within
    1e-6 relative (fp32 sums of a few thousand squares)."""
    if sliced:
        monkeypatch.setattr(adamw, "SLICE", 700)
    G = {k: g * 0.5 for k, g in _stacked_params(pdtype, 4).items()}
    norm_before = torch.sqrt(torch.stack([torch.sum(torch.square(g.float()))
                                          for g in G.values()]).sum())
    copies = {k: g.clone() for k, g in G.items()}
    clipped, norm = adamw.clip_by_global_norm(G, 1.0)
    if not sliced:
        assert torch.equal(norm, norm_before)
    else:
        torch.testing.assert_close(norm, norm_before, rtol=1e-6, atol=0)
    factor = torch.clamp(1.0 / torch.clamp(norm, min=1e-9), max=1.0)
    assert float(factor) < 1.0
    for k, g in copies.items():
        assert clipped[k] is G[k], k
        assert torch.equal(clipped[k], (g.float() * factor).to(g.dtype)), k


def test_clip_scales_a_shared_gradient_once_and_copies_a_broadcast_one():
    """autograd hands one tensor to both leaves of ``a + b`` and a stride-0
    view to a leaf read through ``sum``: the first is scaled once, the
    second (which cannot be written) replaced by a scaled copy."""
    a = torch.randn(4, requires_grad=True, generator=torch.Generator().manual_seed(0))
    b = torch.randn(4, requires_grad=True, generator=torch.Generator().manual_seed(1))
    c = torch.randn(4, requires_grad=True, generator=torch.Generator().manual_seed(2))
    ga, gb, gc = torch.autograd.grad(((a + b) * 3).square().sum() + c.sum(), (a, b, c))
    assert ga is gb and gc.stride() == (0,)
    want = {k: g.clone() for k, g in zip("abc", (ga, gb, gc))}
    out, norm = adamw.clip_by_global_norm({"a": ga, "b": gb, "c": gc}, 1.0)
    factor = 1.0 / norm
    for k in "abc":
        torch.testing.assert_close(out[k], want[k] * factor, rtol=1e-6, atol=0)
    assert out["a"] is ga and out["b"] is ga and out["c"] is not gc


@pytest.mark.parametrize("name", ["cosine", "wsd", "constant"])
def test_schedules_match_reference(name):
    kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100, stable_steps=40,
              decay_steps=20)
    if name == "cosine":
        kw = {k: kw[k] for k in ("peak_lr", "warmup_steps", "total_steps")}
    elif name == "wsd":
        kw.pop("total_steps")
    for step in (0, 3, 10, 33, 50, 61, 70, 99, 100, 150):
        ref = float(jsched.SCHEDULES[name](step, **kw))
        got = schedules.SCHEDULES[name](step, **kw)
        assert got.dtype == torch.float32
        assert got.item() == pytest.approx(ref, rel=1e-6, abs=1e-7), step


# --------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["random", "markov"])
def test_dataset_batches_are_bit_identical_to_reference(kind):
    ours = make_dataset(kind, 97, 24, 3, seed=5)
    ref = jmake_dataset(kind, 97, 24, 3, seed=5)
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_loader_prefetches_in_order_onto_the_device():
    ds = MarkovDataset(64, 8, 2, seed=0)
    loader = ShardedLoader(ds, device="cpu", prefetch=2, start_step=3)
    it = iter(loader)
    got = [next(it) for _ in range(3)]
    loader.stop()
    assert [s for s, _ in got] == [3, 4, 5]
    assert isinstance(got[0][1]["tokens"], torch.Tensor)
    np.testing.assert_array_equal(got[1][1]["targets"].numpy(),
                                  ds.batch_at(4)["targets"])


# --------------------------------------------------------------------- #
# checkpointer
# --------------------------------------------------------------------- #
def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 4, generator=g),
                       "emb": torch.randn(16, 4, generator=g).bfloat16()},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "codes": torch.arange(-8, 8, dtype=torch.int8)}}


def _zeros_like(tree):
    return {k: {kk: torch.zeros_like(v) for kk, v in d.items()}
            for k, d in tree.items()}


def test_checkpoint_roundtrip_preserves_values_and_dtypes(tmp_path):
    tree = _tree(0)
    save(str(tmp_path), 3, tree)
    assert latest_step(str(tmp_path)) == 3
    out = restore(str(tmp_path), 3, _zeros_like(tree))
    for k in tree:
        for kk in tree[k]:
            assert out[k][kk].dtype == tree[k][kk].dtype
            assert torch.equal(out[k][kk], tree[k][kk])


def test_checkpoint_layout_is_the_reference_layout(tmp_path):
    """A checkpoint the reference wrote restores into the port's state
    (same ``arrays.npz`` + ``meta.json``, bf16 as uint16)."""
    tree = _tree(1)
    jtree = {k: {kk: jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else v.numpy().dtype)
        for kk, v in d.items()} for k, d in tree.items()}
    jsave(str(tmp_path), 2, jtree)
    out = restore(str(tmp_path), 2, _zeros_like(tree))
    for k in tree:
        for kk in tree[k]:
            assert torch.equal(out[k][kk], tree[k][kk])


def test_checkpoint_gc_keeps_last_k(tmp_path):
    for s in range(6):
        save(str(tmp_path), s, {"x": torch.zeros(3)}, keep=2)
    assert sorted(int(d[5:]) for d in os.listdir(tmp_path)) == [4, 5]


def test_no_partial_checkpoint_visible(tmp_path):
    save(str(tmp_path), 1, {"x": torch.zeros(3)})
    os.makedirs(os.path.join(tmp_path, "step_00000009.tmp"))
    assert latest_step(str(tmp_path)) == 1


def test_async_checkpointer_and_restore_latest(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    tree = _tree(2)
    ck.save(5, tree)
    ck.wait()
    step, out = ck.restore_latest(_zeros_like(tree))
    assert step == 5
    assert torch.equal(out["params"]["w"], tree["params"]["w"])
    with pytest.raises(ValueError, match="checkpoint holds"):
        restore(str(tmp_path), 5, {"params": {"w": torch.zeros(4, 8),
                                              "emb": tree["params"]["emb"]},
                                   "opt": tree["opt"]})


def test_async_snapshot_is_taken_before_save_returns(tmp_path):
    """A CPU bf16 tensor written in place (as AdamW writes weights and
    moments) after ``save`` returns leaves the checkpoint as it was."""
    ck = AsyncCheckpointer(str(tmp_path))
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4).to(torch.bfloat16),
            "m": torch.ones(5)}
    want = {k: t.clone() for k, t in tree.items()}
    ck.save(1, tree)
    for t in tree.values():
        t.mul_(3)
    ck.wait()
    _, out = ck.restore_latest({k: torch.zeros_like(t) for k, t in tree.items()})
    for k, t in want.items():
        assert torch.equal(out[k], t), k


def test_trainer_restart_bitwise(tmp_path):
    cfg = tcfgs.reduced(tcfgs.get("llama3p2_1b"))
    api = tbuild(cfg)
    tc = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    ds = make_dataset("markov", cfg.vocab_size, 16, 4, seed=0)

    t1 = Trainer(api, tc, ds, checkpointer=Checkpointer(str(tmp_path / "a")),
                 ckpt_every=4, device="cpu")
    t1.run(8)
    t1.run(4)  # uninterrupted continuation
    ck2 = Checkpointer(str(tmp_path / "b"))
    t2 = Trainer(api, tc, ds, checkpointer=ck2, ckpt_every=4, device="cpu")
    t2.run(8)
    with pytest.raises(KeyboardInterrupt):
        t2.run(4, preempt_at=9)
    t3 = Trainer(api, tc, ds, checkpointer=ck2, ckpt_every=4, device="cpu")
    assert t3.start_step == 8
    t3.run(4)
    for (name, a), b in zip(t1.state["params"].named_parameters(),
                            t3.state["params"].parameters()):
        assert torch.equal(a, b), name
    assert torch.equal(t1.state["opt"]["v"]["embed.table"],
                       t3.state["opt"]["v"]["embed.table"])


# --------------------------------------------------------------------- #
# models, trainer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    api_j, params, api_t, model = _models(arch)
    cfg = api_t.cfg
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    (loss_j, met_j), grads_j = jax.value_and_grad(
        lambda p: api_j.train_loss(p, {"tokens": jnp.asarray(tokens),
                                       "targets": jnp.asarray(targets)}),
        has_aux=True)(params)
    model.requires_grad_(True)
    loss_t, met_t = api_t.train_loss(model, {"tokens": torch.from_numpy(tokens),
                                             "targets": torch.from_numpy(targets)})
    named = dict(model.named_parameters())
    grads_t = dict(zip(named, torch.autograd.grad(loss_t, list(named.values()))))
    assert abs(loss_t.item() - float(loss_j)) <= 2e-4
    assert abs(met_t["ce_loss"].item() - float(met_j["ce_loss"])) <= 2e-4
    assert met_t["aux_loss"].item() == 0.0
    ours, ref = _stacked_like_jax(grads_t, cfg), _jax_paths(grads_j)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-3, rtol=1e-3,
                                   err_msg=k)


def test_train_mode_switches_still_work():
    """``forward_train`` does not shadow ``nn.Module.train``: eval() and
    train() walk the model, and the loss is unchanged by them."""
    _, _, api, model = _models("qwen3_1p7b")
    tok = torch.from_numpy(np.random.default_rng(5).integers(0, 512, (1, 8)))
    loss, _ = api.train_loss(model, {"tokens": tok, "targets": tok})
    model.eval()
    assert not model.blocks[0].training
    model.train()
    assert model.blocks[0].attn.training
    again, _ = api.train_loss(model, {"tokens": tok, "targets": tok})
    assert torch.equal(loss, again)


def test_remat_runs_each_repeat_again_and_keeps_the_gradients(monkeypatch):
    """``remat=True``: the flash forward runs twice an attention layer a
    step (the checkpointed repeat's recompute in the backward), its
    backward once, and loss and gradients equal ``remat=False``'s bit for
    bit; without grad nothing is recomputed."""
    import repro_torch.kernels.flash_attention.ops as flash_ops

    cfg = tcfgs.reduced(tcfgs.get("qwen3_1p7b"))
    assert cfg.remat is False and cfg.opt_state_dtype == "float32"
    model = tbuild(cfg).init(torch.Generator().manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(5).integers(0, 512, (2, 12)))
    calls = {"fwd": 0, "bwd": 0}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(flash_ops, "flash_attention_fwd",
                        counted("fwd", flash_ops.flash_attention_fwd))
    monkeypatch.setattr(flash_ops, "flash_attention_bwd",
                        counted("bwd", flash_ops.flash_attention_bwd))
    runs = {}
    for remat in (False, True):
        api = tbuild(cfg.replace(remat=remat))
        m = api.init(torch.Generator().manual_seed(1))
        m.load_state_dict(model.state_dict())
        m.requires_grad_(True)
        calls.update(fwd=0, bwd=0)
        loss, _, grads = loss_and_grads(api, m, {"tokens": tok, "targets": tok})
        runs[remat] = (loss, grads, dict(calls))
    assert runs[False][2] == {"fwd": cfg.n_layers, "bwd": cfg.n_layers}
    assert runs[True][2] == {"fwd": 2 * cfg.n_layers, "bwd": cfg.n_layers}
    assert torch.equal(runs[True][0], runs[False][0])
    for name, g in runs[False][1].items():
        assert torch.equal(runs[True][1][name], g), name
    calls.update(fwd=0, bwd=0)
    with torch.no_grad():
        api.train_loss(m, {"tokens": tok, "targets": tok})
    assert calls == {"fwd": cfg.n_layers, "bwd": 0}


def test_trainer_losses_match_reference():
    """Three steps of each package's Trainer from the same converted
    weights on the same batches.  Parameters are not compared element by
    element: AdamW's first step moves each weight by about lr * sign(g),
    and a near-zero gradient can take either sign in the two packages."""
    api_j, params, api_t, model = _models("qwen3_1p7b")
    cfg = api_t.cfg
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstate = jmake_state(api_j, JTrainConfig(**kw))
    jstate["params"] = params
    jlogs = JTrainer(api_j, JTrainConfig(**kw),
                     jmake_dataset("markov", cfg.vocab_size, 16, 4, seed=0),
                     state=jstate).run(3)
    tc = TrainConfig(**kw)
    tlogs = Trainer(api_t, tc, make_dataset("markov", cfg.vocab_size, 16, 4, seed=0),
                    state=make_train_state(api_t, tc, params=model)).run(3)
    for a, b in zip(tlogs, jlogs):
        assert abs(a["loss"] - b["loss"]) <= 1e-3, (a, b)
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-3)


def test_accumulated_step_equals_the_full_batch_step():
    """accum_steps=2 averages the two half-batch gradients: on a linear
    loss in the batch that is the full batch's gradient, so the AdamW
    steps agree to rounding."""
    cfg = tcfgs.reduced(tcfgs.get("qwen3_1p7b"))
    api = tbuild(cfg)
    ds = make_dataset("markov", cfg.vocab_size, 16, 4, seed=3)
    states = []
    for accum in (1, 2):
        tc = TrainConfig(lr=1e-3, warmup_steps=1, accum_steps=accum)
        tr = Trainer(api, tc, ds, device="cpu")
        logs = tr.run(2)
        states.append((logs, tr.state["params"]))
    (l1, p1), (l2, p2) = states
    for a, b in zip(l1, l2):
        assert a["loss"] == pytest.approx(b["loss"], abs=1e-5)
    for a, b in zip(p1.parameters(), p2.parameters()):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)


# --------------------------------------------------------------------- #
# farm mode (local SGD)
# --------------------------------------------------------------------- #
def _local_setup():
    cfg = tcfgs.reduced(tcfgs.get("llama3p2_1b"))
    tc = TrainConfig(lr=2e-3, warmup_steps=1, total_steps=100,
                     schedule="constant")
    ls = LocalSGDConfig(inner_steps=2, n_shards=3, batch_per_shard=4,
                        seq_len=24)
    return cfg, tbuild(cfg), tc, ls


def test_round_program_is_bit_identical_on_reexecution():
    cfg, api, tc, ls = _local_setup()
    perm = np.random.default_rng(0).permutation(cfg.vocab_size).astype("int32")
    prog = make_local_round_program(api, tc, ls, perm)
    params = api.init(torch.Generator().manual_seed(0))
    payload = {"params": params, "round": 0, "shard": 1}
    out1, out2 = prog.fn(payload), prog.fn(payload)
    assert torch.equal(out1["loss"], out2["loss"])
    assert out1["delta"].keys() == dict(params.named_parameters()).keys()
    for k in out1["delta"]:
        assert torch.equal(out1["delta"][k], out2["delta"][k]), k
    assert any(d.abs().max() > 0 for d in out1["delta"].values())
    assert not any(p.requires_grad for p in params.parameters())


def test_markov_batch_follows_the_permutation():
    perm = np.random.default_rng(0).permutation(64).astype("int32")
    b = markov_batch(perm, 0, 3, 1, 0, 4, 16, noise=0.0)
    np.testing.assert_array_equal(perm[b["tokens"]], b["targets"])
    again = markov_batch(perm, 0, 3, 1, 0, 4, 16, noise=0.0)
    np.testing.assert_array_equal(b["tokens"], again["tokens"])
    other = markov_batch(perm, 0, 3, 2, 0, 4, 16, noise=0.0)
    assert not np.array_equal(b["tokens"], other["tokens"])


def test_farm_training_reduces_loss_and_survives_fault():
    cfg, api, tc, ls = _local_setup()
    lookup = LookupService()
    svcs = [Service(lookup, device="cpu") for _ in range(2)]
    for s in svcs:
        s.start()
    tr = LocalSGDTrainer(api, tc, ls, lookup=lookup, device="cpu")
    losses = tr.run(3, timeout=300)
    assert losses[-1] < losses[0] + 0.05
    svcs[0].fail_after(1)
    loss = tr.run_round(timeout=300)
    assert np.isfinite(loss)
    assert tr.farm_stats[-1]["done"] == ls.n_shards
    assert tr.round == 4


def test_round_loss_matches_reference_on_its_batches():
    """One round task of each package from the same converted weights,
    the port fed the reference's in-jit batches."""
    api_j, params, api_t, model = _models("llama3p2_1b")
    cfg = api_t.cfg
    kw = dict(lr=2e-3, warmup_steps=1, total_steps=100, schedule="constant")
    lkw = dict(inner_steps=2, n_shards=3, batch_per_shard=4, seq_len=24)
    perm = np.random.default_rng(0).permutation(cfg.vocab_size).astype("int32")
    jout = jax.jit(jround(api_j, JTrainConfig(**kw), JLocalSGDConfig(**lkw),
                          perm).fn)({"params": params, "round": jnp.asarray(1),
                                     "shard": jnp.asarray(2)})
    tc = TrainConfig(**kw)

    def ref_batches(rnd, shard, h):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(tc.seed), rnd * 131 + h), shard)
        b = _synthetic_batch(key, jnp.asarray(perm), lkw["batch_per_shard"],
                             lkw["seq_len"])
        return {k: np.array(v) for k, v in b.items()}

    prog = make_local_round_program(api_t, tc, LocalSGDConfig(**lkw), perm,
                                    batch_fn=ref_batches)
    tout = prog.fn({"params": model, "round": 1, "shard": 2})
    assert abs(tout["loss"].item() - float(jout["loss"])) <= 1e-3


# --------------------------------------------------------------------- #
# launcher
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["sync", "farm"])
def test_train_launcher_runs_on_the_cpu(mode, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--mode",
            mode, "--batch", "2", "--seq-len", "16",
            "--metrics-out", str(tmp_path / "m.json")]
    args += (["--steps", "3", "--ckpt-dir", str(tmp_path / "ck")]
             if mode == "sync" else ["--rounds", "1", "--services", "2"])
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "qwen3-1.7b (2 layers) on cpu" in proc.stdout
    assert (tmp_path / "m.json").is_file()
    if mode == "sync":
        assert latest_step(str(tmp_path / "ck")) == 3
    else:
        assert "'done': 4" in proc.stdout
