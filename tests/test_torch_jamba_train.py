"""Training jamba-1.5-large-398b (hybrid) as ``chip_smoke.py``'s phase 28
trains it on the card, on the CPU against the JAX package:

- the phase's cut config differs from the published one only in
  ``n_layers`` and ``d_ff``, and its parameter counts are the reference's
  for the same cut;
- a reduced jamba with the published routing (16 experts, top-2, capacity
  1.25), remat and bf16 moments takes one whole training step against the
  reference's ``make_train_step`` on the same weights (``params_from_jax``)
  and batch: the loss at 2e-4, every gradient at 1e-3 (``jax.grad``), and
  each weight's change in relative norm at 1e-3;
- loss and gradients with ``long_context=True`` at a sequence longer than
  the window against ``jax.grad`` at 1e-3;
- ``repro_torch.kernels.train_step_launches``, from which the phase takes
  the launches it holds, against the kernel wrappers' calls in a CPU
  training step, with remat on and off and at long context;
- ``mamba_scan_plain_train``, the plain side of the phase's comparisons,
  against autograd through the plain chunked scan, bit for bit.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from repro.models import build as jbuild
from repro_torch.interop import params_from_jax
from repro_torch.models import build as tbuild

ROOT = Path(__file__).resolve().parents[1]
ARCH = "jamba_1p5_large_398b"
LOSS_TOL, GRAD_TOL, DELTA_TOL = 2e-4, 1e-3, 1e-3
B, T, LONG = 2, 16, 48
LR = 3e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cut(cfg):
    """The reduced widths of ``test_torch_hybrid.py`` with the published
    routing, remat and moment dtype."""
    full = cfg.get(ARCH)
    return cfg.reduced(full).replace(
        moe=dataclasses.replace(cfg.reduced(full).moe, n_experts=full.moe.n_experts,
                                top_k=full.moe.top_k,
                                capacity_factor=full.moe.capacity_factor),
        remat=full.remat, opt_state_dtype=full.opt_state_dtype)


def _models():
    cfg_j, cfg_t = _cut(jcfgs), _cut(tcfgs)
    assert (cfg_t.moe.n_experts, cfg_t.moe.top_k, cfg_t.moe.capacity_factor, cfg_t.remat,
            cfg_t.opt_state_dtype) == (16, 2, 1.25, True, "bfloat16")
    api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
    params = api_j.init(jax.random.PRNGKey(0))
    return api_j, params, api_t, lambda: params_from_jax(jax.tree.map(np.asarray, params),
                                                         cfg_t, "cpu")


def _batch(cfg, seq, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)}


def _named(tree, cfg):
    """A reference tree (weights or gradients) by the port's parameter names."""
    return {k: v.detach().numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, tree), cfg, "cpu").named_parameters()}


def test_phase_cut_changes_only_depth_and_d_ff():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    full, cut = chip_smoke.jamba_train_cfg()
    assert full == tcfgs.get(ARCH)
    changed = {f.name for f in dataclasses.fields(full)
               if getattr(full, f.name) != getattr(cut, f.name)}
    assert changed == {"n_layers", "d_ff"}
    assert (cut.n_layers, cut.d_ff) == (len(full.pattern), 1024)
    want = jcfgs.get(ARCH).replace(n_layers=cut.n_layers, d_ff=cut.d_ff).param_counts()
    assert cut.param_counts() == want == (5_878_628_352, 4_468_817_920)


def _deltas(state, step):
    """{name: the change of each weight} over ``step(state)``."""
    before = {k: p.detach().clone() for k, p in state["params"].named_parameters()}
    step(state)
    return {k: (p.detach() - before[k]).numpy() for k, p in state["params"].named_parameters()}


def _worst_delta(got, want) -> tuple:
    return max((np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k]), k) for k in want)


def test_one_training_step_matches_the_reference():
    """One AdamW step (bf16 moments) from the same weights on the same
    batch: the loss, every gradient, and each weight's change.  The change
    is held at DELTA_TOL where the port's AdamW takes the reference's
    gradients (2.5e-5 here); on the port's own gradients, which differ
    from ``jax.grad``'s by rounding, a first moment's bf16 rounding can
    fall the other way, which moves that element's update by one bf16 ulp
    of it, at most 2^-7: the step's own changes are held there (2.19e-3
    read, ``blocks.0.mlp.wo``, torch 2.13 on this CPU)."""
    from repro.optim.adamw import adamw_update as jadamw_update
    from repro.optim.adamw import init_opt_state
    from repro.runtime.train_loop import TrainConfig as JTrainConfig
    from repro.runtime.train_loop import make_lr_fn as jmake_lr_fn
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.runtime.train_loop import (TrainConfig, loss_and_grads, make_lr_fn,
                                                make_train_state, make_train_step)

    api_j, params, api_t, fresh = _models()
    batch = _batch(api_t.cfg, T, 4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, met_j), grads_j = jax.value_and_grad(lambda p: api_j.train_loss(p, jbatch),
                                                  has_aux=True)(params)
    # the rest of the reference's make_train_step (accum_steps 1) on them
    tc_j = JTrainConfig(lr=LR, warmup_steps=0, total_steps=10)
    opt_j = init_opt_state(params, moment_dtype=api_j.cfg.opt_state_dtype)
    params_j, _, _ = jadamw_update(
        grads_j, opt_j, params, lr=jmake_lr_fn(tc_j)(opt_j["step"]), b1=tc_j.b1, b2=tc_j.b2,
        weight_decay=tc_j.weight_decay, moment_dtype=api_j.cfg.opt_state_dtype,
        clip_norm=tc_j.clip_norm)
    w0, w1 = _named(params, api_t.cfg), _named(params_j, api_t.cfg)
    want = {k: w1[k] - w0[k] for k in w0}

    tc = TrainConfig(lr=LR, warmup_steps=0, total_steps=10)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state = make_train_state(api_t, tc, params=fresh())
    loss_t, met_t, grads_t = loss_and_grads(api_t, state["params"], tbatch)
    metrics = {}
    got = _deltas(state, lambda s: metrics.update(make_train_step(api_t, tc)(s, tbatch)[1]))

    assert float(met_t["aux_loss"]) > 0
    for a, b in ((loss_t, loss_j), (met_t["aux_loss"], met_j["aux_loss"]),
                 (metrics["loss"], loss_j)):
        np.testing.assert_allclose(float(a), float(b), atol=LOSS_TOL, rtol=LOSS_TOL)
    ref = _named(grads_j, api_t.cfg)
    assert ref.keys() == grads_t.keys()
    for name, g in grads_t.items():
        np.testing.assert_allclose(g.numpy(), ref[name], atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
    assert _worst_delta(got, want)[0] <= 2.0 ** -7, _worst_delta(got, want)
    assert all(any(f".{kind}." in k for k in got) for kind in ("attn", "mamba", "mlp", "moe"))

    state = make_train_state(api_t, tc, params=fresh())
    grads = {k: torch.from_numpy(v.copy()) for k, v in ref.items()}
    on_ref = _deltas(state, lambda s: adamw_update(
        grads, s["opt"], dict(s["params"].named_parameters()), lr=make_lr_fn(tc)(s["opt"]["step"]),
        b1=tc.b1, b2=tc.b2, weight_decay=tc.weight_decay, moment_dtype=api_t.cfg.opt_state_dtype,
        clip_norm=tc.clip_norm))
    assert _worst_delta(on_ref, want)[0] <= DELTA_TOL, _worst_delta(on_ref, want)


def test_long_context_gradients_match_jax_grad():
    """``long_context=True`` at LONG tokens, past the window: the attention
    layer trains through the chunked flash, remat on, 16 experts."""
    from repro_torch.runtime.train_loop import loss_and_grads

    api_j, params, api_t, fresh = _models()
    assert LONG > api_t.cfg.long_context_window
    batch = _batch(api_t.cfg, LONG, 5)
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: api_j.train_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                   long_context=True), has_aux=True)(params)
    model = fresh()
    model.requires_grad_(True)
    loss_t, _, grads_t = loss_and_grads(api_t, model, {k: torch.from_numpy(v)
                                                       for k, v in batch.items()},
                                        long_context=True)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=LOSS_TOL, rtol=LOSS_TOL)
    ref = _named(grads_j, api_t.cfg)
    for name, g in grads_t.items():
        np.testing.assert_allclose(g.numpy(), ref[name], atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
    assert any(".attn." in name for name in grads_t)


@pytest.mark.parametrize("remat, long_context", [(True, False), (False, False),
                                                 (True, True)])
def test_train_step_launches_counts_the_kernel_entries(monkeypatch, remat, long_context):
    """Each kernel wrapper launches its kernel once a call on CUDA tensors
    (the backward wrapper dq and dk/dv once each); on the CPU the same
    calls run the plain versions.  So the calls of one CPU training step
    are the launches the phase holds on the card."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.runtime.train_loop import loss_and_grads

    calls = {"fwd": 0, "bwd": 0, "scan": 0}

    def counted(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(flash_ops, "flash_attention_fwd",
                        counted("fwd", flash_ops.flash_attention_fwd))
    monkeypatch.setattr(flash_ops, "flash_attention_bwd",
                        counted("bwd", flash_ops.flash_attention_bwd))
    monkeypatch.setattr(scan_ops, "mamba_scan_fwd", counted("scan", scan_ops.mamba_scan_fwd))
    _, _, api_t, fresh = _models()
    cfg = api_t.cfg.replace(remat=remat)
    model = fresh()
    model.cfg = cfg
    model.requires_grad_(True)
    loss_and_grads(api_t, model, {k: torch.from_numpy(v)
                                  for k, v in _batch(cfg, LONG, 6).items()},
                   long_context=long_context)
    fp32 = kernels.train_step_launches(cfg, long_context=long_context)
    assert fp32["flash_attention_sm90_fp32"] == calls["fwd"]
    assert fp32["flash_bwd_dq_sm90_fp32"] == fp32["flash_bwd_dkv_sm90_fp32"] == calls["bwd"]
    assert fp32["mamba_scan_sm90"] == calls["scan"]
    assert calls["scan"] == (2 if remat else 1) * 7 * cfg.n_repeats
    assert calls["fwd"] == (0 if long_context else (2 if remat else 1) * cfg.n_repeats)
    # the phase's cut at the published widths: bf16, remat, one period
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    want = {kern.name: 0 for kern in kernels.KERNELS}
    want.update({"mamba_scan_sm90": 14} if long_context else
                {"flash_attention_sm90": 2, "flash_bwd_dq_sm90": 1, "flash_bwd_dkv_sm90": 1,
                 "mamba_scan_sm90": 14})
    if remat:
        assert kernels.train_step_launches(chip_smoke.jamba_train_cfg()[1],
                                           long_context=long_context) == want


@pytest.mark.parametrize("with_h0", [False, True])
def test_lean_plain_scan_is_the_plain_scan(with_h0):
    """Outputs and every input's gradient bit for bit, a ragged chunk and
    one A a batch row too; and a reduced jamba step through ``PLAIN`` with
    the lean scan is the step through ``PLAIN``."""
    from repro_torch import kernels
    from repro_torch.kernels.mamba_scan import mamba_scan_plain, mamba_scan_plain_train
    from repro_torch.runtime.train_loop import loss_and_grads

    rng = np.random.default_rng(9)
    b, s, d, n = 2, 300, 8, 4
    x, dt, B, C = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                   for shape in ((b, s, d), (b, s, d), (b, s, n), (b, s, n)))
    dt = torch.nn.functional.softplus(dt)
    for A in (-torch.exp(torch.from_numpy(rng.standard_normal((d, n), np.float32))),
              -torch.exp(torch.from_numpy(rng.standard_normal((b, d, n), np.float32)))):
        h0 = torch.from_numpy(rng.standard_normal((b, d, n), np.float32)) if with_h0 else None
        got, want = [], []
        for fn, out in ((mamba_scan_plain_train, got), (mamba_scan_plain, want)):
            leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
            extra = [h0.clone().requires_grad_()] if with_h0 else []
            y, h = fn(*leaves, *extra)
            out += [y, h, *torch.autograd.grad((y * 1.5).sum() + (h * h).sum(), leaves + extra)]
        assert all(torch.equal(a, w) for a, w in zip(got, want))

    _, _, api_t, fresh = _models()
    batch = {k: torch.from_numpy(v) for k, v in _batch(api_t.cfg, T, 7).items()}
    model = fresh()
    model.requires_grad_(True)
    lean = kernels.PLAIN._replace(scan=mamba_scan_plain_train)
    loss_l, _, g_l = loss_and_grads(api_t, model, batch, ops=lean)
    loss_p, _, g_p = loss_and_grads(api_t, model, batch, ops=kernels.PLAIN)
    assert torch.equal(loss_l, loss_p) and all(torch.equal(g_l[k], g_p[k]) for k in g_p)
