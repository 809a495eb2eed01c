"""Training the port's MoE family against the JAX package at reduced
size: llama4-maverick (top-1, a dense/MoE interleave of 2) and arctic
(top-2, every layer MoE), both with a dense residual, in fp32.

Gradients: both packages start from the JAX package's
``api.init(PRNGKey(0))`` parameters (through ``params_from_jax``) and take
the same numpy batch; ``jax.value_and_grad`` of the reference's
``train_loss`` (cross-entropy plus the MoE aux losses) goes through the
same ``params_from_jax`` mapping, so each port parameter meets the
reference's gradient of the same weight, within 1e-3 absolute and
relative (the attention-gradient tolerance), the losses within 2e-4.
Each case runs with ``remat`` off and on, on both sides (the reference's
``jax.checkpoint`` of its scan body; the port's ``torch.utils.checkpoint``
of each pattern repeat), on a random batch and on one whose first row
repeats one token, so that every token of its routing group picks the
same experts and the capacity drops most of them (more than the random
batch, whose 4 experts drop a few); the routers' gradients are checked
on their own too.  (The MoE layer's gradients alone are held to
``jax.grad`` of ``apply_moe`` in ``test_torch_moe.py``.)

AdamW: one step on the reduced model's gradients with each config's own
moments (llama4 bf16, arctic int8) against the reference's ``adamw_update`` at its own tolerance,
the port's slices cut small enough that every expert stack and the
embeddings go in several.  The launcher trains reduced llama4 on the CPU.
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
import repro_torch.optim.adamw as tadamw
from repro.models import build as jbuild
from repro.optim import adamw_update as jadamw
from repro.optim import init_opt_state as jinit_opt
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


ARCHS = ["llama4_maverick_400b_a17b", "arctic_480b"]
GRAD_TOL, LOSS_TOL = 1e-3, 2e-4
B, T = 2, 16


def _cfgs(arch, **kw):
    cj, ct = jcfgs.reduced(jcfgs.get(arch)), tcfgs.reduced(tcfgs.get(arch))
    return cj.replace(**kw), ct.replace(**kw)


def _batch(cfg, kind, seed=7):
    """numpy tokens and targets; ``dropping``: the first row one token
    repeated."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)),
             "targets": rng.integers(0, cfg.vocab_size, (B, T))}
    if kind == "dropping":
        batch["tokens"][0] = batch["tokens"][0, 0]
    return batch


def _dropped(model, batch):
    """(token, choice) pairs the capacity dropped in a forward of ``batch``."""
    seen = []
    hooks = [blk.moe.register_forward_hook(
        lambda layer, args, out: seen.append(layer.route(args[0])))
        for blk in model.blocks if blk.spec.mlp == "moe"]
    with torch.no_grad():
        model.train_loss(batch)
    for h in hooks:
        h.remove()
    return sum(int(onehot.sum() - keep.sum()) for _, _, onehot, keep, _, _ in seen)


def _jax_grads(api_j, params, batch):
    (loss, _), grads = jax.value_and_grad(
        lambda p: api_j.train_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    return loss, grads


@pytest.mark.parametrize("kind", ["random", "dropping"])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_grads_match_jax(arch, remat, kind):
    cfg_j, cfg_t = _cfgs(arch, remat=remat)
    api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
    params = api_j.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    model.requires_grad_(True)
    batch = _batch(cfg_t, kind)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if kind == "dropping":  # more than a random batch drops (4 experts drop some)
        rand = {k: torch.from_numpy(v) for k, v in _batch(cfg_t, "random").items()}
        assert _dropped(model, tbatch) > _dropped(model, rand)
    loss_j, grads_j = _jax_grads(api_j, params, batch)
    loss_t, metrics, grads_t = loss_and_grads(api_t, model, tbatch)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=LOSS_TOL, rtol=LOSS_TOL)
    assert float(metrics["aux_loss"]) > 0
    ref = dict(params_from_jax(jax.tree.map(np.asarray, grads_j), cfg_t,
                               "cpu").named_parameters())
    assert ref.keys() == grads_t.keys()
    routers = [n for n in grads_t if n.endswith("moe.router")]
    assert len(routers) == cfg_t.n_repeats * sum(s.mlp == "moe" for s in cfg_t.pattern)
    for name, g in grads_t.items():
        assert g.shape == ref[name].shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), ref[name].detach().numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"{arch} {name}")
    # the router learns from the gates and the aux losses: its gradient on
    # its own, against the reference's
    for name in routers:
        assert float(grads_t[name].abs().max()) > 0, name
        np.testing.assert_allclose(grads_t[name].numpy(), ref[name].detach().numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_step_on_moe_grads_matches_reference(arch, monkeypatch):
    """One clipped step with the config's own moments (llama4 bf16, arctic
    int8) on the reduced model's own gradients, the port's update sliced
    (every tensor over 600 elements in slices of its leading axis: an
    expert stack one expert at a time), at the reference suite's AdamW
    tolerance."""
    monkeypatch.setattr(tadamw, "SLICE", 600)
    moment = tcfgs.get(arch).opt_state_dtype
    assert moment == {"llama4_maverick_400b_a17b": "bfloat16", "arctic_480b": "int8"}[arch]
    cfg_j, cfg_t = _cfgs(arch, opt_state_dtype=moment)
    params = jbuild(cfg_j).init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    model.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg_t, "random").items()}
    _, _, grads = loss_and_grads(tbuild(cfg_t), model, batch)
    named = {k: p.detach() for k, p in model.named_parameters()}
    assert len(tadamw._slices(named["blocks.1.moe.experts.wi"])) == cfg_t.moe.n_experts
    P = {k: p.numpy().copy() for k, p in named.items()}
    G = {k: g.numpy().copy() for k, g in grads.items()}
    jp = {k: jnp.asarray(v) for k, v in P.items()}
    js = jinit_opt(jp, moment_dtype=moment)
    ts = tadamw.init_opt_state(named, moment_dtype=moment)
    step = jax.jit(lambda g, s, p: jadamw(g, s, p, lr=1e-2, moment_dtype=moment,
                                          clip_norm=1.0))  # one compile, not one an op
    jp, js, jm = step({k: jnp.asarray(v) for k, v in G.items()}, js, jp)
    # copies: the port clips its gradients in place, and JAX may still be
    # reading the numpy buffers it was given (dispatch is asynchronous)
    _, ts, tm = tadamw.adamw_update({k: torch.from_numpy(v.copy()) for k, v in G.items()},
                                    ts, named, lr=1e-2, moment_dtype=moment, clip_norm=1.0)
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
    for k in P:
        np.testing.assert_allclose(named[k].numpy(), np.asarray(jp[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_train_launcher_trains_llama4_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama4_maverick_400b_a17b", "--reduced", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq-len", "32"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "llama4-maverick-400b-a17b (4 layers) on cpu: final loss" in proc.stdout
