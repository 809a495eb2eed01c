"""The port's Mamba path against the JAX package on the CPU: the plain
selective scans, the differentiable scan, reduced falcon-mamba's loss,
logits, decode state and greedy tokens, and both launchers.

Inputs are drawn with numpy, or converted from the JAX package's
``api.init(PRNGKey(0))`` parameters through ``params_from_jax``.
Tolerances are the reference suites' own: the scan 1e-4 and its grads
1e-3 (``tests/test_kernels_mamba.py``), model loss 2e-4 and parameter
grads 1e-3 (``tests/test_pallas_backend.py``), logits 2e-3
(``tests/test_serve_consistency.py``).
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
from repro.core import LookupService as JLookup
from repro.core import Service as JService
from repro.kernels.mamba_scan.ops import mamba_scan as jscan_pallas
from repro.kernels.mamba_scan.ref import mamba_scan_naive as jnaive
from repro.kernels.mamba_scan.ref import mamba_scan_ref as jref
from repro.models import build as jbuild
from repro.runtime.serve_loop import ServeConfig as JServeConfig
from repro.runtime.serve_loop import serve_requests as jserve
from repro_torch import kernels
from repro_torch.core import LookupService, Service
from repro_torch.interop import params_from_jax
from repro_torch.kernels.mamba_scan import (mamba_scan, mamba_scan_fwd,
                                            mamba_scan_naive, mamba_scan_plain)
from repro_torch.models import build as tbuild
from repro_torch.runtime.serve_loop import ServeConfig, serve_requests


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
ARCH = "falcon_mamba_7b"
SWEEP = [(2, 64, 32, 4), (1, 128, 64, 16), (2, 256, 16, 8)]
SCAN_TOL, GRAD_TOL, LOSS_TOL, LOGIT_TOL = 1e-4, 1e-3, 2e-4, 2e-3


def _scan_inputs(b, s, d, n, seed):
    """x, dt, A, B, C as the reference's scan tests draw them: dt =
    softplus(normal), A = -exp(0.5 normal)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d), np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, d)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal((d, n)) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, s, n), np.float32)
    C = rng.standard_normal((b, s, n), np.float32)
    return x, dt, A, B, C


def _close(got, ref, tol=SCAN_TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=tol,
                               rtol=tol, err_msg=msg)


def _models():
    cfg_j = jcfgs.reduced(jcfgs.get(ARCH))
    cfg_t = tcfgs.reduced(tcfgs.get(ARCH))
    api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
    params = api_j.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    return api_j, params, api_t, model


# --------------------------------------------------------------------- #
# the scan
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", SWEEP)
def test_plain_scan_matches_the_reference_scans(shape):
    args = _scan_inputs(*shape, seed=sum(shape))
    targs = [torch.from_numpy(a) for a in args]
    y0, h0 = jnaive(*map(jnp.asarray, args))
    y, h = mamba_scan_plain(*targs)
    _close(y, y0, msg="y vs naive")
    _close(h, h0, msg="h vs naive")
    y1, h1 = jref(*map(jnp.asarray, args), chunk=32)
    y, h = mamba_scan_plain(*targs, chunk=32)
    _close(y, y1, msg="y vs chunked ref")
    _close(h, h1, msg="h vs chunked ref")
    y, h = mamba_scan_naive(*targs)
    _close(y, y0, msg="naive y")
    _close(h, h0, msg="naive h")


def test_plain_scan_matches_the_pallas_kernel_in_interpret_mode():
    args = _scan_inputs(1, 128, 64, 16, seed=7)
    y0, h0 = jscan_pallas(*map(jnp.asarray, args), interpret=True)
    y, h = mamba_scan_fwd(*[torch.from_numpy(a) for a in args])
    _close(y, y0)
    _close(h, h0)


@pytest.mark.parametrize("s,chunk", [(13, None), (13, 4), (12, 5), (1, None)])
def test_ragged_lengths(s, chunk):
    """Any s: a prime length, a chunk that does not divide s (it falls to
    the largest divisor below it) and a single step."""
    args = _scan_inputs(2, s, 24, 4, seed=s)
    y0, h0 = jnaive(*map(jnp.asarray, args))
    y, h = mamba_scan_plain(*[torch.from_numpy(a) for a in args], chunk=chunk)
    _close(y, y0)
    _close(h, h0)


def test_initial_state_carry():
    """A whole scan equals two half scans chained through h."""
    b, s, d, n = 1, 64, 16, 4
    x, dt, A, B, C = (torch.from_numpy(a)
                      for a in _scan_inputs(b, 2 * s, d, n, seed=2))
    y_full, h_full = jnaive(*(jnp.asarray(t.numpy()) for t in (x, dt, A, B, C)))
    y1, h1 = mamba_scan_fwd(x[:, :s], dt[:, :s], A, B[:, :s], C[:, :s])
    y2, h2 = mamba_scan_fwd(x[:, s:], dt[:, s:], A, B[:, s:], C[:, s:], h0=h1)
    _close(torch.cat([y1, y2], 1), y_full)
    _close(h2, h_full)
    y2n, h2n = mamba_scan_naive(x[:, s:], dt[:, s:], A, B[:, s:], C[:, s:], h0=h1)
    _close(y2, y2n.numpy())
    _close(h2, h2n.numpy())


def test_non_contiguous_inputs():
    """x, B and C as slices of wider projections, as the model passes
    them, give the results of their contiguous copies."""
    b, s, d, n = 2, 24, 16, 4
    x, dt, A, B, C = (torch.from_numpy(a) for a in _scan_inputs(b, s, d, n, seed=3))
    xz = torch.cat([x, torch.randn(b, s, d)], -1)
    proj = torch.cat([torch.randn(b, s, 3), B, C], -1)
    xv, Bv, Cv = xz[..., :d], proj[..., 3:3 + n], proj[..., 3 + n:]
    assert not (xv.is_contiguous() or Bv.is_contiguous() or Cv.is_contiguous())
    y, h = mamba_scan_fwd(xv, dt, A, Bv, Cv)
    y0, h0 = mamba_scan_fwd(x, dt, A, B, C)
    torch.testing.assert_close(y, y0, rtol=0, atol=0)
    torch.testing.assert_close(h, h0, rtol=0, atol=0)


def test_wrapper_rejects_mismatched_shapes():
    x, dt, A, B, C = (torch.from_numpy(a) for a in _scan_inputs(1, 8, 16, 4, seed=4))
    with pytest.raises(ValueError, match="B is"):
        mamba_scan_fwd(x, dt, A, B[:, :4], C)
    with pytest.raises(ValueError, match="h0 is"):
        mamba_scan_fwd(x, dt, A, B, C, h0=torch.zeros(1, 16, 5))


@pytest.mark.parametrize("with_h0", [False, True])
def test_autograd_function_grads_match_jax(with_h0):
    """The differentiable scan (kernel forward, autograd through the plain
    chunked scan in the backward) against ``jax.grad`` of the naive
    reference, for x, dt, A, B, C and h0."""
    b, s, d, n = 1, 64, 16, 4
    args = list(_scan_inputs(b, s, d, n, seed=5))
    if with_h0:
        args.append(np.random.default_rng(6).standard_normal((b, d, n), np.float32))
    argnums = tuple(range(len(args)))
    w = np.random.default_rng(8).standard_normal((b, d, n), np.float32)

    def jloss(*a):
        y, h = jnaive(*a)
        return y.sum() + (h * w).sum()

    gj = jax.grad(jloss, argnums=argnums)(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = mamba_scan(*leaves)
    (y.sum() + (h * torch.from_numpy(w)).sum()).backward()
    for name, leaf, ref in zip("x dt A B C h0".split(), leaves, gj):
        _close(leaf.grad, ref, tol=GRAD_TOL, msg=name)


def test_scan_grads_for_a_subset_of_inputs():
    """Only x asks for a gradient (A, B, C and dt are constants, no h0):
    the backward returns it, equal to the plain scan's own autograd."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in _scan_inputs(1, 8, 8, 4, seed=9))
    x.requires_grad_()
    y, _ = kernels.DISPATCH.scan(x, dt, A, B, C)
    gx, = torch.autograd.grad(y.square().sum(), [x])
    y_p, _ = kernels.PLAIN.scan(x, dt, A, B, C)
    gx_p, = torch.autograd.grad(y_p.square().sum(), [x])
    torch.testing.assert_close(y, y_p, rtol=0, atol=0)
    torch.testing.assert_close(gx, gx_p, rtol=0, atol=0)


# --------------------------------------------------------------------- #
# configs and the model
# --------------------------------------------------------------------- #
def test_config_mirrors_the_reference():
    for full in (True, False):
        cj, ct = jcfgs.get(ARCH), tcfgs.get("falcon-mamba-7b")
        if not full:
            cj, ct = jcfgs.reduced(cj), tcfgs.reduced(ct)
        for f in dataclasses.fields(ct):
            a, b = getattr(ct, f.name), getattr(cj, f.name)
            if f.name == "pattern":
                assert [(s.mixer, s.mlp, s.window) for s in a] == \
                       [(s.mixer, s.mlp, s.window) for s in b]
            elif f.name == "ssm":
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, f.name
        assert ct.d_inner == cj.d_inner
        assert ct.ssm.resolved_dt_rank(ct.d_model) == cj.ssm.resolved_dt_rank(cj.d_model)
    assert tcfgs.get(ARCH).ssm.resolved_dt_rank(4096) == 256
    assert tcfgs.reduced(tcfgs.get(ARCH)).ssm.resolved_dt_rank(64) == 8


def test_default_pattern_follows_the_family():
    from repro_torch.models.common import ModelConfig, SSMConfig

    kw = dict(n_layers=2, d_model=32, n_heads=1, n_kv_heads=1, d_ff=0,
              vocab_size=64, ssm=SSMConfig(4, 4, 2))
    assert ModelConfig(name="s", family="ssm", **kw).pattern[0].mixer == "mamba"
    assert ModelConfig(name="d", family="dense", **kw).pattern[0].mixer == "attn"
    with pytest.raises(ValueError, match="d_inner"):
        ModelConfig(name="d", family="dense", **{**kw, "ssm": None}).d_inner


def test_mamba_weights_and_state_dtypes_in_bf16():
    """A_log and D stay fp32 in a bf16 config; the state is a bf16 conv
    history and an fp32 SSM state; conversion keeps those dtypes."""
    cfg = tcfgs.reduced(tcfgs.get(ARCH)).replace(param_dtype="bfloat16",
                                                  compute_dtype="bfloat16")
    api = tbuild(cfg)
    model = api.init(torch.Generator().manual_seed(0))
    m = model.blocks[0].mamba
    assert m.A_log.dtype == m.D.dtype == torch.float32
    assert m.in_proj.dtype == m.dt_proj_b.dtype == torch.bfloat16
    assert not hasattr(model.blocks[0], "mlp_norm")
    st = api.make_caches(model, 3, 99)
    assert len(st) == cfg.n_layers
    assert st[0]["conv"].shape == (3, 3, cfg.d_inner)
    assert st[0]["conv"].dtype == torch.bfloat16
    assert st[0]["ssm"].shape == (3, cfg.d_inner, 4)
    assert st[0]["ssm"].dtype == torch.float32
    params = jbuild(jcfgs.reduced(jcfgs.get(ARCH)).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")).init(jax.random.PRNGKey(0))
    conv = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    assert conv.blocks[1].mamba.A_log.dtype == torch.float32
    np.testing.assert_array_equal(conv.blocks[1].mamba.A_log.numpy(),
                                  np.asarray(params["blocks"]["b0"]["mamba"]["A_log"][1]))


def test_other_families_still_raise():
    """A family outside the registry's ``FAMILIES`` raises (hybrid, the
    last of the reference's, is ported since jamba's slice)."""
    with pytest.raises(NotImplementedError, match="ported"):
        tbuild(tcfgs.reduced(tcfgs.get(ARCH)).replace(family="diffusion"))


def test_train_loss_and_grads_match_reference():
    api_j, params, api_t, model = _models()
    cfg = api_t.cfg
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: api_j.train_loss(p, {"tokens": jnp.asarray(tokens),
                                       "targets": jnp.asarray(targets)}),
        has_aux=True)(params)
    with jkernels.backend("pallas", interpret=True):
        loss_jp, _ = api_j.train_loss(params, {"tokens": jnp.asarray(tokens),
                                               "targets": jnp.asarray(targets)})
    model.requires_grad_(True)
    loss_t, met = api_t.train_loss(model, {"tokens": torch.from_numpy(tokens),
                                           "targets": torch.from_numpy(targets)})
    named = dict(model.named_parameters())
    grads_t = dict(zip(named, torch.autograd.grad(loss_t, list(named.values()))))
    assert abs(loss_t.item() - float(loss_j)) <= LOSS_TOL
    assert abs(loss_t.item() - float(loss_jp)) <= LOSS_TOL
    assert met["aux_loss"].item() == 0.0
    flat, _ = jax.tree_util.tree_flatten_with_path(grads_j)
    ref = {"/".join(str(k.key) for k in path): np.asarray(leaf)
           for path, leaf in flat}
    n_pat = len(cfg.pattern)
    seen = set()
    for name, g in grads_t.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            r, i = divmod(int(parts[1]), n_pat)
            key = "/".join(("blocks", f"b{i}") + tuple(parts[2:]))
            want = ref[key][r]
        else:
            key = "/".join(parts)
            want = ref[key]
        seen.add(key)
        np.testing.assert_allclose(g.numpy(), want, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
    assert seen == set(ref)


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_prefill_and_decode_logits_match_jax(jax_backend):
    api_j, params, api_t, model = _models()
    cfg = api_t.cfg
    B, T = 2, 12
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T + 4))
    ctx = (jkernels.backend("pallas", interpret=True)
           if jax_backend == "pallas" else contextlib.nullcontext())
    with ctx:
        lg_j, caches_j = api_j.prefill(params, {"tokens": jnp.asarray(tokens[:, :T])},
                                       seq_budget=T + 8)
        lg_t, caches_t = api_t.prefill(model, {"tokens": torch.from_numpy(tokens[:, :T])},
                                       seq_budget=T + 8)
        _close(lg_t, lg_j, LOGIT_TOL, "prefill")
        for name in ("conv", "ssm"):
            _close(caches_t[1][name], caches_j["b0"]["mamba"][name][1], LOGIT_TOL, name)
        for i in range(4):
            step = tokens[:, T + i:T + i + 1]
            lg_j, caches_j = api_j.decode(
                params, {"tokens": jnp.asarray(step, jnp.int32),
                         "cache_index": jnp.asarray(T + i, jnp.int32)}, caches_j)
            lg_t, caches_t = api_t.decode(
                model, {"tokens": torch.from_numpy(step), "cache_index": T + i},
                caches_t)
            _close(lg_t, lg_j, LOGIT_TOL, f"step {i}")


def test_decode_matches_incremental_prefill():
    """Prefill then one token at a time equals prefilling the longer
    prefix (the reference's serve-consistency check, on the port)."""
    _, _, api, model = _models()
    B, T = 2, 12
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, api.cfg.vocab_size, (B, T + 4)))
    ref = [api.prefill(model, {"tokens": tokens[:, :t + 1]}, seq_budget=T + 8)[0]
           for t in range(T, T + 4)]
    _, caches = api.prefill(model, {"tokens": tokens[:, :T]}, seq_budget=T + 8)
    for i in range(4):
        lg, caches = api.decode(model, {"tokens": tokens[:, T + i:T + i + 1],
                                        "cache_index": T + i}, caches)
        torch.testing.assert_close(lg, ref[i], atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_serve_requests_matches_jax_greedy_tokens():
    """Greedy tokens are compared where no step is a near-tie: the prompts
    (``np.random.default_rng(30)``, 8 x 16 tokens, 8 new tokens) were
    chosen so that the top-2 logit gap exceeds the logit tolerance at
    every step, and the test asserts that first."""
    api_j, params, api_t, model = _models()
    prompt, new, n_req = 16, 8, 8
    prompts = np.random.default_rng(30).integers(0, api_t.cfg.vocab_size,
                                                (n_req, prompt))
    lg, caches = api_t.prefill(model, {"tokens": torch.from_numpy(prompts)},
                               seq_budget=prompt + new)
    for i in range(new):
        top2 = torch.topk(lg, 2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > LOGIT_TOL
        lg, caches = api_t.decode(model, {"tokens": lg.argmax(-1)[:, None],
                                          "cache_index": prompt + i}, caches)
    jlookup = JLookup()
    for _ in range(2):
        JService(jlookup).start()
    gen_j, _ = jserve(api_j, params, prompts,
                      JServeConfig(max_new_tokens=new, prompt_len=prompt,
                                   batch_per_task=4), lookup=jlookup)
    lookup = LookupService()
    for _ in range(2):
        Service(lookup, device="cpu").start()
    gen_t, stats = serve_requests(api_t, model, prompts,
                                  ServeConfig(max_new_tokens=new, prompt_len=prompt,
                                              batch_per_task=4), lookup=lookup)
    np.testing.assert_array_equal(gen_t.numpy(), np.asarray(gen_j))
    assert stats["done"] == n_req // 4


# --------------------------------------------------------------------- #
# launchers
# --------------------------------------------------------------------- #
def _launch(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", module, "--arch",
                           "falcon-mamba-7b", "--reduced", "--device", "cpu", *args],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_serve_launcher_runs_falcon_mamba_on_the_cpu():
    out = _launch("repro_torch.launch.serve", "--requests", "4", "--services", "2")
    assert "generated (4, 8) on cpu" in out


@pytest.mark.parametrize("mode", ["sync", "farm"])
def test_train_launcher_runs_falcon_mamba_on_the_cpu(mode):
    args = ["--mode", mode, "--batch", "2", "--seq-len", "16"]
    args += ["--steps", "2"] if mode == "sync" else ["--rounds", "1", "--services", "2"]
    out = _launch("repro_torch.launch.train", *args)
    assert "falcon-mamba-7b (2 layers) on cpu" in out
    if mode == "farm":
        assert "'done': 4" in out
