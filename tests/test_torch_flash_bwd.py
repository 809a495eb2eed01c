"""The port's flash-attention backward against the JAX package's Pallas
backward kernels (interpret mode).

Inputs are drawn with numpy and handed to both packages; bf16 cases round
the same fp32 draws to bf16 on both sides.  Tolerances are the reference
suite's own (``tests/test_kernels_flash_bwd.py``): 1e-3 in fp32, 6e-2
absolute / 1e-2 relative in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_bwd as jax_bwd
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_fwd as jax_fwd
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.kernels import DISPATCH, PLAIN
from repro_torch.kernels.flash_attention import (DKV_SM90_FP32_KERNEL,
                                                 DQ_SM90_FP32_KERNEL,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)


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


F32, BF16 = "float32", "bfloat16"
_JNP = {F32: jnp.float32, BF16: jnp.bfloat16}
_TORCH = {F32: torch.float32, BF16: torch.bfloat16}

CASES = [
    # (B, Sq, Skv, H, K, D, Dv, causal, dtype): the reference sweep ...
    (2, 128, 128, 4, 2, 64, 64, True, F32),
    (1, 256, 256, 8, 8, 32, 32, True, F32),
    (2, 128, 128, 4, 1, 64, 64, False, F32),
    (1, 128, 128, 6, 2, 32, 32, True, BF16),
    # ... and a ragged length (block 13 resolves on the JAX side) ...
    (2, 13, 13, 4, 2, 16, 16, True, F32),
    # ... and the trained families' shapes: MLA's (D, Dv) = (96, 64),
    # phi-3's 96, whisper's non-causal cross-attention with Sq != Skv
    (1, 128, 128, 4, 4, 96, 64, True, F32),
    (1, 128, 128, 2, 2, 96, 64, True, BF16),
    (1, 128, 128, 4, 4, 96, 96, True, BF16),
    (2, 48, 150, 2, 2, 64, 64, False, F32),
    (1, 48, 150, 6, 6, 64, 64, False, BF16),
    # ... and the MoE family's odd GQA groups: G = 5 (llama4's 40 over 8)
    # and G = 7 (arctic's 56 over 8), causal and not
    (1, 64, 64, 10, 2, 32, 32, True, BF16),
    (1, 48, 80, 10, 2, 32, 32, False, F32),
    (1, 64, 64, 7, 1, 16, 16, True, F32),
    (2, 40, 40, 7, 1, 32, 32, False, BF16),
]


def _tol(dtype):
    return (6e-2, 1e-2) if dtype == BF16 else (1e-3, 1e-3)


def _pair(x, dtype):
    return jnp.asarray(x, _JNP[dtype]), torch.from_numpy(x).to(_TORCH[dtype])


def _inputs(case, seed=0):
    B, Sq, Skv, H, K, D, Dv, causal, dtype = case
    rng = np.random.default_rng(seed)
    shapes = ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, Dv), (B, Sq, H, Dv))
    return [_pair(rng.standard_normal(s, np.float32), dtype) for s in shapes]


def _blocks(case):
    """The Pallas kernels' (block_q, block_k): 64 where it divides the
    length, else the whole length."""
    Sq, Skv = case[1], case[2]
    return tuple(n if n % 64 else 64 for n in (Sq, Skv))


@pytest.mark.parametrize("case", CASES)
def test_plain_bwd_matches_pallas_bwd(case):
    """The same (q, k, v, out, lse, dO) through both backward passes."""
    causal, dtype = case[-2:]
    (qj, qt), (kj, kt), (vj, vt), (gj, gt) = _inputs(case)
    bq, bk = _blocks(case)
    out_j, lse_j = jax_fwd(qj, kj, vj, causal=causal, block_q=bq,
                           block_k=bk, interpret=True, return_lse=True)
    ref = jax_bwd(qj, kj, vj, out_j, lse_j, gj, causal=causal, block_q=bq,
                  block_k=bk, interpret=True)
    out_t = torch.from_numpy(np.array(out_j, np.float32)).to(_TORCH[dtype])
    lse_t = torch.from_numpy(np.array(lse_j))
    got = flash_attention_bwd(qt, kt, vt, out_t, lse_t, gt, causal=causal)
    atol, rtol = _tol(dtype)
    for name, a, b, like in zip(("dq", "dk", "dv"), got, ref, (qt, kt, vt)):
        assert a.dtype == like.dtype and a.shape == like.shape
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_dispatch_train_grads_match_jax_grad(case):
    """Autograd of ``DISPATCH.train`` (the plain versions on the CPU) vs
    ``jax.grad`` of the reference's differentiable ``flash_attention``."""
    causal, dtype = case[-2:]
    (qj, qt), (kj, kt), (vj, vt), (cj, ct) = _inputs(case, seed=1)
    co_j = cj.astype(jnp.float32)
    bq, bk = _blocks(case)
    ref = jax.grad(lambda *a: (jax_flash(
        *a, causal=causal, block_q=bq, block_k=bk, interpret=True
    ).astype(jnp.float32) * co_j).sum(), argnums=(0, 1, 2))(qj, kj, vj)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    out = DISPATCH.train(*leaves, causal=causal, window=None)
    (out.float() * ct.float()).sum().backward()
    atol, rtol = _tol(dtype)
    for name, a, b in zip("qkv", leaves, ref):
        np.testing.assert_allclose(a.grad.float().numpy(),
                                   np.asarray(b, np.float32), atol=atol,
                                   rtol=rtol, err_msg=f"d{name}")


def test_plain_bwd_is_autograd_of_plain_fwd():
    """p recomputed from lse gives autograd's gradients of the plain
    forward, causal and not, with Sq != Skv."""
    rng = np.random.default_rng(2)
    for causal, (Sq, Skv) in ((True, (24, 40)), (False, (17, 9))):
        q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
                   for s in ((2, Sq, 4, 16), (2, Skv, 2, 16), (2, Skv, 2, 16)))
        g = torch.from_numpy(rng.standard_normal((2, Sq, 4, 16), np.float32))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out, lse = flash_attention_plain(*leaves, causal=causal)
        ref = torch.autograd.grad(out, leaves, g)
        got = flash_attention_bwd_plain(q, k, v, out.detach(), lse.detach(), g,
                                        causal=causal)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_plain_train_ops_match_dispatch_on_cpu():
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s, np.float32))
                  for s in ((1, 19, 4, 32), (1, 19, 2, 32), (1, 19, 2, 32),
                            (1, 19, 4, 32)))
    grads = []
    for ops in (DISPATCH, PLAIN):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops.train(*leaves, causal=True, window=None)
        grads.append(torch.autograd.grad(out, leaves, g))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    with pytest.raises(NotImplementedError, match="window"):
        PLAIN.train(q, k, v, causal=True, window=4)


def test_bwd_wrapper_validates_and_never_launches_on_cpu():
    q = torch.zeros(1, 5, 4, 32)
    kv = torch.zeros(1, 5, 2, 32)
    out, lse = flash_attention_plain(q, kv, kv)
    before = (DQ_SM90_FP32_KERNEL.launches, DKV_SM90_FP32_KERNEL.launches)
    flash_attention_bwd(q, kv, kv, out, lse, out)
    assert (DQ_SM90_FP32_KERNEL.launches, DKV_SM90_FP32_KERNEL.launches) == before
    assert DQ_SM90_FP32_KERNEL._fn is None and DKV_SM90_FP32_KERNEL._fn is None
    assert DQ_SM90_FP32_KERNEL.name != DKV_SM90_FP32_KERNEL.name
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention_bwd(q, kv, kv, out, lse[:, :, :3], out)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_bwd(q, torch.zeros(1, 5, 3, 32), torch.zeros(1, 5, 3, 32),
                            out, lse, out)
