"""The port's plain attention versions against the JAX package's Pallas
kernels (interpret mode): flash prefill (out and lse) and flash decode.

Inputs are drawn with numpy and handed to both packages; bf16 cases round
the same fp32 draws to bf16 on both sides.  Tolerances: flash 2e-5 (fp32)
/ 2e-2 (bf16), decode 2e-5 / 3e-2 — the reference suites' own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import \
    decode_attention_fwd as jax_decode
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_fwd as jax_flash
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd

torch.set_num_threads(2)

F32, BF16 = "float32", "bfloat16"
_JNP = {F32: jnp.float32, BF16: jnp.bfloat16}
_TORCH = {F32: torch.float32, BF16: torch.bfloat16}

FLASH_CASES = [
    # (B, Sq, Skv, H, K, D, causal, dtype): the reference sweep ...
    (2, 128, 128, 4, 2, 64, True, F32),
    (1, 256, 256, 8, 8, 32, True, BF16),
    (2, 128, 256, 4, 1, 64, False, F32),
    (1, 512, 512, 2, 2, 128, True, F32),
    # ... ragged lengths (the reduced serve budget is 16 + 8 = 24) ...
    (2, 13, 13, 4, 2, 16, True, F32),
    (2, 24, 24, 4, 2, 32, True, BF16),
    # ... and causal Sq != Skv: the top-left mask k_pos <= q_pos
    (1, 64, 128, 4, 2, 32, True, F32),
]

DECODE_CASES = [
    # (B, S, H, K, D, cache_index, dtype): the reference sweep + ragged S
    (2, 128, 4, 2, 64, 100, F32),
    (1, 512, 8, 8, 32, 511, F32),
    (2, 256, 4, 1, 64, 7, F32),
    (1, 256, 8, 2, 128, 200, BF16),
    (2, 24, 4, 2, 16, 13, F32),
]


def _tol(dtype, bf16_tol):
    return bf16_tol if dtype == BF16 else 2e-5


def _pair(x, dtype):
    return jnp.asarray(x, _JNP[dtype]), torch.from_numpy(x).to(_TORCH[dtype])


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas(case):
    B, Sq, Skv, H, K, D, causal, dtype = case
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng.standard_normal((B, Sq, H, D), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((B, Skv, K, D), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((B, Skv, K, D), np.float32), dtype)
    out_j, lse_j = jax_flash(qj, kj, vj, causal=causal, interpret=True,
                             return_lse=True)
    out_t, lse_t = flash_attention_fwd(qt, kt, vt, causal=causal)
    assert out_t.dtype == _TORCH[dtype] and lse_t.dtype == torch.float32
    assert tuple(lse_t.shape) == (B, H, Sq)
    tol = _tol(dtype, 2e-2)
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_pallas(case):
    B, S, H, K, D, ci, dtype = case
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng.standard_normal((B, 1, H, D), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((B, S, K, D), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, K, D), np.float32), dtype)
    out_j = jax_decode(qj, kj, vj, cache_index=ci, interpret=True)
    out_t = decode_attention_fwd(qt, kt, vt, cache_index=ci)
    assert out_t.dtype == _TORCH[dtype]
    tol = _tol(dtype, 3e-2)
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), atol=tol, rtol=tol)


def test_decode_ignores_garbage_past_cache_index():
    """Entries past cache_index must not affect the output (999 garbage)."""
    B, S, H, K, D, ci = 1, 128, 2, 2, 32, 50
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, 1, H, D), np.float32)
    kc = rng.standard_normal((B, S, K, D), np.float32)
    vc = rng.standard_normal((B, S, K, D), np.float32)
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[:, ci + 1:] = 999.0
    vc2[:, ci + 1:] = -999.0
    clean = decode_attention_fwd(*map(torch.from_numpy, (q, kc, vc)),
                                 cache_index=ci)
    dirty = decode_attention_fwd(*map(torch.from_numpy, (q, kc2, vc2)),
                                 cache_index=ci)
    np.testing.assert_allclose(dirty.numpy(), clean.numpy(), atol=1e-6)
    ref = jax_decode(jnp.asarray(q), jnp.asarray(kc2), jnp.asarray(vc2),
                     cache_index=ci, interpret=True)
    np.testing.assert_allclose(dirty.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_wrappers_validate_inputs():
    q = torch.zeros(1, 4, 4, 32)
    kv = torch.zeros(1, 4, 3, 32)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_fwd(q, kv, kv)
    with pytest.raises(ValueError, match="cache_index"):
        decode_attention_fwd(torch.zeros(1, 1, 4, 32), torch.zeros(1, 8, 2, 32),
                             torch.zeros(1, 8, 2, 32), cache_index=8)


def test_cpu_calls_never_build_or_count_a_kernel():
    """The kernel modules import without nvcc and CPU tensors take the
    plain version: no library is loaded and no launch is counted."""
    for kernel in (flash_attention.KERNEL, decode_attention.KERNEL):
        before = kernel.launches
        if kernel is flash_attention.KERNEL:
            flash_attention_fwd(torch.ones(1, 3, 2, 32), torch.ones(1, 3, 2, 32),
                                torch.ones(1, 3, 2, 32))
        else:
            decode_attention_fwd(torch.ones(1, 1, 2, 32), torch.ones(1, 3, 2, 32),
                                 torch.ones(1, 3, 2, 32), cache_index=1)
        assert kernel.launches == before
        assert kernel._fn is None
        assert kernel.library_path().name.startswith(kernel.name + "-")


def test_kernels_build_inside_the_checkout():
    """Run from a source checkout, the libraries go to its ``build/``."""
    from pathlib import Path

    from repro_torch.kernels import build

    root = Path(__file__).resolve().parents[1]
    assert build.BUILD_DIR == root / "build" / "repro_torch_kernels"
