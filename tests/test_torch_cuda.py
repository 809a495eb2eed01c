"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need a CUDA device (and ``nvcc``, which builds the
kernels at first use) and skip elsewhere.  Run them on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 in float32 (both sides accumulate in fp32; only the
summation order differs) and 2e-2 / 3e-2 in bfloat16 for flash / decode
(the outputs round to bf16, one ulp of which is 2^-8 relative).
"""

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.decode_attention import (KERNEL as DECODE,
                                                  decode_attention_fwd,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (KERNEL as FLASH,
                                                 flash_attention_fwd,
                                                 flash_attention_plain)

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

FLASH_CASES = [
    # (B, Sq, Skv, H, K, D, causal, dtype)
    (4, 512, 512, 16, 8, 128, True, torch.bfloat16),
    (2, 128, 128, 4, 2, 64, True, torch.float32),
    (1, 256, 256, 8, 8, 32, True, torch.bfloat16),
    (2, 128, 256, 4, 1, 64, False, torch.float32),
    (2, 13, 13, 16, 8, 128, True, torch.float32),
    (2, 13, 13, 16, 8, 128, True, torch.bfloat16),
    (1, 100, 37, 4, 2, 64, False, torch.float32),
    (1, 64, 128, 4, 2, 32, True, torch.float32),
    (1, 130, 70, 4, 4, 128, True, torch.float32),
]

DECODE_CASES = [
    # (B, S, H, K, D, cache_index, dtype)
    (4, 576, 16, 8, 128, 543, torch.bfloat16),
    (2, 128, 4, 2, 64, 100, torch.float32),
    (1, 512, 8, 8, 32, 511, torch.float32),
    (2, 256, 4, 1, 64, 7, torch.float32),
    (2, 24, 16, 8, 128, 11, torch.float32),
    (2, 24, 16, 8, 128, 11, torch.bfloat16),
    (1, 24, 4, 2, 128, 0, torch.float32),
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def _tol(dtype, bf16):
    return bf16 if dtype == torch.bfloat16 else 2e-5


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(case, device):
    B, Sq, Skv, H, K, D, causal, dt = case
    q = _randn((B, Sq, H, D), dt, device, 0)
    k = _randn((B, Skv, K, D), dt, device, 1)
    v = _randn((B, Skv, K, D), dt, device, 2)
    before = FLASH.launches
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FLASH.launches == before + 1
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    tol = _tol(dt, 2e-2)
    assert out.dtype == dt and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_matches_plain(case, device):
    B, S, H, K, D, ci, dt = case
    q = _randn((B, 1, H, D), dt, device, 3)
    kc = _randn((B, S, K, D), dt, device, 4)
    vc = _randn((B, S, K, D), dt, device, 5)
    before = DECODE.launches
    out = decode_attention_fwd(q, kc, vc, cache_index=ci)
    torch.cuda.synchronize()
    assert DECODE.launches == before + 1
    ref = decode_attention_plain(q, kc, vc, cache_index=ci)
    tol = _tol(dt, 3e-2)
    assert out.dtype == dt
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_decode_kernel_never_reads_past_cache_index(device):
    B, S, H, K, D, ci = 1, 128, 2, 2, 128, 50
    q = _randn((B, 1, H, D), torch.float32, device, 6)
    kc = _randn((B, S, K, D), torch.float32, device, 7)
    vc = _randn((B, S, K, D), torch.float32, device, 8)
    clean = decode_attention_fwd(q, kc, vc, cache_index=ci)
    kc[:, ci + 1:] = float("nan")
    vc[:, ci + 1:] = float("nan")
    dirty = decode_attention_fwd(q, kc, vc, cache_index=ci)
    torch.testing.assert_close(dirty, clean, atol=0.0, rtol=0.0)


def test_wrappers_raise_on_what_the_kernels_do_not_take(device):
    q = _randn((1, 8, 4, 128), torch.float16, device, 9)
    with pytest.raises(TypeError):
        flash_attention_fwd(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    q = _randn((1, 8, 4, 48), torch.float32, device, 9)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_fwd(q, q, q)
    q = _randn((1, 8, 4, 128), torch.float32, device, 9)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q, q.transpose(1, 2).contiguous().transpose(1, 2), q)
    with pytest.raises(NotImplementedError):
        kernels.flash_attention_dispatch(q, q, q, window=4)
