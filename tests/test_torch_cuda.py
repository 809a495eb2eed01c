"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need a CUDA device (and ``nvcc``, which builds the
kernels at first use) and skip elsewhere.  Run them on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 in float32 (both sides accumulate in fp32; only the
summation order differs; the fp32 flash forward multiplies on the tensor
cores as three tf32 products, which a CPU model of its arithmetic keeps
far inside 2e-5, tests/test_torch_flash_fp32_sm90.py).  The bf16 flash
forward is held element by
element to 2e-5 + 2^-7 |ref| (out) and 2e-5 (lse), the check of
chip_smoke.py: its products run on the tensor cores from bf16 operands
with fp32 sums and P split into two bf16 terms, so it differs from the
plain version by summation order and the one-ulp flip of a bf16 output.
Decode in bfloat16: 3e-2 (one bf16 ulp is 2^-8 relative).  The
backward kernels' gradients are sums of up to S G products of O(1) terms
in another order: 1e-4 absolute plus 1e-4 relative in float32 (the
Hopper fp32 pair multiplies as three tf32 products, which a CPU model of
its arithmetic keeps far inside 1e-4, tests/test_torch_flash_bwd_fp32_sm90.py);
in bfloat16 (the Hopper pair: bf16 operands, fp32 sums, P and dS split into
two bf16 terms) element by element 1e-4 + 2^-7 |ref|, chip_smoke.py's
check.
"""

import threading

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.decode_attention import (KERNEL as DECODE,
                                                  decode_attention_fwd,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (DKV_SM90_FP32_KERNEL,
                                                 DQ_SM90_FP32_KERNEL,
                                                 SM90_FP32_KERNEL as FLASH,
                                                 backward_kernels,
                                                 bwd_dq_launch,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_fwd,
                                                 flash_attention_plain,
                                                 forward_kernel)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two intra-op threads for each test of this file, the previous count
    afterwards (set per test, not at import: every xdist worker imports
    every test file)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


FLASH_SHAPES = [
    # (B, Sq, Skv, H, K, D, causal)
    (4, 512, 512, 16, 8, 128, True),
    (2, 128, 128, 4, 2, 64, True),
    (1, 256, 256, 8, 8, 32, True),
    (2, 128, 256, 4, 1, 64, False),
    (2, 13, 13, 16, 8, 128, True),
    (1, 100, 37, 4, 2, 64, False),
    (1, 64, 128, 4, 2, 32, True),
    (1, 130, 70, 4, 4, 128, True),
    (1, 1, 1, 2, 1, 64, True),
]
# every shape in both dtypes: bf16 goes to the Hopper bf16 kernel, fp32 to
# the Hopper fp32 one
FLASH_CASES = [shape + (dt,) for shape in FLASH_SHAPES
               for dt in (torch.float32, torch.bfloat16)]

# the head dims only the bf16 kernel takes, and whisper's shapes:
# (B, Sq, Skv, H, K, D, Dv, causal)
FLASH_BF16_SHAPES = [
    (4, 512, 512, 40, 40, 96, 64, True),  # minicpm3's MLA prefill
    (2, 13, 13, 40, 40, 96, 64, True),
    (1, 100, 37, 4, 2, 96, 64, False),
    (4, 512, 512, 32, 32, 96, 96, True),  # phi-3's prefill
    (4, 768, 768, 32, 32, 96, 96, True),  # with 256 patch embeddings
    (1, 13, 13, 32, 32, 96, 96, True),
    (2, 130, 70, 8, 4, 96, 96, True),  # two q-heads a block
    (4, 1500, 1500, 6, 6, 64, 64, False),  # whisper's encoder
    (4, 64, 1500, 6, 6, 64, 64, False),  # whisper's cross-attention
    (1, 13, 1500, 6, 6, 64, 64, False),
    (4, 64, 64, 6, 6, 64, 64, True),  # whisper's decoder self-attention
    (4, 13, 13, 6, 6, 64, 64, True),
]

# the fp32 kernels at D = 96: minicpm3's MLA (96, 64) and phi-3's (96, 96),
# at their serve and training shapes, ragged, Sq != Skv and G = 2;
# (B, Sq, Skv, H, K, D, Dv, causal)
FP32_D96_SHAPES = [
    (4, 512, 512, 40, 40, 96, 64, True),  # minicpm3's MLA
    (2, 13, 13, 40, 40, 96, 64, True),
    (1, 100, 37, 4, 2, 96, 64, False),
    (1, 64, 160, 4, 1, 96, 64, True),  # Sq < Skv
    (4, 512, 512, 32, 32, 96, 96, True),  # phi-3
    (4, 768, 768, 32, 32, 96, 96, True),  # with 256 patch embeddings
    (1, 13, 13, 32, 32, 96, 96, True),
    (2, 130, 70, 8, 4, 96, 96, True),  # G = 2
]

# the odd GQA groups of the MoE family at D = 128, one q-head a block:
# llama4-maverick H = 40, K = 8 (G = 5), arctic H = 56, K = 8 (G = 7);
# (B, Sq, Skv, H, K, D, Dv, causal)
FLASH_ODD_G_SHAPES = [
    (4, 512, 512, 40, 8, 128, 128, True),
    (4, 512, 512, 56, 8, 128, 128, True),
    (2, 13, 13, 40, 8, 128, 128, True),
    (2, 13, 13, 56, 8, 128, 128, True),
    (1, 100, 37, 56, 8, 128, 128, False),
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
    # the Hopper kernel's KV splits over a cluster: B = 1 and B = 4 at the
    # serve shape, cache_index 0 (one split) and S - 1, every head dim, G = 1,
    # 3 (a padded head in the block) and 16 (two blocks a kv-head)
    (1, 576, 16, 8, 128, 543, torch.bfloat16),
    (1, 576, 16, 8, 128, 543, torch.float32),
    (4, 576, 16, 8, 128, 543, torch.float32),
    (4, 576, 16, 8, 128, 0, torch.bfloat16),
    (4, 576, 16, 8, 128, 575, torch.bfloat16),
    (1, 96, 4, 2, 32, 95, torch.bfloat16),
    (2, 300, 8, 2, 64, 0, torch.float32),
    (2, 300, 8, 2, 64, 299, torch.bfloat16),
    (1, 2048, 8, 8, 32, 2047, torch.float32),
    (1, 64, 12, 4, 64, 40, torch.float32),
    (1, 130, 16, 1, 64, 129, torch.bfloat16),
    # D = 96 (phi-3): three elements a lane, strided by 32
    (4, 544, 32, 32, 96, 543, torch.bfloat16),
    (4, 544, 32, 32, 96, 543, torch.float32),
    (1, 24, 32, 32, 96, 11, torch.bfloat16),
    (2, 300, 16, 4, 96, 150, torch.float32),
    (1, 576, 8, 1, 96, 575, torch.bfloat16),
    # whisper's decoder self-attention: D = 64, G = 1, 128 slots
    (4, 128, 6, 6, 64, 127, torch.bfloat16),
    (4, 128, 6, 6, 64, 64, torch.bfloat16),
    (4, 24, 6, 6, 64, 11, torch.bfloat16),
    # the MoE family's odd GQA groups at D = 128: 5 (llama4) or 7 (arctic)
    # q-heads in a block of 8, the rest masked; 544 slots, ragged 24 slots
    (4, 544, 40, 8, 128, 543, torch.bfloat16),
    (4, 544, 56, 8, 128, 543, torch.bfloat16),
    (1, 544, 40, 8, 128, 543, torch.bfloat16),
    (1, 544, 56, 8, 128, 543, torch.bfloat16),
    (4, 24, 40, 8, 128, 11, torch.bfloat16),
    (4, 24, 56, 8, 128, 11, torch.bfloat16),
    (2, 544, 56, 8, 128, 300, torch.float32),
    (2, 24, 40, 8, 128, 11, torch.float32),
]


BWD_SHAPES = [
    # (B, Sq, Skv, H, K, D, causal)
    (4, 512, 512, 16, 8, 128, True),
    (2, 13, 13, 16, 8, 128, True),
    (2, 24, 24, 16, 8, 128, True),
    (2, 128, 128, 4, 2, 64, True),
    (1, 256, 256, 8, 8, 32, True),
    (2, 128, 256, 4, 1, 64, False),
    (1, 100, 37, 4, 2, 64, False),
    (1, 64, 128, 4, 2, 32, True),
    (1, 130, 70, 4, 4, 128, True),
    (2, 70, 70, 8, 2, 32, True),
    (1, 100, 100, 6, 2, 64, True),
    (1, 37, 130, 4, 1, 128, True),
]
# every shape in both dtypes: bf16 goes to the Hopper bf16 pair, fp32 to
# the Hopper fp32 one
BWD_CASES = [shape + (dt,) for shape in BWD_SHAPES
             for dt in (torch.float32, torch.bfloat16)]

# the head dims only the bf16 pair takes, and whisper's training shapes:
# (B, Sq, Skv, H, K, D, Dv, causal)
BWD_BF16_SHAPES = [
    (4, 512, 512, 40, 40, 96, 64, True),  # minicpm3's MLA
    (2, 13, 13, 40, 40, 96, 64, True),
    (1, 100, 37, 4, 2, 96, 64, False),
    (4, 512, 512, 32, 32, 96, 96, True),  # phi-3
    (4, 768, 768, 32, 32, 96, 96, True),  # with 256 patch embeddings
    (1, 13, 13, 32, 32, 96, 96, True),
    (2, 130, 70, 8, 4, 96, 96, True),  # two q-heads a dq block
    (4, 1500, 1500, 6, 6, 64, 64, False),  # whisper's encoder
    (4, 448, 1500, 6, 6, 64, 64, False),  # its cross-attention
    (1, 13, 1500, 6, 6, 64, 64, False),
    (4, 448, 448, 6, 6, 64, 64, True),  # its decoder self-attention
    (1, 37, 130, 6, 6, 64, 64, True),  # causal key tiles past the last query
    # the MoE family's odd groups, one q-head a dq block and an odd number
    # of dk/dv steps: llama4 (G = 5) and arctic (G = 7), full size and ragged
    (4, 512, 512, 40, 8, 128, 128, True),
    (2, 13, 13, 40, 8, 128, 128, True),
    (4, 512, 512, 56, 8, 128, 128, True),
    (2, 13, 13, 56, 8, 128, 128, True),
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


def _assert_elementwise(got, ref, rtol, atol=2e-5):
    """|got - ref| <= atol + rtol |ref| at every element."""
    diff = (got.float() - ref.float()).abs()
    worst = (diff / (atol + rtol * ref.float().abs())).max().item()
    assert worst <= 1.0, f"largest |err| / limit {worst:.3f}"


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(case, device):
    B, Sq, Skv, H, K, D, causal, dt = case
    q = _randn((B, Sq, H, D), dt, device, 0)
    k = _randn((B, Skv, K, D), dt, device, 1)
    v = _randn((B, Skv, K, D), dt, device, 2)
    kern, other = forward_kernel(dt), forward_kernel(
        torch.float32 if dt == torch.bfloat16 else torch.bfloat16)
    before, other_before = kern.launches, other.launches
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (kern.launches, other.launches) == (before + 1, other_before)
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    assert out.dtype == dt and lse.dtype == torch.float32
    if dt == torch.bfloat16:
        _assert_elementwise(out, ref, 2.0 ** -7)
        _assert_elementwise(lse, ref_lse, 0.0)
    else:
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", FLASH_BF16_SHAPES)
def test_bf16_flash_kernel_at_mla_phi3_and_whisper_shapes(case, device):
    """D = 96 with Dv = 64 and 96 (MLA, phi-3), and whisper's non-causal
    encoder and Sq != Skv cross-attention and its causal decoder, held
    element by element as the bf16 cases above."""
    _check_bf16_flash(case, device)


@pytest.mark.parametrize("case", FLASH_ODD_G_SHAPES)
def test_bf16_flash_kernel_at_odd_gqa_groups(case, device):
    """G = 5 and 7 (llama4-maverick, arctic) at D = 128, serve and ragged
    sizes: the one-warpgroup launch, each q-head reading kv-head h K / H,
    held element by element as the bf16 cases above."""
    _check_bf16_flash(case, device)


def _check_bf16_flash(case, device):
    B, Sq, Skv, H, K, D, Dv, causal = case
    q = _randn((B, Sq, H, D), torch.bfloat16, device, 0)
    k = _randn((B, Skv, K, D), torch.bfloat16, device, 1)
    v = _randn((B, Skv, K, Dv), torch.bfloat16, device, 2)
    kern = forward_kernel(torch.bfloat16)
    before = kern.launches
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    assert tuple(out.shape) == (B, Sq, H, Dv)
    _assert_elementwise(out, ref, 2.0 ** -7)
    _assert_elementwise(lse, ref_lse, 0.0)


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


def _decode_inputs(B, S, H, K, D, dt, device, seed=0):
    return (_randn((B, 1, H, D), dt, device, seed),
            _randn((B, S, K, D), dt, device, seed + 1),
            _randn((B, S, K, D), dt, device, seed + 2))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_decode_kernel_is_deterministic(dt, device):
    """The splits merge rank by rank in a fixed order, with no atomics: a
    second launch gives the same bits."""
    q, kc, vc = _decode_inputs(4, 576, 16, 8, 128, dt, device, 20)
    first = decode_attention_fwd(q, kc, vc, cache_index=543)
    again = decode_attention_fwd(q, kc, vc, cache_index=543)
    assert torch.equal(first, again)


def test_decode_kernel_on_two_streams_at_once(device):
    """Two services decode on their own streams at once: the kernel keeps
    nothing in global memory between blocks, so each stream's results equal
    the same calls made one after the other."""
    calls = [_decode_inputs(4, 576, 16, 8, 128, torch.bfloat16, device, 30 + 3 * i)
             for i in range(2)]
    want = [decode_attention_fwd(*c, cache_index=543 - 100 * i)
            for i, c in enumerate(calls)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in calls]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(20):
        for i, (s, c) in enumerate(zip(streams, calls)):
            with torch.cuda.stream(s):
                got[i].append(decode_attention_fwd(*c, cache_index=543 - 100 * i))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(g, want[i]) for g in got[i])


def test_decode_kernel_refuses_a_misaligned_cache(device):
    q, kc, vc = _decode_inputs(1, 32, 4, 2, 64, torch.float32, device, 40)
    flat = torch.empty(kc.numel() + 1, device=device)
    shifted = flat[1:].view(kc.shape)  # contiguous, 4 bytes past a boundary
    shifted.copy_(kc)
    with pytest.raises(ValueError, match="16-byte"):
        decode_attention_fwd(q, shifted, vc, cache_index=20)


def _kernel_splits(B, H, K, cache_index, sms):
    """The split rule of csrc/decode_attention_sm90.cu on a card of ``sms``
    SMs (modelled and tested on the CPU in tests/test_torch_decode_sm90.py)."""
    G = H // K
    per_block = 1 if G <= 1 else 2 if G <= 2 else 4 if G <= 4 else 8
    splits = min(-(-2 * sms // (B * K * -(-G // per_block))), 8, (cache_index + 1) // 32)
    return max(splits, 1)


def test_decode_kernel_splits_follow_the_rule(device):
    import ctypes

    decode_attention_fwd(*_decode_inputs(1, 8, 2, 1, 32, torch.float32, device),
                         cache_index=3)  # builds and loads the library
    fn = ctypes.CDLL(str(DECODE.library_path())).repro_decode_attention_fwd_splits
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for B, H, K in ((1, 16, 8), (4, 16, 8), (2, 32, 8), (3, 12, 4), (1, 16, 1)):
        for ci in range(0, 1200, 13):
            assert fn(B, H, K, ci) == _kernel_splits(B, H, K, ci, sms), (B, H, K, ci)
    assert fn(4, 16, 8, 543) == 8


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


def test_windowed_dispatch_runs_the_plain_windowed_path(device):
    """A windowed call (jamba's attention at long context) has no kernel:
    on the card the dispatch runs ``chunked_attention`` (prefill and
    training) and ``decode_attention_xla`` (decode), as the reference
    sends windowed calls to its non-Pallas path, and counts no launch.
    An unwindowed call still launches its kernel."""
    from repro_torch.models.attention import chunked_attention, decode_attention_xla

    q = _randn((2, 40, 8, 128), torch.bfloat16, device, 9)
    k = _randn((2, 40, 2, 128), torch.bfloat16, device, 10)
    v = _randn((2, 40, 2, 128), torch.bfloat16, device, 11)
    before = {kern.name: kern.launches for kern in kernels.KERNELS}
    ref = chunked_attention(q, k, v, causal=True, window=16)
    for call in (kernels.flash_attention_dispatch, kernels.flash_attention_train_dispatch):
        assert torch.equal(call(q, k, v, causal=True, window=16), ref)
    qd = q[:, :1]
    got = kernels.decode_attention_dispatch(qd, k, v, cache_index=30, window=16)
    assert torch.equal(got, decode_attention_xla(qd, k, v, cache_index=30, window=16))
    assert {kern.name: kern.launches for kern in kernels.KERNELS} == before
    assert not torch.equal(ref, chunked_attention(q, k, v, causal=True))  # it bites
    flash = forward_kernel(torch.bfloat16)
    kernels.flash_attention_dispatch(q, k, v, causal=True)
    assert flash.launches == before[flash.name] + 1


def test_bf16_flash_raises_on_a_head_dim_it_does_not_take(device):
    q = _randn((1, 8, 4, 80), torch.bfloat16, device, 9)
    before = forward_kernel(torch.bfloat16).launches
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_fwd(q, q, q)
    q = _randn((1, 8, 4, 64), torch.bfloat16, device, 9)
    v = _randn((1, 8, 4, 96), torch.bfloat16, device, 10)
    with pytest.raises(ValueError, match="D=64, Dv=96"):
        flash_attention_fwd(q, q, v)
    assert forward_kernel(torch.bfloat16).launches == before


def test_bf16_flash_raises_on_inputs_tma_cannot_read(device):
    """A contiguous view that starts 2 bytes into its storage."""
    q = _randn((1 + 8 * 4 * 64,), torch.bfloat16, device, 9)[1:].view(1, 8, 4, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    k = _randn((1, 8, 4, 64), torch.bfloat16, device, 10)
    before = forward_kernel(torch.bfloat16).launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_fwd(q, k, k)
    assert forward_kernel(torch.bfloat16).launches == before


def _tf32(x):
    """x with its low 13 mantissa bits cleared: what tf32 keeps."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def test_fp32_flash_keeps_what_lies_below_tf32(device):
    """Inputs that differ only below tf32's mantissa (x and its tf32 part)
    give outputs that differ far beyond 2e-5; the kernel holds each to the
    plain version, so it drops no lo term and reads no raw fp32 bits as
    other than its split."""
    B, S, H, K, D = 1, 256, 4, 2, 128
    full = [_randn(shape, torch.float32, device, seed) for shape, seed in
            (((B, S, H, D), 14), ((B, S, K, D), 15), ((B, S, K, D), 16))]
    hi = [_tf32(x) for x in full]
    refs = [flash_attention_plain(*inputs, causal=True) for inputs in (full, hi)]
    assert ((refs[0][0] - refs[1][0]).abs() > 2e-5).sum().item() > 10_000
    before = FLASH.launches
    for inputs, (ref, ref_lse) in zip((full, hi), refs):
        out, lse = flash_attention_fwd(*inputs, causal=True)
        torch.cuda.synchronize()
        _assert_elementwise(out, ref, 0.0)
        _assert_elementwise(lse, ref_lse, 0.0)
    assert FLASH.launches == before + 2


def test_fp32_bwd_keeps_what_lies_below_tf32(device):
    """The same for the fp32 backward pair: inputs that differ only below
    tf32's mantissa give gradients that differ far beyond 1e-4; the pair
    holds each to the plain backward, so no product drops a lo term."""
    case = (1, 256, 256, 4, 2, 128, True, torch.float32)
    full = list(_bwd_inputs(case, device))  # q, k, v, out, lse, g
    hi = [_tf32(t) for t in full[:3]] + [None, None, _tf32(full[5])]
    hi[3], hi[4] = flash_attention_plain(*hi[:3], causal=True)
    hi[3] = hi[3].contiguous()
    refs = [flash_attention_bwd_plain(*inputs, causal=True) for inputs in (full, hi)]
    assert all(((a - b).abs() > 1e-4).sum().item() > 1000 for a, b in zip(*refs))
    pair = backward_kernels(torch.float32)
    before = [kern.launches for kern in pair]
    for inputs, ref in zip((full, hi), refs):
        got = flash_attention_bwd(*inputs, causal=True)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            _assert_elementwise(a, b, 0.0, atol=1e-4)
    assert [kern.launches for kern in pair] == [n + 2 for n in before]


def test_fp32_flash_raises_on_a_head_dim_it_does_not_take(device):
    """(96, 32), D = 16 (the reduced test configs') and D = 80: none is
    taken, none launches."""
    before = FLASH.launches
    for D, Dv in ((96, 32), (16, 16), (80, 80)):
        q = _randn((1, 8, 4, D), torch.float32, device, 9)
        v = _randn((1, 8, 4, Dv), torch.float32, device, 10)
        with pytest.raises(ValueError, match=f"head dims D={D}, Dv={Dv}"):
            flash_attention_fwd(q, q, v)
    assert FLASH.launches == before


@pytest.mark.parametrize("case", FP32_D96_SHAPES)
def test_fp32_flash_kernel_at_d96(case, device):
    """The fp32 forward at (96, 64) and (96, 96): three 128-byte atoms a
    row of Q and K, V and O 64 or 96 wide (O summed in two parts of 48 at
    96), held to the plain version as the fp32 cases above."""
    B, Sq, Skv, H, K, D, Dv, causal = case
    q = _randn((B, Sq, H, D), torch.float32, device, 0)
    k = _randn((B, Skv, K, D), torch.float32, device, 1)
    v = _randn((B, Skv, K, Dv), torch.float32, device, 2)
    other = forward_kernel(torch.bfloat16)
    before = (FLASH.launches, other.launches)
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (FLASH.launches, other.launches) == (before[0] + 1, before[1])
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    assert tuple(out.shape) == (B, Sq, H, Dv) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)


def test_fp32_flash_raises_on_inputs_tma_cannot_read(device):
    """A contiguous view that starts 4 bytes into its storage."""
    q = _randn((1 + 8 * 4 * 64,), torch.float32, device, 9)[1:].view(1, 8, 4, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    k = _randn((1, 8, 4, 64), torch.float32, device, 10)
    before = FLASH.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_fwd(k, k, q)
    assert FLASH.launches == before


def _bwd_inputs(case, device):
    B, Sq, Skv, H, K, D, causal, dt = case
    q = _randn((B, Sq, H, D), dt, device, 10)
    k = _randn((B, Skv, K, D), dt, device, 11)
    v = _randn((B, Skv, K, D), dt, device, 12)
    g = _randn((B, Sq, H, D), dt, device, 13)
    out, lse = flash_attention_plain(q, k, v, causal=causal)
    return q, k, v, out.contiguous(), lse, g


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_kernels_match_plain(case, device):
    causal, dt = case[6], case[7]
    q, k, v, out, lse, g = _bwd_inputs(case, device)
    other = torch.float32 if dt == torch.bfloat16 else torch.bfloat16
    kerns = backward_kernels(dt) + backward_kernels(other)
    before = [kern.launches for kern in kerns]
    got = flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    assert [kern.launches for kern in kerns] == [n + (i < 2) for i, n in enumerate(before)]
    ref = flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dt and a.shape == b.shape, name
        if dt == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=name)
        else:
            _assert_elementwise(a, b, 2.0 ** -7, atol=1e-4)


@pytest.mark.parametrize("case", [(4, 512, 512, 16, 8, 128, True, torch.bfloat16),
                                  (1, 100, 100, 6, 2, 64, True, torch.bfloat16),
                                  (4, 512, 512, 16, 8, 128, True, torch.float32)])
def test_flash_dkv_kernel_is_deterministic(case, device):
    """No atomics: two launches of the dtype's pair give the same bits."""
    q, k, v, out, lse, g = _bwd_inputs(case, device)
    kerns = backward_kernels(case[-1])
    before = [kern.launches for kern in kerns]
    first = flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    second = flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    assert [kern.launches for kern in kerns] == [n + 2 for n in before]
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [(4, 512, 512, 16, 8, 128, True, torch.float32),
                                  (1, 100, 100, 6, 2, 64, True, torch.float32),
                                  (4, 512, 512, 16, 8, 128, True, torch.bfloat16)])
def test_flash_dq_kernel_is_deterministic(case, device):
    """No atomics: two launches of the dtype's dq kernel alone give the
    same dq and Dvec bits."""
    q, k, v, out, lse, g = _bwd_inputs(case, device)
    kern = backward_kernels(case[-1])[0]
    before = kern.launches
    first = bwd_dq_launch(q, k, v, out, lse, g, causal=True)
    second = bwd_dq_launch(q, k, v, out, lse, g, causal=True)
    assert kern.launches == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bf16_bwd_raises_on_a_head_dim_it_does_not_take(device):
    q = _randn((1, 8, 4, 80), torch.bfloat16, device, 9)
    kv = _randn((1, 8, 2, 80), torch.bfloat16, device, 10)
    lse = torch.zeros((1, 4, 8), device=device)
    before = [kern.launches for kern in backward_kernels(torch.bfloat16)]
    with pytest.raises(ValueError, match="D=80, Dv=80"):
        flash_attention_bwd(q, kv, kv, q, lse, q)
    assert [kern.launches for kern in backward_kernels(torch.bfloat16)] == before


def _bwd_inputs_dv(case, device):
    """bf16 q, k, v (Dv wide), the forward's (out, lse) and dO (Dv wide)."""
    B, Sq, Skv, H, K, D, Dv, causal = case
    q = _randn((B, Sq, H, D), torch.bfloat16, device, 10)
    k = _randn((B, Skv, K, D), torch.bfloat16, device, 11)
    v = _randn((B, Skv, K, Dv), torch.bfloat16, device, 12)
    g = _randn((B, Sq, H, Dv), torch.bfloat16, device, 13)
    out, lse = flash_attention_plain(q, k, v, causal=causal)
    return q, k, v, out.contiguous(), lse, g


@pytest.mark.parametrize("case", BWD_BF16_SHAPES)
def test_bf16_bwd_kernels_at_mla_phi3_and_whisper_shapes(case, device):
    """D = 96 with Dv = 64 and 96 (MLA, phi-3), whisper's non-causal
    Sq != Skv shapes and the MoE family's G = 5 and 7, held element by
    element as the bf16 cases above; a second launch gives the same
    bits."""
    causal = case[-1]
    q, k, v, out, lse, g = _bwd_inputs_dv(case, device)
    kerns = backward_kernels(torch.bfloat16) + backward_kernels(torch.float32)
    before = [kern.launches for kern in kerns]
    got = flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    assert [kern.launches for kern in kerns] == [n + (i < 2) for i, n in enumerate(before)]
    ref = flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
    for name, a, b, like in zip(("dq", "dk", "dv"), got, ref, (q, k, v)):
        assert a.shape == like.shape and a.dtype == torch.bfloat16, name
        _assert_elementwise(a, b, 2.0 ** -7, atol=1e-4)
    again = flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D, Dv", [(96, 32), (16, 16), (64, 96)])
def test_fp32_entries_return_an_error_outside_the_rule(D, Dv, device):
    """Below the wrappers' check, each fp32 library's C entry refuses a
    (D, Dv) it has no instantiation for, at its untuned tiles: it returns
    cudaErrorInvalidValue (1) and launches nothing."""
    p = torch.zeros(64, device=device).data_ptr()
    stream = torch.cuda.current_stream(device).cuda_stream
    assert FLASH._loaded()(p, p, p, p, p, 1, 8, 8, 4, 2, D, Dv, 1, 64, 32, stream) == 1
    for kern, tiles in zip(backward_kernels(torch.float32), ((64, 32), (64, 16))):
        assert kern._loaded()(*[p] * 8, 1, 8, 8, 4, 2, D, Dv, 1, *tiles, stream) == 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", FP32_D96_SHAPES)
def test_fp32_bwd_kernels_at_d96(case, device):
    """The fp32 pair at (96, 64) and (96, 96): dQ summed in two parts of 48
    at D = 96, dK and dV one half of D or Dv a warpgroup (n48 at 96), Q^T
    and dO^T transposed at 96 and 64 rows; held to the plain backward as the
    fp32 cases above, a second launch bit-identical."""
    B, Sq, Skv, H, K, D, Dv, causal = case
    q = _randn((B, Sq, H, D), torch.float32, device, 10)
    k = _randn((B, Skv, K, D), torch.float32, device, 11)
    v = _randn((B, Skv, K, Dv), torch.float32, device, 12)
    g = _randn((B, Sq, H, Dv), torch.float32, device, 13)
    out, lse = flash_attention_plain(q, k, v, causal=causal)
    out = out.contiguous()
    kerns = backward_kernels(torch.float32) + backward_kernels(torch.bfloat16)
    before = [kern.launches for kern in kerns]
    got = flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    assert [kern.launches for kern in kerns] == [n + (i < 2) for i, n in enumerate(before)]
    ref = flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
    for name, a, b, like in zip(("dq", "dk", "dv"), got, ref, (q, k, v)):
        assert a.shape == like.shape and a.dtype == torch.float32, name
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=name)
    again = flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D, Dv", [(96, 32), (64, 96), (16, 16)])
def test_fp32_bwd_raises_at_head_dims_only_bf16_takes(D, Dv, device):
    """Head dims the fp32 pair does not take (nor, now that both take
    (96, 96) and (96, 64), the bf16 pair): it raises, launching nothing."""
    q = _randn((1, 8, 4, D), torch.float32, device, 9)
    k = _randn((1, 8, 2, D), torch.float32, device, 10)
    v = _randn((1, 8, 2, Dv), torch.float32, device, 11)
    g = _randn((1, 8, 4, Dv), torch.float32, device, 12)
    lse = torch.zeros((1, 4, 8), device=device)
    kerns = backward_kernels(torch.float32) + backward_kernels(torch.bfloat16)
    before = [kern.launches for kern in kerns]
    with pytest.raises(ValueError, match=f"D={D}, Dv={Dv} in float32"):
        flash_attention_bwd(q, k, v, g, lse, g)
    assert [kern.launches for kern in kerns] == before


@pytest.mark.parametrize("which", range(5))
def test_bf16_bwd_raises_on_inputs_tma_cannot_read(which, device):
    """q, k, v, out or dO as a contiguous view 2 bytes into its storage."""
    case = (1, 8, 8, 4, 2, 64, True, torch.bfloat16)
    args = list(_bwd_inputs(case, device))  # q, k, v, out, lse, g
    slot = (0, 1, 2, 3, 5)[which]
    t = args[slot]
    shifted = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)[1:].view(t.shape)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    args[slot] = shifted
    kerns = backward_kernels(torch.bfloat16) + backward_kernels(torch.float32)
    before = [kern.launches for kern in kerns]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(*args, causal=True)
    assert [kern.launches for kern in kerns] == before


@pytest.mark.parametrize("which", range(5))
def test_fp32_bwd_raises_on_inputs_tma_cannot_read(which, device):
    """q, k, v, out or dO as a contiguous fp32 view 4 bytes into its
    storage: the fp32 pair reads them by TMA too."""
    case = (1, 8, 8, 4, 2, 64, True, torch.float32)
    args = list(_bwd_inputs(case, device))  # q, k, v, out, lse, g
    slot = (0, 1, 2, 3, 5)[which]
    t = args[slot]
    shifted = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)[1:].view(t.shape)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    args[slot] = shifted
    kerns = backward_kernels(torch.bfloat16) + backward_kernels(torch.float32)
    before = [kern.launches for kern in kerns]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(*args, causal=True)
    assert [kern.launches for kern in kerns] == before


def test_train_attention_grads_through_the_kernels(device):
    """The autograd rule of ``DISPATCH.train`` launches the forward and
    both backward kernels and agrees with ``PLAIN.train``."""
    case = (2, 96, 96, 8, 4, 64, True, torch.float32)
    q, k, v, _, _, g = _bwd_inputs(case, device)
    pair = (DQ_SM90_FP32_KERNEL, DKV_SM90_FP32_KERNEL)
    before = (FLASH.launches,) + tuple(kern.launches for kern in pair)
    grads = {}
    for name, ops in (("kernels", kernels.DISPATCH), ("plain", kernels.PLAIN)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops.train(*leaves, causal=True, window=None)
        grads[name] = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (FLASH.launches,) + tuple(kern.launches for kern in pair) == \
        tuple(n + 1 for n in before)
    for a, b in zip(grads["kernels"], grads["plain"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_tma_kernels_launch_as_a_fresh_threads_first_cuda_call(dt, device):
    """A thread whose first CUDA call is a kernel's launch (an autograd
    worker, whose tensors come from the caching allocator) has no current
    context until a runtime call binds one; the kernels' tensor maps are
    made all the same (sm90.cuh's make_map binds it), so the forward and
    the backward pair launch there and agree with the plain versions."""
    case = (2, 96, 96, 8, 4, 64, True, dt)
    q, k, v, _, _, g = _bwd_inputs(case, device)
    got = {}

    def run():
        try:
            out, lse = flash_attention_fwd(q, k, v, causal=True)
            got["fwd"] = (out, lse)
            got["bwd"] = flash_attention_bwd(q, k, v, out, lse, g, causal=True)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - handed to the test's thread
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=300)
    assert not thread.is_alive()
    assert "error" not in got, got.get("error")
    out, lse = got["fwd"]
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal=True)
    _assert_elementwise(out, ref_out, _tol(dt, 2.0 ** -7))
    _assert_elementwise(lse, ref_lse, 0.0)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, g, causal=True)
    for a, b in zip(got["bwd"], ref):
        if dt == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        else:
            _assert_elementwise(a, b, 2.0 ** -7, atol=1e-4)


def test_moe_training_step_with_remat_gives_the_gradients_without(device):
    """One training step of a small bf16 llama4-shaped model on the card
    (the MoE configs' pattern at 2 repeats, d_model 256, G = 5 over
    head_dim 64, 8 experts): with ``remat`` every flash forward launches
    twice (the recompute), dq and dk/dv once an attention layer; the loss
    and every gradient equal ``remat=False``'s, bit for bit or within 1e-6
    of each parameter's gradient norm."""
    import dataclasses

    import repro_torch.configs as cfgs
    from repro_torch.kernels.flash_attention import SM90_KERNEL
    from repro_torch.models import build
    from repro_torch.runtime.train_loop import loss_and_grads

    full = cfgs.get("llama4_maverick_400b_a17b")
    cfg = cfgs.reduced(full).replace(
        d_model=256, n_heads=10, n_kv_heads=2, head_dim=64, d_ff=512,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        moe=dataclasses.replace(full.moe, n_experts=8, dense_residual_ff=512))
    tokens = torch.randint(0, cfg.vocab_size, (2, 256),
                           generator=torch.Generator().manual_seed(3)).to(device)
    batch = {"tokens": tokens, "targets": tokens.roll(1, 1)}
    pair = backward_kernels(torch.bfloat16)
    runs = {}
    for remat in (False, True):
        api = build(cfg.replace(remat=remat))
        model = api.init(torch.Generator(device=device).manual_seed(0))
        model.requires_grad_(True)
        before = [kern.launches for kern in (SM90_KERNEL,) + pair]
        loss, _, grads = loss_and_grads(api, model, batch)
        torch.cuda.synchronize()
        launches = [kern.launches - n for kern, n in zip((SM90_KERNEL,) + pair, before)]
        assert launches == [cfg.n_layers * (2 if remat else 1)] + [cfg.n_layers] * 2
        runs[remat] = (loss, grads)
    assert torch.isfinite(runs[True][0])
    assert torch.equal(runs[True][0], runs[False][0])
    for name, g in runs[False][1].items():
        d = (runs[True][1][name].float() - g.float()).norm()
        assert d <= 1e-6 * g.float().norm(), name



# ---------------- the tuning space's candidates on the card ----------- #
# (family, backend, dtype, shape) as chip_smoke.py's TUNE_SWEEPS; each
# candidate the space admits is held to the plain version, as today's
# tiles are.
TUNE_FLASH = [("G=2", {"B": 4, "Sq": 512, "Skv": 512, "H": 16, "K": 8, "D": 128, "Dv": 128}),
              ("G=5", {"B": 4, "Sq": 512, "Skv": 512, "H": 40, "K": 8, "D": 128, "Dv": 128}),
              ("D=64 ragged", {"B": 2, "Sq": 200, "Skv": 70, "H": 4, "K": 4, "D": 64,
                               "Dv": 64}),
              ("(96, 64)", {"B": 1, "Sq": 130, "Skv": 130, "H": 8, "K": 8, "D": 96, "Dv": 64})]


@pytest.mark.parametrize("label, shape", TUNE_FLASH)
@pytest.mark.parametrize("causal", [True, False])
def test_every_flash_candidate_matches_plain(label, shape, causal, device):
    from repro_torch.tune import search_space

    bf = torch.bfloat16
    q = _randn((shape["B"], shape["Sq"], shape["H"], shape["D"]), bf, device, 41)
    k = _randn((shape["B"], shape["Skv"], shape["K"], shape["D"]), bf, device, 42)
    v = _randn((shape["B"], shape["Skv"], shape["K"], shape["Dv"]), bf, device, 43)
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    cands, _ = search_space("flash_fwd", shape, "bfloat16")
    assert cands
    for c in cands:
        out, lse = flash_attention_fwd(q, k, v, causal=causal, **c)
        _assert_elementwise(out, ref, 2.0 ** -7)
        _assert_elementwise(lse, ref_lse, 0.0)


@pytest.mark.parametrize("B, ci", [(4, 575), (1, 575), (4, 40), (2, 11)])
def test_every_decode_split_count_matches_plain(B, ci, device):
    from repro_torch.tune import search_space

    q, kc, vc = _decode_inputs(B, 576, 16, 8, 128, torch.bfloat16, device, 44)
    ref = decode_attention_plain(q, kc, vc, cache_index=ci)
    shape = {"B": B, "S": 576, "H": 16, "K": 8, "D": 128, "Dv": 128}
    for c in search_space("decode", shape, "bfloat16")[0]:
        got = decode_attention_fwd(q, kc, vc, cache_index=ci, **c)
        torch.testing.assert_close(got.float(), ref.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("n, lanes", [(16, 1), (16, 2), (16, 4), (8, 4), (4, 2), (32, 2)])
def test_every_scan_lane_count_matches_plain(n, lanes, device):
    from repro_torch.kernels.mamba_scan import mamba_scan_fwd, mamba_scan_plain

    g = torch.Generator(device=device).manual_seed(45)
    b, s, d = 2, 77, 300
    x = torch.randn((b, s, d), generator=g, device=device)
    dt = torch.nn.functional.softplus(torch.randn((b, s, d), generator=g, device=device))
    A = -torch.exp(torch.randn((d, n), generator=g, device=device) * 0.5)
    B_ = torch.randn((b, s, n), generator=g, device=device)
    C_ = torch.randn((b, s, n), generator=g, device=device)
    got = mamba_scan_fwd(x, dt, A, B_, C_, lanes=lanes)
    ref = mamba_scan_plain(x, dt, A, B_, C_)
    for a, r in zip(got, ref):
        _assert_elementwise(a, r, 1e-4, 1e-4)


def test_a_refused_config_raises_by_name(device):
    """A tile the kernel is not built for raises KernelConfigError naming
    it, from an argument and from a cache entry, and launches nothing;
    decode's and the scan's out-of-range counts too."""
    from repro_torch.kernels import mamba_scan as scan
    from repro_torch.tune import KernelConfigError, TuningCache, set_cache

    bf = torch.bfloat16
    shape = {"B": 4, "Sq": 512, "Skv": 512, "H": 16, "K": 8, "D": 128, "Dv": 128}
    q = _randn((4, 512, 16, 128), bf, device, 46)
    k = _randn((4, 512, 8, 128), bf, device, 47)
    flash_kernel = forward_kernel(bf)
    before = (flash_kernel.launches, DECODE.launches, scan.KERNEL.launches)
    with pytest.raises(KernelConfigError, match="block_q"):
        flash_attention_fwd(q, k, k, block_q=128, block_k=64)
    with pytest.raises(KernelConfigError, match="splits=16"):
        decode_attention_fwd(q[:, :1].contiguous(), k, k, cache_index=500, splits=16)
    x = _randn((2, 8, 16), torch.float32, device, 48)
    A = -_randn((16, 16), torch.float32, device, 51).abs()
    with pytest.raises(KernelConfigError, match="lanes=3"):
        scan.mamba_scan_fwd(x, x.abs(), A, x, x, lanes=3)
    cache = TuningCache()
    cache.put("flash_fwd", shape, "bfloat16", "cuda", {"block_q": 128, "block_k": 64}, 1.0,
              save=False)
    prev = set_cache(cache)
    try:
        with pytest.raises(KernelConfigError, match="'block_q': 128"):
            flash_attention_fwd(q, k, k)
    finally:
        set_cache(prev)
    assert (flash_kernel.launches, DECODE.launches, scan.KERNEL.launches) == before


def test_a_cache_entry_changes_what_launches(device):
    """The wrapper reads the cache on a call with no tiles: a cached 128-key
    tile runs (the library's smem query says it is built), within the
    element check, and the cache counts the hit."""
    from repro_torch.tune import TuningCache, set_cache

    bf = torch.bfloat16
    shape = {"B": 4, "Sq": 512, "Skv": 512, "H": 16, "K": 8, "D": 128, "Dv": 128}
    q = _randn((4, 512, 16, 128), bf, device, 49)
    k = _randn((4, 512, 8, 128), bf, device, 50)
    ref, _ = flash_attention_plain(q, k, k)
    cache = TuningCache()
    cache.put("flash_fwd", shape, "bfloat16", "cuda", {"block_q": 64, "block_k": 128}, 1.0,
              save=False)
    prev = set_cache(cache)
    try:
        out, _ = flash_attention_fwd(q, k, k)
    finally:
        set_cache(prev)
    assert cache.hits == 1
    _assert_elementwise(out, ref, 2.0 ** -7)
    tuned = flash_attention_fwd(q, k, k, block_q=64, block_k=128)[0]
    assert torch.equal(out, tuned)


# ---------------- the fp32 forward's and the pairs' tiles ------------- #
# Every candidate of the fp32 ``flash_fwd`` space and of both ``flash_bwd``
# spaces at the sweeps' shapes (chip_smoke.py's TUNE_SWEEPS) and ragged
# ones, held to the plain versions with the checks above; the untuned
# call bit-identical to an explicit call at the untuned tiles.
TUNE_TILES = [("qwen3", {"B": 4, "Sq": 512, "Skv": 512, "H": 16, "K": 8, "D": 128, "Dv": 128}),
              ("minicpm3", {"B": 1, "Sq": 512, "Skv": 512, "H": 40, "K": 40, "D": 96,
                            "Dv": 64}),
              ("G=5 ragged", {"B": 1, "Sq": 200, "Skv": 200, "H": 10, "K": 2, "D": 128,
                              "Dv": 128}),
              ("D=64 ragged", {"B": 2, "Sq": 130, "Skv": 70, "H": 4, "K": 4, "D": 64,
                               "Dv": 64}),
              ("D=32 short", {"B": 2, "Sq": 13, "Skv": 13, "H": 4, "K": 2, "D": 32,
                              "Dv": 32})]


def _tile_inputs(shape, dt, device, seed):
    B, Sq, Skv, H, K = (shape[n] for n in ("B", "Sq", "Skv", "H", "K"))
    q = _randn((B, Sq, H, shape["D"]), dt, device, seed)
    k = _randn((B, Skv, K, shape["D"]), dt, device, seed + 1)
    v = _randn((B, Skv, K, shape["Dv"]), dt, device, seed + 2)
    g = _randn((B, Sq, H, shape["Dv"]), dt, device, seed + 3)
    return q, k, v, g


@pytest.mark.parametrize("label, shape", TUNE_TILES)
@pytest.mark.parametrize("causal", [True, False])
def test_every_fp32_flash_candidate_matches_plain(label, shape, causal, device):
    from repro_torch.tune import search_space

    q, k, v, _ = _tile_inputs(shape, torch.float32, device, 52)
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    cands, _ = search_space("flash_fwd", shape, "float32")
    assert len(cands) >= 2
    untuned = flash_attention_fwd(q, k, v, causal=causal)
    for c in cands:
        before = FLASH.launches
        out, lse = flash_attention_fwd(q, k, v, causal=causal, **c)
        assert FLASH.launches == before + 1
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=0, msg=f"{label} {c}")
        torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=0, msg=f"{label} {c}")
        if c == {"block_q": 64, "block_k": 32}:
            assert all(torch.equal(a, b) for a, b in zip(untuned, (out, lse)))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("label, shape", TUNE_TILES)
@pytest.mark.parametrize("causal", [True, False])
def test_every_bwd_candidate_matches_plain(dt, label, shape, causal, device):
    """Every candidate of the pair's space: dq, dk, dv within phase 5's
    check, one launch of each kernel; dk/dv bit-identical on a second
    launch (no atomics, a fixed order); the untuned call bit-identical to
    an explicit one at the untuned tiles."""
    from repro_torch.tune import default_config, search_space

    name = str(dt)[6:]
    q, k, v, g = _tile_inputs(shape, dt, device, 53)
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
    cands, _ = search_space("flash_bwd", shape, name)
    assert cands
    untuned = flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    default = default_config("flash_bwd", "cuda", name)
    pair = backward_kernels(dt)
    for c in cands:
        before = [kern.launches for kern in pair]
        got = flash_attention_bwd(q, k, v, out, lse, g, causal=causal, **c)
        assert [kern.launches for kern in pair] == [n + 1 for n in before], c
        for part, a, b in zip(("dq", "dk", "dv"), got, ref):
            if dt == torch.float32:
                torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=f"{part} {c}")
            else:
                _assert_elementwise(a, b, 2.0 ** -7, atol=1e-4)
        again = flash_attention_bwd(q, k, v, out, lse, g, causal=causal, **c)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), c
        if c == default:
            assert all(torch.equal(a, b) for a, b in zip(untuned, got))


def test_a_refused_pair_or_fp32_tile_raises_by_name(device):
    """Tiles the fp32 forward or a kernel of a pair is not built for raise
    KernelConfigError naming them, from an argument and from a cache
    entry, and launch nothing."""
    from repro_torch.tune import KernelConfigError, TuningCache, set_cache

    shape = {"B": 4, "Sq": 512, "Skv": 512, "H": 16, "K": 8, "D": 128, "Dv": 128}
    kerns = (FLASH,) + backward_kernels(torch.float32) + backward_kernels(torch.bfloat16)
    before = [kern.launches for kern in kerns]
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, g = _tile_inputs(shape, dt, device, 54)
        out = torch.zeros_like(q)
        lse = torch.zeros((4, 16, 512), device=device)
        bad = ({"dkv_block_q": 32} if dt == torch.float32 else {"dq_block_k": 128})
        with pytest.raises(KernelConfigError, match=next(iter(bad))):
            flash_attention_bwd(q, k, v, out, lse, g, **bad)
        with pytest.raises(KernelConfigError, match="dkv_block_q"):
            flash_attention_bwd(q, k, v, out, lse, g, dkv_block_q=0)
        cache = TuningCache()
        name = str(dt)[6:]
        cache.put("flash_bwd", shape, name, "cuda", bad, 1.0, save=False)
        if dt == torch.float32:
            cache.put("flash_fwd", shape, name, "cuda", {"block_q": 128, "block_k": 32}, 1.0,
                      save=False)
        prev = set_cache(cache)
        try:
            with pytest.raises(KernelConfigError, match=next(iter(bad))):
                flash_attention_bwd(q, k, v, out, lse, g)
            if dt == torch.float32:
                with pytest.raises(KernelConfigError, match="'block_q': 128"):
                    flash_attention_fwd(q, k, v)
        finally:
            set_cache(prev)
    q, k, v, _ = _tile_inputs(shape, torch.float32, device, 55)
    with pytest.raises(KernelConfigError, match="block_k"):
        flash_attention_fwd(q, k, v, block_q=64, block_k=64)
    assert [kern.launches for kern in kerns] == before


def test_a_flash_bwd_cache_entry_reaches_a_training_step(device):
    """A cached ``flash_bwd`` entry is what the autograd backward
    launches: the same bits as an explicit call at those tiles."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.tune import TuningCache, set_cache

    shape = {"B": 2, "Sq": 256, "Skv": 256, "H": 8, "K": 4, "D": 128, "Dv": 128}
    tiles = {"dq_block_q": 64, "dq_block_k": 64, "dkv_block_k": 128, "dkv_block_q": 16}
    q, k, v, g = _tile_inputs(shape, torch.bfloat16, device, 56)
    cache = TuningCache()
    cache.put("flash_bwd", shape, "bfloat16", "cuda", tiles, 1.0, save=False)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    prev = set_cache(cache)
    try:
        flash_attention(*leaves).backward(g)
    finally:
        set_cache(prev)
    assert cache.hits >= 1
    out, lse = flash_attention_fwd(q, k, v)
    want = flash_attention_bwd(q, k, v, out, lse, g, **tiles)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))
