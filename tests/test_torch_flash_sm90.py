"""The arithmetic of the Hopper bf16 flash-attention forward
(``csrc/flash_attention_sm90.cu``), modelled on the CPU, against the
port's plain version and the JAX package's Pallas kernel (interpret mode);
and the dtype routing of ``flash_attention_fwd``.

The model does what the kernel does, tile by tile: fp32 scores from bf16 q
and k (products of bf16 values are exact in fp32), pre-scaled by
D^-0.5 log2(e); an online softmax over tiles of ``block_k`` keys (64, the
untuned tile, or 128) with p = exp2(s - m); P split into p_hi = bf16(p) and
p_lo = bf16(p - p_hi), two PV products summed in fp32; l summed from the
fp32 p; lse = m ln2 + log(l).  A block of ``block_q`` = 128 rows is two
64-row warpgroups of one q-head: the block walks the key tiles up to its
last row, and each warpgroup skips the tiles wholly above its own rows.

The element check is chip_smoke.py's: |got - ref| <= 2e-5 + 2^-7 |ref| for
the bf16 output and 2e-5 for lse.  Against the reference's Pallas kernel
the tolerance is its own bf16 one, 2e-2 (tests/test_kernels_flash.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_fwd as jax_flash
from repro_torch.kernels.flash_attention import (SM90_FP32_KERNEL, SM90_KERNEL,
                                                 flash_attention_plain,
                                                 forward_kernel)


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, as in the other
    tight-tolerance port tests; the previous count afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


BK = 64  # keys per tile, as in the kernel's untuned tiles
ATOL, RTOL_BF16 = 2e-5, 2.0 ** -7
# the tiles the tuning space takes: (block_q, block_k)
TILES = [(64, 64), (64, 128), (128, 64), (128, 128)]

CASES = [
    # (B, Sq, Skv, H, K, D, causal)
    (1, 512, 512, 4, 2, 128, True),
    (2, 13, 13, 4, 2, 64, True),
    (1, 130, 70, 4, 4, 32, True),
    (1, 100, 37, 4, 2, 64, False),
]


def _inputs(case, seed=0):
    B, Sq, Skv, H, K, D, _ = case
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, np.float32)
                 for shape in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D)))


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def sm90_model(q, k, v, *, causal=True, split=True, block_q=64, block_k=BK):
    """The kernel's arithmetic on bf16 q (B,Sq,H,D), k and v (B,Skv,K,D) at
    tiles ``block_q`` x ``block_k``: returns (out bf16, lse fp32).
    ``split=False`` rounds p once to bf16 for the PV product instead of
    splitting it."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, Sq, K, G, D)
    kf, vf = k.float(), v.float()
    scale_log2 = float(np.float32(np.log2(np.e) / np.sqrt(D)))
    outs, lses = [], []
    for q0 in range(0, Sq, block_q):  # a block's rows
        kv_end = min(Skv, q0 + block_q) if causal else Skv
        for w0 in range(q0, min(q0 + block_q, Sq), 64):  # a warpgroup's 64 rows
            rows = min(64, Sq - w0)
            qw = qf[:, w0:w0 + rows]
            m = torch.full((B, K, G, rows), -2.0e38)
            l = torch.zeros((B, K, G, rows))
            o = torch.zeros((B, K, G, rows, D))
            qpos = torch.arange(w0, w0 + rows)
            for k0 in range(0, kv_end, block_k):
                if causal and k0 > w0 + 63:
                    continue  # wholly above this warpgroup's rows: skipped
                kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
                s = torch.einsum("bqkgd,bskd->bkgqs", qw, kt) * scale_log2
                kpos = torch.arange(k0, k0 + kt.shape[1])
                if causal:
                    s = torch.where(kpos[None, :] <= qpos[:, None], s, -2.0e38)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                p_hi = p.to(torch.bfloat16).float()
                o = o * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p_hi, vt)
                if split:
                    p_lo = (p - p_hi).to(torch.bfloat16).float()
                    o = o + torch.einsum("bkgqs,bskd->bkgqd", p_lo, vt)
                m = m_new
            l = l.clamp_min(1e-37)
            outs.append((o / l[..., None]).permute(0, 3, 1, 2, 4).reshape(B, rows, H, D))
            lses.append((m * float(np.log(2.0)) + torch.log(l)).reshape(B, H, rows))
    return torch.cat(outs, 1).to(torch.bfloat16), torch.cat(lses, 2)


def _worst(got, ref, rtol):
    """Largest |got - ref| / (ATOL + rtol |ref|): at most 1 passes."""
    diff = (got.float() - ref.float()).abs()
    return (diff / (ATOL + rtol * ref.float().abs())).max().item()


@pytest.mark.parametrize("case", CASES)
def test_model_matches_plain_elementwise(case):
    _model_matches_plain(case, TILES[0])


@pytest.mark.parametrize("tiles", TILES[1:], ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", CASES)
def test_model_at_tuned_tiles_matches_plain_elementwise(case, tiles):
    _model_matches_plain(case, tiles)


def _model_matches_plain(case, tiles):
    q, k, v = (_bf16(x) for x in _inputs(case))
    causal = case[-1]
    out, lse = sm90_model(q, k, v, causal=causal, block_q=tiles[0], block_k=tiles[1])
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    assert out.dtype == torch.bfloat16 and tuple(lse.shape) == tuple(ref_lse.shape)
    assert _worst(out, ref, RTOL_BF16) <= 1.0
    assert _worst(lse, ref_lse, 0.0) <= 1.0


def test_p_rounded_once_to_bf16_fails_the_check():
    """Why the kernel splits P: one bf16 rounding of p for the PV product
    puts many outputs beyond the element check at the training shape's
    depth, while the split keeps them all within it."""
    case = CASES[0]
    q, k, v = (_bf16(x) for x in _inputs(case))
    ref, _ = flash_attention_plain(q, k, v, causal=True)
    once, _ = sm90_model(q, k, v, causal=True, split=False)
    diff = (once.float() - ref.float()).abs()
    over = diff > ATOL + RTOL_BF16 * ref.float().abs()
    assert over.sum().item() > 1000
    assert _worst(once, ref, RTOL_BF16) > 4.0
    split, _ = sm90_model(q, k, v, causal=True)
    assert _worst(split, ref, RTOL_BF16) <= 1.0


@pytest.mark.parametrize("case", CASES)
def test_model_matches_pallas_reference(case):
    _model_matches_pallas(case, TILES[0])


@pytest.mark.parametrize("tiles", TILES[1:], ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", CASES)
def test_model_at_tuned_tiles_matches_pallas_reference(case, tiles):
    _model_matches_pallas(case, tiles)


def _model_matches_pallas(case, tiles):
    qn, kn, vn = _inputs(case, seed=1)
    causal = case[-1]
    out_j, lse_j = jax_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (qn, kn, vn)),
                             causal=causal, interpret=True, return_lse=True)
    out, lse = sm90_model(*(_bf16(x) for x in (qn, kn, vn)), causal=causal,
                          block_q=tiles[0], block_k=tiles[1])
    np.testing.assert_allclose(out.float().numpy(), np.asarray(out_j, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype, kernel", [(torch.bfloat16, SM90_KERNEL),
                                           (torch.float32, SM90_FP32_KERNEL)])
def test_routing_picks_the_kernel_of_the_dtype(dtype, kernel):
    before = (SM90_KERNEL.launches, SM90_FP32_KERNEL.launches)
    assert forward_kernel(dtype) is kernel
    assert (SM90_KERNEL.launches, SM90_FP32_KERNEL.launches) == before


def test_the_two_forward_kernels_have_their_own_sources():
    assert SM90_KERNEL.source.name == "flash_attention_sm90.cu"
    assert SM90_FP32_KERNEL.source.name == "flash_attention_sm90_fp32.cu"
    assert SM90_KERNEL.source.is_file() and SM90_FP32_KERNEL.source.is_file()
    assert SM90_KERNEL.symbol != SM90_FP32_KERNEL.symbol


@pytest.mark.parametrize("tiles", TILES[1:], ids=lambda t: f"{t[0]}x{t[1]}")
def test_tiles_change_only_the_rescale_points(tiles):
    """Two row warpgroups a head leave every row's tiles as one does (the
    skipped tiles would add exactly 0): 128 x 64 gives 64 x 64's output
    bit for bit; 128-key tiles move the online softmax's rescale points,
    so the outputs differ from 64-key tiles' by rounding only, inside the
    element check against each other too."""
    q, k, v = (_bf16(x) for x in _inputs(CASES[0]))
    base, base_lse = sm90_model(q, k, v, causal=True)
    out, lse = sm90_model(q, k, v, causal=True, block_q=tiles[0], block_k=tiles[1])
    if tiles[1] == BK:
        assert torch.equal(out, base) and torch.equal(lse, base_lse)
    else:
        assert _worst(out, base, RTOL_BF16) <= 1.0
        assert _worst(lse, base_lse, 0.0) <= 1.0
