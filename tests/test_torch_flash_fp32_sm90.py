"""The arithmetic of the Hopper fp32 flash-attention forward
(``csrc/flash_attention_sm90_fp32.cu``), modelled on the CPU, against the
port's plain version and the JAX package's Pallas kernel (interpret mode);
and the dtype routing of ``flash_attention_fwd``.

The model does what the kernel does, tile by tile: every product as three
tf32 products, a_hi b_lo + a_lo b_hi + a_hi b_hi, summed in fp32, with x_hi
= x with its low 13 mantissa bits cleared and x_lo = the same of x - x_hi
(products of tf32 values are exact in fp32); scores pre-scaled by D^-0.5
log2(e); an online softmax over 32-key tiles with p = exp2(s - m), each
tile's PV summed apart and added to the running O in fp32; l summed from
the fp32 p; lse = m ln2 + log(l).  The kernel pairs P's registers with
V^T's keys through an 8-key permutation (``_a_slot_key``, ``_vt_slot_key``);
the model takes each PV product over the keys in that order.  At D = 96
a row of Q and K is three 128-byte swizzle atoms, and V, V^T and O may be
narrower than Q and K (MLA's Dv = 64); the layout tests below mirror the
kernel's loops and offsets at each width.

The element check is chip_smoke.py's fp32 one, and the reference suite's
fp32 tolerance: |got - ref| <= 2e-5 for out and lse.  Against the Pallas
kernel the tolerance is the reference's own, 2e-5 absolute and relative
(tests/test_kernels_flash.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_fwd as jax_flash
from repro_torch.kernels.flash_attention import (SM90_FP32_KERNEL,
                                                 SM90_KERNEL,
                                                 flash_attention_fwd,
                                                 flash_attention_plain,
                                                 forward_kernel)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test here, as in the other
    tight-tolerance port tests; the previous count afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


BK = 32  # keys per tile, as in the kernel
ATOL = 2e-5

CASES = [
    # (B, Sq, Skv, H, K, D, Dv, causal)
    (1, 512, 512, 4, 2, 128, 128, True),
    (2, 13, 13, 4, 2, 64, 64, True),     # ragged
    (1, 130, 70, 4, 4, 32, 32, True),    # Sq > Skv
    (1, 64, 160, 4, 1, 32, 32, True),    # Sq < Skv
    (1, 100, 37, 4, 2, 64, 64, False),   # non-causal
    # D = 96: phi-3's (96, 96), minicpm3's MLA (96, 64)
    (1, 256, 256, 4, 2, 96, 96, True),
    (2, 13, 13, 4, 2, 96, 96, True),     # ragged
    (1, 256, 256, 4, 2, 96, 64, True),
    (1, 64, 160, 4, 1, 96, 64, True),    # Sq < Skv
    (1, 100, 37, 4, 2, 96, 64, False),   # non-causal, Sq > Skv
]


def _inputs(case, seed=0):
    B, Sq, Skv, H, K, D, Dv, _ = case
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, np.float32)
                 for shape in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, Dv)))


def _tf32(x):
    """x with its low 13 mantissa bits cleared, as the kernel's split."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product(eq, a, b, terms):
    """The kernel's product of fp32 a and b: the cross terms hi lo and lo
    hi first, then hi hi (``terms`` = 3); ``terms`` = 2 drops hi lo, 1
    keeps hi hi alone."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    out = torch.einsum(eq, a_hi, b_hi)
    if terms == 1:
        return out
    cross = torch.einsum(eq, a_lo, b_hi)
    if terms == 3:
        cross = torch.einsum(eq, a_hi, b_lo) + cross
    return cross + out


def _a_slot_key(t, slot):
    """The key (of an 8-key group) in RS A-fragment slot ``slot`` of the
    thread at lane % 4 = t: slots t and t + 4 take the accumulator's
    columns 2t and 2t + 1."""
    assert slot in (t, t + 4)
    return 2 * t + (slot == t + 4)


def _vt_slot_key(slot):
    """The key that V^T holds at k slot ``slot`` of an 8-key group: key
    2i + e at slot 4e + i."""
    return 2 * (slot % 4) + slot // 4


def _key_order(n):
    """The order in which the kernel's PV product takes a tile's n keys:
    each 8-key group by V^T slot (keys past n are TMA's zero rows, whose p
    is 0)."""
    order = [8 * (s // 8) + _vt_slot_key(s % 8) for s in range(-(-n // 8) * 8)]
    return [k for k in order if k < n]


def fp32_model(q, k, v, *, causal=True, s_terms=3, o_terms=3):
    """The kernel's arithmetic on fp32 q (B,Sq,H,D), k (B,Skv,K,D) and v
    (B,Skv,K,Dv): returns (out (B,Sq,H,Dv), lse), fp32."""
    B, Sq, H, D = q.shape
    Skv, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // K
    qf = q.reshape(B, Sq, K, G, D)
    scale_log2 = float(np.float32(np.log2(np.e) / np.sqrt(D)))
    m = torch.full((B, K, G, Sq), -2.0e38)
    l = torch.zeros((B, K, G, Sq))
    o = torch.zeros((B, K, G, Sq, Dv))
    qpos = torch.arange(Sq)
    for k0 in range(0, Skv, BK):
        kt, vt = k[:, k0:k0 + BK], v[:, k0:k0 + BK]
        s = _product("bqkgd,bskd->bkgqs", qf, kt, s_terms) * scale_log2
        kpos = torch.arange(k0, k0 + kt.shape[1])
        if causal:
            s = torch.where(kpos[None, :] <= qpos[:, None], s, -2.0e38)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        order = torch.tensor(_key_order(kt.shape[1]))
        o = o * corr[..., None] + _product("bkgqs,bskd->bkgqd", p[..., order],
                                           vt[:, order], o_terms)
        m = m_new
    l = l.clamp_min(1e-37)
    out = (o / l[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv)
    lse = (m * float(np.log(2.0)) + torch.log(l)).reshape(B, H, Sq)
    return out, lse


def _over(got, ref):
    """(elements beyond the check, largest |got - ref| / ATOL)."""
    diff = (got - ref).abs()
    return int((diff > ATOL).sum()), diff.max().item() / ATOL


@pytest.mark.parametrize("case", CASES)
def test_model_matches_plain_elementwise(case):
    q, k, v = (torch.from_numpy(x) for x in _inputs(case))
    causal = case[-1]
    out, lse = fp32_model(q, k, v, causal=causal)
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert tuple(lse.shape) == tuple(ref_lse.shape)
    assert _over(out, ref)[1] <= 1.0 and _over(lse, ref_lse)[1] <= 1.0


@pytest.mark.parametrize("terms", [(1, 1), (3, 1), (1, 3), (2, 3), (3, 2)])
def test_fewer_than_three_terms_fail_the_check(terms):
    """Why the kernel issues three tf32 products for each of its two: with
    fewer terms in either, many outputs fall beyond the fp32 element check
    (the table in the kernel's source note), while three in both keep all
    within it (test_model_matches_plain_elementwise)."""
    s_terms, o_terms = terms
    q, k, v = (torch.from_numpy(x) for x in _inputs(CASES[0]))
    ref, ref_lse = flash_attention_plain(q, k, v, causal=True)
    out, lse = fp32_model(q, k, v, causal=True, s_terms=s_terms, o_terms=o_terms)
    n_out, worst = _over(out, ref)
    assert n_out > 100_000 and worst > 40.0
    n_lse, _ = _over(lse, ref_lse)
    assert (n_lse > 1000) == (s_terms < 3)


def test_inputs_below_tf32_precision_move_the_output():
    """The card's test of the lo terms (tests/test_torch_cuda.py) feeds
    inputs that differ only below tf32's mantissa: hi, and hi plus a lo part
    under 2^-11 of it.  The outputs of the two differ well beyond the
    check, so a kernel that dropped the lo terms, or read raw fp32 as
    something other than its split, fails there; the model holds both."""
    case = (1, 256, 256, 4, 2, 128, 128, True)
    full = [torch.from_numpy(x) for x in _inputs(case, seed=3)]
    hi = [_tf32(x) for x in full]
    assert all(torch.equal(_tf32(x), h) for x, h in zip(full, hi))
    ref_full, _ = flash_attention_plain(*full, causal=True)
    ref_hi, _ = flash_attention_plain(*hi, causal=True)
    assert _over(ref_hi, ref_full)[0] > 10_000
    for inputs, ref in ((full, ref_full), (hi, ref_hi)):
        out, _ = fp32_model(*inputs, causal=True)
        assert _over(out, ref)[1] <= 1.0


def test_p_registers_meet_their_own_v():
    """The permutation: in every 8-key group, the key a thread's A-fragment
    slot holds (its accumulator column) is the key that V^T holds at that
    slot, so each p meets its own v; and V^T's order covers every key."""
    for t in range(4):
        for slot in (t, t + 4):
            assert _a_slot_key(t, slot) == _vt_slot_key(slot)
    assert sorted(_vt_slot_key(s) for s in range(8)) == list(range(8))
    assert sorted(_key_order(13)) == list(range(13))


def _swizzle128(off):
    """CuTe's Swizzle<3,4,3> on a byte offset: the 128-byte swizzle TMA
    writes and a wgmma descriptor of layout 1 reads (16-byte chunk c of a
    128-byte row r at chunk c ^ (r % 8), from a 1024-byte boundary)."""
    return off ^ (((off >> 7) & 7) << 4)


def _tma_offset(row, col, rows):
    """Byte offset at which TMA writes element (row, col) of an fp32 tile
    of ``rows`` rows (sm90.cuh's Geo<D, 4>): column atom col // 32, each
    ``rows`` x 128 bytes, the 128-byte swizzle inside it."""
    return col // 32 * rows * 128 + _swizzle128(row * 128 + col % 32 * 4)


def _transpose_v(dv):
    """The kernel's transpose_v<DV> over one BK-key tile of V, warp by warp
    and lane by lane: for each element, (the byte it reads from V's tile,
    the (key, column) TMA wrote there by ``_tma_offset``, the byte of V^T
    it writes, V^T's (row, k slot) of that byte)."""
    seen = []
    for warp in range(4):
        for u in range(warp, dv // 4, 4):
            atom, g, e = u // 8, u % 8 // 2, u % 2
            for lane in range(32):
                d = 32 * atom + lane
                chunk = (2 * g + e) ^ (d % 8)
                for i in range(4):
                    key = 8 * g + 2 * i + e
                    src = (atom * BK * 128 + (lane % 4) * 4 + key * 128
                           + ((lane // 4) ^ (key % 8)) * 16)
                    dst = d * 128 + chunk * 16 + 4 * i
                    seen.append((src, (key, d), dst, (d, 4 * (2 * g + e) + i)))
    return seen


@pytest.mark.parametrize("dv", [32, 64, 96, 128])
def test_transpose_v_reads_every_element_once_and_writes_the_swizzled_vt(dv):
    """transpose_v<DV> at every width, three atoms (96) and MLA's 64
    included: each element of V's tile is read once, from where TMA put it;
    V^T's byte for it is the 128-byte-swizzled K-major layout of (d, slot),
    the slot the 8-key permutation gives its key; every byte of V^T is
    written once."""
    seen = _transpose_v(dv)
    assert len(seen) == dv * BK
    reads = {src: what for src, what, _, _ in seen}
    assert len(reads) == dv * BK
    assert all(_tma_offset(key, d, BK) == src for src, (key, d) in reads.items())
    for _, (key, d), dst, (row, slot) in seen:
        assert row == d and _vt_slot_key(slot % 8) == key % 8 and slot // 8 == key // 8
        assert dst == _swizzle128(row * 128 + slot * 4)
    assert sorted(dst for *_, dst, _ in seen) == list(range(0, dv * 128, 4))


@pytest.mark.parametrize("d, dv", [(32, 32), (64, 64), (96, 96), (96, 64), (128, 128)])
def test_tiles_and_parts_start_on_the_swizzle_period(d, dv):
    """The shared-memory offsets the kernel computes (its Smem<D, DV>) put
    every tile on a 1024-byte boundary, the 128-byte swizzle's period, at
    every width; QK^T's k8 slices walk three atoms at D = 96 as
    desc_k_tf32 finds them; O's parts of Dv / NH columns (NH = 2 at Dv >
    64: 64 at 128, 48 at 96) start on that boundary in V^T too; and the
    block's shared memory at 128 columns is the 176 KB the source states."""
    bq, stages = 64, 2

    def tile(width, rows):
        return rows * width * 4

    q_lo = tile(d, bq)
    kv = q_lo + tile(d, bq)
    stage = tile(d, BK) + tile(dv, BK)
    k_lo = kv + stages * stage
    vt_hi = k_lo + tile(d, BK)
    vt_lo = vt_hi + tile(dv, BK)
    size = vt_lo + tile(dv, BK)
    for off in (q_lo, kv, kv + tile(d, BK), kv + stage, k_lo, vt_hi, vt_lo, size):
        assert off % 1024 == 0, off
    for kk in range(d // 8):  # desc_k_tf32<D>: atom kk * 8 / 32, 32 bytes a slice
        atom, off = kk * 8 // 32, kk * 8 % 32 * 4
        assert (atom, off) == divmod(_tma_offset(0, 8 * kk, bq), bq * 128)
    parts = 2 if dv > 64 else 1
    assert dv // parts in (16, 32, 48, 64)  # the m64nNk8 tf32 forms of sm90.cuh
    assert all(p * (dv // parts) * 128 % 1024 == 0 for p in range(parts))
    if (d, dv) == (128, 128):
        assert size == 176 * 1024


@pytest.mark.parametrize("case", CASES)
def test_model_matches_pallas_reference(case):
    qn, kn, vn = _inputs(case, seed=1)
    causal = case[-1]
    out_j, lse_j = jax_flash(*(jnp.asarray(x) for x in (qn, kn, vn)),
                             causal=causal, interpret=True, return_lse=True)
    out, lse = fp32_model(*(torch.from_numpy(x) for x in (qn, kn, vn)),
                          causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("dtype, kernel", [(torch.bfloat16, SM90_KERNEL),
                                           (torch.float32, SM90_FP32_KERNEL)])
def test_routing_picks_the_kernel_of_the_dtype(dtype, kernel):
    before = (SM90_KERNEL.launches, SM90_FP32_KERNEL.launches)
    assert forward_kernel(dtype) is kernel
    assert (SM90_KERNEL.launches, SM90_FP32_KERNEL.launches) == before


def test_cpu_fp32_calls_build_and_count_nothing():
    """An fp32 CPU call takes the plain version: no library is loaded and
    no launch is counted."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(CASES[1]))
    before = SM90_FP32_KERNEL.launches
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert SM90_FP32_KERNEL.launches == before and SM90_FP32_KERNEL._fn is None


def test_the_fp32_kernel_has_its_own_source():
    assert SM90_FP32_KERNEL.source.name == "flash_attention_sm90_fp32.cu"
    assert SM90_FP32_KERNEL.source.is_file()
    assert SM90_FP32_KERNEL.symbol != SM90_KERNEL.symbol
    # the CUDA-core fp32 forward it replaces is gone
    assert not (SM90_FP32_KERNEL.source.parent / "flash_attention.cu").exists()


if __name__ == "__main__":
    # The table of terms in the kernel's source note: elements beyond the
    # check for each (S terms, O terms), at CASES[0], numpy seed 0.
    torch.set_num_threads(1)
    q, k, v = (torch.from_numpy(x) for x in _inputs(CASES[0]))
    ref, ref_lse = flash_attention_plain(q, k, v, causal=True)
    for terms in [(1, 1), (3, 1), (1, 3), (2, 3), (3, 2), (3, 3)]:
        out, lse = fp32_model(q, k, v, causal=True, s_terms=terms[0], o_terms=terms[1])
        (n_out, w_out), (n_lse, w_lse) = _over(out, ref), _over(lse, ref_lse)
        print(f"S {terms[0]} O {terms[1]}: out beyond {n_out:,} of {out.numel():,} "
              f"(worst {w_out:.3f} of the limit), lse beyond {n_lse:,} of "
              f"{lse.numel():,} (worst {w_lse:.3f})")
