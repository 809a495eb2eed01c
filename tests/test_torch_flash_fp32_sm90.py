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
the model takes each PV product over the keys in that order.

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
    # (B, Sq, Skv, H, K, D, causal)
    (1, 512, 512, 4, 2, 128, True),
    (2, 13, 13, 4, 2, 64, True),     # ragged
    (1, 130, 70, 4, 4, 32, True),    # Sq > Skv
    (1, 64, 160, 4, 1, 32, True),    # Sq < Skv
    (1, 100, 37, 4, 2, 64, False),   # non-causal
]


def _inputs(case, seed=0):
    B, Sq, Skv, H, K, D, _ = case
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, np.float32)
                 for shape in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D)))


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
    """The kernel's arithmetic on fp32 q (B,Sq,H,D), k and v (B,Skv,K,D):
    returns (out, lse), fp32."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.reshape(B, Sq, K, G, D)
    scale_log2 = float(np.float32(np.log2(np.e) / np.sqrt(D)))
    m = torch.full((B, K, G, Sq), -2.0e38)
    l = torch.zeros((B, K, G, Sq))
    o = torch.zeros((B, K, G, Sq, D))
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
    out = (o / l[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
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
    case = (1, 256, 256, 4, 2, 128, True)
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
