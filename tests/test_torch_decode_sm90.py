"""The arithmetic of the Hopper flash-decode kernel
(``csrc/decode_attention_sm90.cu``), modelled on the CPU, against the JAX
package's Pallas ``decode_attention_fwd`` (interpret mode) and the port's
plain version; and the kernel's choice of KV splits.

The model does what the kernel does: the valid keys cut into ``splits``
contiguous ranges, one block each; inside a block, 32-key tiles of which
each of 4 warps takes 8 keys and keeps its own online softmax (m, l, acc)
in fp32, with q pre-scaled by D^-0.5 log2(e) and p = exp2(s - m); the
block merges its warps' states, then the splits' states merge rank by rank:
M = max m, L = sum l 2^(m-M) clamped at 1e-37, out = sum acc 2^(m-M) / L,
rounded once to the cache dtype.  An empty warp or split keeps m = -2e38
(finite), l = 0, and weighs exactly 0.

Tolerances against the Pallas kernel are the reference suite's own, 2e-5
(fp32) and 3e-2 (bf16) (tests/test_kernels_decode.py).  Against the plain
version the check is chip_smoke.py's, element by element:
|got - ref| <= 2e-5 + rtol |ref|, rtol 0 in fp32 and 2^-7 (one bf16 ulp)
in bf16.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import \
    decode_attention_fwd as jax_decode
from repro_torch.kernels.decode_attention import decode_attention_plain


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, as in the other
    tight-tolerance port tests; the previous count afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


NEG_INF = -2.0e38
WARPS, U = 4, 8  # warps a block, keys a warp takes from a tile
TK = WARPS * U  # keys a tile
MAX_SPLITS = 8
SMS = 132  # an H100 SXM's; the kernel reads the device's own count


def heads_a_block(G):
    """The q-heads one block serves: G rounded up to a power of two, at
    most 8."""
    return 1 if G <= 1 else 2 if G <= 2 else 4 if G <= 4 else 8


def kernel_splits(B, H, K, cache_index, sms=SMS):
    """The kernel's ``choose_splits`` on a card of ``sms`` SMs: enough
    splits for about two blocks an SM, at most 8 (the portable cluster
    size), no split shorter than a tile."""
    G = H // K
    blocks_a_split = B * K * -(-G // heads_a_block(G))
    splits = min(-(-2 * sms // blocks_a_split), MAX_SPLITS,
                 (cache_index + 1) // TK)
    return max(splits, 1)


def _merge(states):
    """The fixed-order combine of (m, l, acc) states."""
    M = states[0][0]
    for m, _, _ in states[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    acc = torch.zeros_like(states[0][2])
    for m, l, a in states:
        c = torch.exp2(m - M)
        L = L + l * c
        acc = acc + a * c[..., None]
    return M, L, acc


def decode_model(q, k, v, *, cache_index, splits):
    """The kernel's arithmetic: q (B,1,H,D), caches (B,S,K,D), fp32 or
    bf16 -> (B,1,H,D) in the cache dtype."""
    B, S, K, D = k.shape
    H = q.shape[2]
    G = H // K
    scale_log2 = np.float32(np.log2(np.e)) / np.float32(math.sqrt(D))
    qs = q.float().reshape(B, K, G, D) * float(scale_log2)
    kf, vf = k.float(), v.float()
    n = cache_index + 1
    split_states = []
    for r in range(splits):
        k0, k1 = r * n // splits, (r + 1) * n // splits
        warp_states = []
        for w in range(WARPS):
            m = torch.full((B, K, G), NEG_INF)
            l = torch.zeros((B, K, G))
            acc = torch.zeros((B, K, G, D))
            for t0 in range(k0, k1, TK):
                a, e = t0 + w * U, min(t0 + w * U + U, k1)
                if a >= e:
                    continue
                s = torch.einsum("bkgd,bskd->bkgs", qs, kf[:, a:e])
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum("bkgs,bskd->bkgd", p,
                                                           vf[:, a:e])
                m = m_new
            warp_states.append((m, l, acc))
        split_states.append(_merge(warp_states))
    _, L, acc = _merge(split_states)
    out = acc / L.clamp_min(1e-37)[..., None]
    return out.reshape(B, 1, H, D).to(v.dtype)


F32, BF16 = torch.float32, torch.bfloat16
_JNP = {F32: jnp.float32, BF16: jnp.bfloat16}

CASES = [
    # (B, S, H, K, D, cache_index, splits, dtype); None: the kernel's choice
    (2, 128, 4, 2, 64, 100, 1, F32),
    (2, 128, 4, 2, 64, 100, 2, F32),
    (2, 128, 4, 2, 64, 100, 8, F32),  # splits shorter than a tile
    (1, 256, 8, 2, 128, 0, 8, F32),  # seven splits hold no key
    (1, 256, 8, 2, 128, 255, 8, BF16),  # the whole cache
    (1, 64, 8, 8, 32, 5, 8, F32),  # G = 1; empty splits among full ones
    (2, 96, 4, 1, 32, 47, 2, BF16),  # G = 4
    (1, 64, 12, 4, 64, 40, 2, F32),  # G = 3: a padded head in the block
    (2, 24, 16, 8, 128, 11, None, F32),  # chip_smoke's ragged case
    (4, 576, 16, 8, 128, 543, None, BF16),  # the serve shape
    (1, 576, 16, 8, 128, 543, None, F32),  # the serve shape at B = 1
]


def _inputs(case, seed=0):
    B, S, H, K, D, _, _, dt = case
    rng = np.random.default_rng(seed)
    arrays = tuple(rng.standard_normal(shape, np.float32)
                   for shape in ((B, 1, H, D), (B, S, K, D), (B, S, K, D)))
    return arrays, tuple(torch.from_numpy(a).to(dt) for a in arrays)


def _splits(case):
    B, _, H, K, _, ci, splits, _ = case
    return kernel_splits(B, H, K, ci) if splits is None else splits


@pytest.mark.parametrize("case", CASES)
def test_model_matches_the_pallas_kernel(case):
    *_, ci, _, dt = case
    arrays, (q, k, v) = _inputs(case)
    got = decode_model(q, k, v, cache_index=ci, splits=_splits(case))
    assert got.dtype == dt
    ref = jax_decode(*(jnp.asarray(a, _JNP[dt]) for a in arrays), cache_index=ci,
                     interpret=True)
    tol = 3e-2 if dt == BF16 else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", CASES)
def test_model_holds_chip_smokes_check_against_the_plain_version(case):
    *_, ci, _, dt = case
    _, (q, k, v) = _inputs(case, seed=1)
    got = decode_model(q, k, v, cache_index=ci, splits=_splits(case)).float()
    ref = decode_attention_plain(q, k, v, cache_index=ci).float()
    rtol = 2.0 ** -7 if dt == BF16 else 0.0
    worst = ((got - ref).abs() / (2e-5 + rtol * ref.abs())).max().item()
    assert worst <= 1.0, f"largest |err| / limit {worst:.3f}"


def test_splits_that_hold_no_key_weigh_nothing():
    """At cache_index 0 seven of eight splits are empty: the merge gives
    the one-split result bit for bit, with no NaN from NEG_INF - NEG_INF."""
    case = (2, 64, 4, 2, 64, 0, None, F32)
    _, (q, k, v) = _inputs(case, seed=2)
    eight = decode_model(q, k, v, cache_index=0, splits=8)
    one = decode_model(q, k, v, cache_index=0, splits=1)
    assert torch.isfinite(eight).all()
    assert torch.equal(eight, one)
    torch.testing.assert_close(one, v[:, :1].repeat_interleave(2, 2), atol=0, rtol=0)


def test_split_count_covers_the_card():
    # the serve shape: 32 (b, kv-head) pairs x 8 splits
    assert kernel_splits(4, 16, 8, 543) == 8
    assert 8 * 4 * 8 >= SMS
    # B = 1: the cluster size caps the grid at 8 blocks a kv-head
    assert kernel_splits(1, 16, 8, 543) == MAX_SPLITS
    # short caches: no split shorter than a tile, one split below a tile
    assert kernel_splits(4, 16, 8, 0) == 1
    assert kernel_splits(4, 16, 8, 11) == 1
    assert kernel_splits(4, 16, 8, 95) == 3
    # a large batch needs no split
    assert kernel_splits(64, 16, 8, 543) == 1


@pytest.mark.parametrize("B,H,K", [(1, 16, 8), (4, 16, 8), (2, 32, 8), (8, 16, 8),
                                   (1, 8, 1), (3, 12, 4), (1, 16, 1)])
def test_split_count_rules(B, H, K):
    """At most 8 splits; every split at least one tile long where the keys
    allow; the grid as large as the keys and the cluster size let it be,
    up to two blocks an SM."""
    G = H // K
    blocks_a_split = B * K * -(-G // heads_a_block(G))
    for ci in range(0, 2048, 7):
        n = ci + 1
        splits = kernel_splits(B, H, K, ci)
        assert 1 <= splits <= MAX_SPLITS
        shortest = min((r + 1) * n // splits - r * n // splits for r in range(splits))
        assert splits == 1 or shortest >= TK
        if splits < MAX_SPLITS and n >= (splits + 1) * TK:
            assert splits * blocks_a_split >= 2 * SMS


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("B", [4, 1])
def test_an_explicit_split_count_holds_the_check(B, splits):
    """A split count the tuning cache gives (``decode_attention_fwd(...,
    splits=)``) at qwen3's serve shape: each count the space takes holds
    chip_smoke.py's element check against the plain version, as the
    kernel's own choice does; the wrapper passes the count through where
    every split keeps a tile, and 0 (the kernel's choice) otherwise
    names none."""
    from repro_torch.kernels.decode_attention.decode_attention import decode_splits
    from repro_torch.tune.space import choose_splits

    ci = 543
    case = (B, 576, 16, 8, 128, ci, splits, BF16)
    _, (q, k, v) = _inputs(case, seed=3)
    got = decode_model(q, k, v, cache_index=ci, splits=splits).float()
    ref = decode_attention_plain(q, k, v, cache_index=ci).float()
    worst = ((got - ref).abs() / (2e-5 + 2.0 ** -7 * ref.abs())).max().item()
    assert worst <= 1.0, f"largest |err| / limit {worst:.3f}"
    assert decode_splits(BF16, B, 576, 16, 8, 128, 128, ci, splits) == splits
    assert decode_splits(BF16, B, 576, 16, 8, 128, 128, ci) == 0
    assert choose_splits(B, 16, 8, ci + 1) == kernel_splits(B, 16, 8, ci)
