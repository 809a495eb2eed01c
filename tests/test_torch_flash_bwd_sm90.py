"""The arithmetic of the Hopper bf16 flash-attention backward
(``csrc/flash_bwd_dq_sm90.cu`` and ``csrc/flash_bwd_dkv_sm90.cu``),
modelled on the CPU, against the port's plain backward and the JAX
package's Pallas backward (interpret mode); and the dtype routing of
``flash_attention_bwd``.

The model does what the kernels do, tile by tile: fp32 products of bf16
operands (exact in fp32); p = exp2(s D^-0.5 log2(e) - lse log2(e)) from
the forward's lse, 0 where masked; ds = p (dp - Dvec) D^-0.5 in fp32; P and
dS split into hi = bf16(x) and lo = bf16(x - hi), each product issued for
hi and then lo into one fp32 sum.  dq walks 64-key tiles in order; dk/dv
deal their steps (32-query tiles in order and, inside each, the G
q-heads of the kv-head in order) to two warpgroups in turn, each summing
its own in order, and add the second's sums to the first's.  At the tuned
tiles (``dq_block_q``, ``dq_block_k``, ``dkv_block_k``, ``dkv_block_q``):
dq walks 128-key tiles, or two 64-row warpgroups a q-head share each tile
and the first skips those wholly above its rows (no-ops, as the model
shows); dk/dv takes 16- or 64-query steps, and at 128 keys a block each
warpgroup owns 64 of them and sums every step from the shared ring in
order, with no cross-warpgroup sum.

The element check is chip_smoke.py's: |got - ref| <= 1e-4 + 2^-7 |ref|.
Against the reference's Pallas backward the tolerance is its own bf16 one,
6e-2 absolute / 1e-2 relative (tests/test_kernels_flash_bwd.py).
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_bwd as jax_bwd
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_fwd as jax_fwd
from repro_torch.kernels.flash_attention import (DKV_SM90_FP32_KERNEL,
                                                 DKV_SM90_KERNEL,
                                                 DQ_SM90_FP32_KERNEL,
                                                 DQ_SM90_KERNEL,
                                                 backward_kernels,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, as in the other
    tight-tolerance port tests; the previous count afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


DQ_BK = 64     # dq: keys per tile
DKV_BQ = 32    # dk/dv: queries per step
# the untuned tiles, then tuned ones: 128-key dq tiles and two row
# warpgroups a q-head, 16- and 64-query dk/dv steps, 128-key dk/dv blocks
UNTUNED = {"dq_block_q": 64, "dq_block_k": DQ_BK, "dkv_block_k": 64, "dkv_block_q": DKV_BQ}
TUNED = [dict(UNTUNED, dq_block_q=128, dq_block_k=128, dkv_block_k=128, dkv_block_q=16),
         dict(UNTUNED, dkv_block_k=128, dkv_block_q=64),
         dict(UNTUNED, dq_block_q=128, dkv_block_q=16),
         dict(UNTUNED, dq_block_k=128, dkv_block_q=64)]


def _tiles_id(t):
    return "dq{dq_block_q}x{dq_block_k}-dkv{dkv_block_k}x{dkv_block_q}".format(**t)
ATOL, RTOL_BF16 = 1e-4, 2.0 ** -7
LOG2E = np.float32(1.4426950408889634)

CASES = [
    # (B, Sq, Skv, H, K, D, Dv, causal)
    (1, 512, 512, 4, 2, 128, 128, True),
    (2, 13, 13, 4, 2, 64, 64, True),
    (1, 130, 70, 4, 4, 32, 32, True),
    (1, 100, 37, 4, 2, 64, 64, False),
    (1, 96, 160, 4, 1, 32, 32, True),
    # phi-3's head dim, MLA's (D, Dv) with one q-head a kv-head, and
    # whisper's non-causal cross-attention (Sq != Skv, a 22-key tail)
    (1, 128, 128, 4, 4, 96, 96, True),
    (1, 130, 130, 2, 2, 96, 64, True),
    (2, 48, 150, 2, 2, 64, 64, False),
    # the MoE family's odd GQA groups, G = 5 (llama4) and G = 7 (arctic):
    # an odd number of dk/dv steps, warpgroup 0 taking one more
    (1, 160, 160, 5, 1, 128, 128, True),
    (1, 96, 96, 10, 2, 64, 64, True),
    (1, 70, 70, 7, 1, 32, 32, False),
    # jamba's G = 8 (64 q-heads over 8) at D = 128: an even number of
    # dk/dv steps, a ragged 32-key tail in the last key tile
    (1, 160, 160, 8, 1, 128, 128, True),
]
ODD_G = [case for case in CASES if case[3] // case[4] in (5, 7)]


def _numpy_inputs(case, seed=0):
    B, Sq, Skv, H, K, D, Dv, _ = case
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, np.float32)
                 for shape in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, Dv),
                               (B, Sq, H, Dv)))


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _inputs(case, seed=0):
    """bf16 q, k, v, dO and the forward's (out, lse) for them."""
    q, k, v, g = (_bf16(x) for x in _numpy_inputs(case, seed))
    out, lse = flash_attention_plain(q, k, v, causal=case[-1])
    return q, k, v, out, lse, g


def _terms(x, split):
    """x as the bf16 terms the kernels multiply: (hi, lo) or (bf16(x),)."""
    hi = x.to(torch.bfloat16).float()
    return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)


def sm90_bwd_model(q, k, v, out, lse, g, *, causal=True, split_p=True,
                   split_ds=True, tiles=None):
    """The kernels' arithmetic on bf16 q (B,Sq,H,D), dO (B,Sq,H,Dv), k
    (B,Skv,K,D), v (B,Skv,K,Dv), the forward's out and lse, at ``tiles``
    (the untuned ones unless given): returns (dq, dk, dv) in bf16.
    ``split_p`` / ``split_ds`` False round P / dS once to bf16 instead of
    splitting."""
    t = UNTUNED if tiles is None else tiles
    dq_bq, dq_bk, bkv, bq = (t[n] for n in ("dq_block_q", "dq_block_k", "dkv_block_k",
                                            "dkv_block_q"))
    B, Sq, H, D = q.shape
    Skv, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // K
    root = np.sqrt(np.float32(D), dtype=np.float32)
    scale_log2, scale = float(LOG2E / root), float(np.float32(1.0) / root)
    qf = q.float().reshape(B, Sq, K, G, D)
    gf = g.float().reshape(B, Sq, K, G, Dv)
    kf, vf = k.float(), v.float()
    # Dvec in the dq kernel's prologue; lse as a base-2 exponent
    dvec = (g.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(B, K, G, Sq)
    l2 = (lse * float(LOG2E)).reshape(B, K, G, Sq)
    qpos, kpos = torch.arange(Sq), torch.arange(Skv)

    def p_ds(s, dp, l2_, dvec_, qp, kp):  # s, dp (..., queries, keys)
        p = torch.exp2(s * scale_log2 - l2_[..., None])
        if causal:
            p = torch.where(kp[None, :] <= qp[:, None], p, 0.0)
        return p, p * (dp - dvec_[..., None]) * scale

    # dq: a row moves only on the tiles its warpgroup multiplies
    dq = torch.zeros(B, K, G, Sq, D)
    for k0 in range(0, Skv, dq_bk):
        kt, vt = kf[:, k0:k0 + dq_bk], vf[:, k0:k0 + dq_bk]
        s = torch.einsum("bqkgd,bnkd->bkgqn", qf, kt)
        dp = torch.einsum("bqkgd,bnkd->bkgqn", gf, vt)
        _, ds = p_ds(s, dp, l2, dvec, qpos, kpos[k0:k0 + dq_bk])
        go = torch.tensor([dq_walks(k0, r, dq_bq, Skv, causal) for r in range(Sq)])
        for term in _terms(ds, split_ds):
            dq = torch.where(go[:, None], dq + torch.einsum("bkgqn,bnkd->bkgqd", term, kt), dq)

    # dk/dv, a key block at a time from its first visible query tile:
    # at 64 keys the steps (query tile, q-head) in order, dealt to two
    # warpgroups in turn, warpgroup 1's sums added to warpgroup 0's at the
    # end; at 128 keys each warpgroup's 64 keys summed over every step
    dk = torch.zeros(B, Skv, K, D)
    dv = torch.zeros(B, Skv, K, Dv)
    for k0 in range(0, Skv, bkv):
        q_begin = k0 if causal else 0
        steps = [(q0, gi) for q0 in range(q_begin, Sq, bq) for gi in range(G)]
        for kw in range(k0, min(k0 + bkv, Skv), 64):
            keys = slice(kw, kw + 64)
            nacc = 2 if bkv == 64 else 1
            dka = [torch.zeros(B, kf[:, keys].shape[1], K, D) for _ in range(nacc)]
            dva = [torch.zeros(B, kf[:, keys].shape[1], K, Dv) for _ in range(nacc)]
            for j, (q0, gi) in enumerate(steps):
                rows, wg = slice(q0, q0 + bq), j % nacc
                qt, gt = qf[:, rows, :, gi], gf[:, rows, :, gi]  # (B, n, K, D or Dv)
                st = torch.einsum("bskd,bnkd->bkns", kf[:, keys], qt)  # queries, keys
                dpt = torch.einsum("bskd,bnkd->bkns", vf[:, keys], gt)
                p, ds = p_ds(st, dpt, l2[:, :, gi, rows], dvec[:, :, gi, rows],
                             qpos[rows], kpos[keys])
                for term in _terms(p, split_p):
                    dva[wg] = dva[wg] + torch.einsum("bkns,bnkd->bskd", term, gt)
                for term in _terms(ds, split_ds):
                    dka[wg] = dka[wg] + torch.einsum("bkns,bnkd->bskd", term, qt)
            dk[:, keys] = dka[0] + dka[1] if nacc == 2 else dka[0]
            dv[:, keys] = dva[0] + dva[1] if nacc == 2 else dva[0]
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def dq_walks(k0, row, block_q, Skv, causal, block_k=None):
    """Whether the dq kernel's warpgroup over ``row``'s 64 rows, in a
    block of ``block_q`` rows, multiplies the tile of keys from ``k0``:
    the block walks the tiles up to its last row (causal), and of two row
    warpgroups the first skips those wholly above its rows."""
    q0, rows0 = row - row % block_q, row - row % 64
    kv_end = min(Skv, q0 + block_q) if causal else Skv
    return k0 < kv_end and not (block_q > 64 and causal and k0 > rows0 + 63)


def _beyond(got, ref):
    """(elements beyond the check, largest |got - ref| / limit)."""
    ratio = (got.float() - ref.float()).abs() / (ATOL + RTOL_BF16 * ref.float().abs())
    return int((ratio > 1.0).sum()), ratio.max().item()


@pytest.mark.parametrize("case", CASES)
def test_model_matches_plain_elementwise(case):
    q, k, v, out, lse, g = _inputs(case)
    causal = case[-1]
    got = sm90_bwd_model(q, k, v, out, lse, g, causal=causal)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        n, worst = _beyond(a, b)
        assert n == 0, f"{name}: {n} elements beyond the check, worst {worst:.2f}"


@pytest.mark.parametrize("tiles", TUNED, ids=_tiles_id)
@pytest.mark.parametrize("case", CASES)
def test_model_at_tuned_tiles_matches_plain_elementwise(case, tiles):
    q, k, v, out, lse, g = _inputs(case)
    causal = case[-1]
    got = sm90_bwd_model(q, k, v, out, lse, g, causal=causal, tiles=tiles)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        n, worst = _beyond(a, b)
        assert n == 0, f"{name}: {n} elements beyond the check, worst {worst:.2f}"


def test_dq_row_warpgroups_leave_every_row_as_one_does():
    """Two row warpgroups a q-head (128 rows a dq block) skip only tiles
    whose dS is zero at every row of theirs, so dq is 64 rows' bit for
    bit; dk and dv do not depend on dq's tiles."""
    q, k, v, out, lse, g = _inputs(CASES[0])
    base = sm90_bwd_model(q, k, v, out, lse, g, causal=True)
    rows128 = sm90_bwd_model(q, k, v, out, lse, g, causal=True,
                             tiles=dict(UNTUNED, dq_block_q=128))
    assert all(torch.equal(a, b) for a, b in zip(base, rows128))
    Sq = Skv = q.shape[1]
    for bk in (64, 128):
        for row in range(Sq):
            for k0 in range(0, Skv, bk):
                if dq_walks(k0, row, 128, Skv, True) != dq_walks(k0, row, 64, Skv, True):
                    # a skipped tile holds no key visible to the row's 64 rows
                    assert k0 > row - row % 64 + 63


@pytest.mark.parametrize("dkv_block_k", [64, 128])
def test_128_key_blocks_need_no_cross_warpgroup_sum(dkv_block_k):
    """At 128 keys a dk/dv block each warpgroup sums every step of its own
    64 keys from the shared ring, in order: the model's dk and dv are one
    warpgroup's sum, and they differ from 64-key blocks' (whose two
    warpgroups' halves are added at the end) by rounding only, inside the
    element check against each other."""
    q, k, v, out, lse, g = _inputs(CASES[0])
    base = sm90_bwd_model(q, k, v, out, lse, g, causal=True)
    got = sm90_bwd_model(q, k, v, out, lse, g, causal=True,
                         tiles=dict(UNTUNED, dkv_block_k=dkv_block_k))
    assert torch.equal(got[0], base[0])
    for a, b in zip(got[1:], base[1:]):
        if dkv_block_k == 64:
            assert torch.equal(a, b)
        else:
            assert _beyond(a, b)[0] == 0


@pytest.mark.parametrize("case", ODD_G)
def test_odd_groups_deal_an_odd_number_of_dkv_steps(case):
    """G = 5 and 7 over whole and ragged query tiles: the (query tile,
    q-head) steps of a kv-head are odd in number, so the model's deal
    (``j % 2``, the kernel's rule, which deals a key tile's visible steps:
    the same steps at a non-causal shape) gives warpgroup 0 one step more
    than warpgroup 1 before the fixed-order merge."""
    _, Sq, _, H, K = case[:5]
    steps = -(-Sq // DKV_BQ) * (H // K)
    assert H // K in (5, 7) and steps % 2 == 1
    assert len(range(0, steps, 2)) == len(range(1, steps, 2)) + 1


@pytest.mark.parametrize("split_p, split_ds, failing", [
    (False, False, ("dq", "dk", "dv")),
    (True, False, ("dq", "dk")),
    (False, True, ("dv",)),
])
def test_rounding_p_or_ds_once_fails_the_check(split_p, split_ds, failing):
    """Why the kernels split P and dS: one bf16 rounding of P puts many dv
    elements beyond the element check at the training shape's depth, and
    one of dS many dq and dk elements; what is split stays within it."""
    q, k, v, out, lse, g = _inputs(CASES[0])
    ref = flash_attention_bwd_plain(q, k, v, out, lse, g, causal=True)
    got = sm90_bwd_model(q, k, v, out, lse, g, causal=True, split_p=split_p,
                         split_ds=split_ds)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        n, worst = _beyond(a, b)
        if name in failing:
            assert n > 1000 and worst > 4.0, (name, n, worst)
        else:
            assert n == 0, (name, n, worst)


@pytest.mark.parametrize("case", CASES)
def test_model_matches_pallas_reference(case):
    _model_matches_pallas(case, None)


@pytest.mark.parametrize("tiles", TUNED[:2], ids=_tiles_id)
@pytest.mark.parametrize("case", CASES)
def test_model_at_tuned_tiles_matches_pallas_reference(case, tiles):
    _model_matches_pallas(case, tiles)


def _model_matches_pallas(case, tiles):
    B, Sq, Skv, H, K, D, Dv, causal = case
    qn, kn, vn, gn = _numpy_inputs(case, seed=1)
    qj, kj, vj, gj = (jnp.asarray(x, jnp.bfloat16) for x in (qn, kn, vn, gn))
    bq = 64 if Sq % 64 == 0 else Sq
    bk = 64 if Skv % 64 == 0 else Skv
    out_j, lse_j = jax_fwd(qj, kj, vj, causal=causal, block_q=bq, block_k=bk,
                           interpret=True, return_lse=True)
    ref = jax_bwd(qj, kj, vj, out_j, lse_j, gj, causal=causal, block_q=bq,
                  block_k=bk, interpret=True)
    out = torch.from_numpy(np.array(out_j, np.float32)).to(torch.bfloat16)
    lse = torch.from_numpy(np.array(lse_j, np.float32))
    got = sm90_bwd_model(*(_bf16(x) for x in (qn, kn, vn)), out, lse, _bf16(gn),
                         causal=causal, tiles=tiles)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=6e-2, rtol=1e-2, err_msg=name)


@pytest.mark.parametrize("dtype, pair", [
    (torch.bfloat16, (DQ_SM90_KERNEL, DKV_SM90_KERNEL)),
    (torch.float32, (DQ_SM90_FP32_KERNEL, DKV_SM90_FP32_KERNEL)),
])
def test_routing_picks_the_backward_pair_of_the_dtype(dtype, pair):
    assert backward_kernels(dtype) == pair
    kerns = (DQ_SM90_KERNEL, DKV_SM90_KERNEL, DQ_SM90_FP32_KERNEL,
             DKV_SM90_FP32_KERNEL)
    before = tuple(kern.launches for kern in kerns)
    q = torch.zeros(1, 5, 4, 32, dtype=dtype)
    kv = torch.zeros(1, 5, 2, 32, dtype=dtype)
    out, lse = flash_attention_plain(q, kv, kv)
    dq, dk, dv = flash_attention_bwd(q, kv, kv, out, lse, out)
    assert (dq.dtype, dk.dtype, dv.dtype) == (dtype,) * 3
    assert tuple(kern.launches for kern in kerns) == before
    assert all(kern._fn is None for kern in kerns)


def test_the_four_backward_kernels_have_their_own_sources():
    kerns = (DQ_SM90_KERNEL, DKV_SM90_KERNEL, DQ_SM90_FP32_KERNEL,
             DKV_SM90_FP32_KERNEL)
    assert [kern.source.name for kern in kerns] == [
        "flash_bwd_dq_sm90.cu", "flash_bwd_dkv_sm90.cu",
        "flash_bwd_dq_sm90_fp32.cu", "flash_bwd_dkv_sm90_fp32.cu"]
    assert all(kern.source.is_file() for kern in kerns)
    assert len({kern.symbol for kern in kerns}) == 4


@pytest.mark.parametrize("kern", [DQ_SM90_KERNEL, DKV_SM90_KERNEL,
                                  DQ_SM90_FP32_KERNEL, DKV_SM90_FP32_KERNEL],
                         ids=lambda kern: kern.name)
def test_backward_abi_takes_dv(kern):
    """One ABI for the four backward kernels: 8 pointers, then B, Sq, Skv,
    H, K, D, Dv, causal and the kernel's two tiles as ints (dq: block_q,
    block_k; dk/dv: block_k, block_q), then the stream; the C entry in the
    source declares the same ints in that order."""
    assert kern.argtypes == [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    src = kern.source.read_text()
    decl = re.search(rf'extern "C" int {kern.symbol}\(([^)]*)\)', src).group(1)
    ints = re.findall(r"\bint (\w+)", decl)
    tiles = ["block_q", "block_k"] if "_dq_" in kern.name else ["block_k", "block_q"]
    assert ints == ["B", "Sq", "Skv", "H", "K", "D", "Dv", "causal"] + tiles
