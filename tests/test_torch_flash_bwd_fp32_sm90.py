"""The arithmetic of the Hopper fp32 flash-attention backward
(``csrc/flash_bwd_dq_sm90_fp32.cu`` and ``csrc/flash_bwd_dkv_sm90_fp32.cu``),
modelled on the CPU, against the port's plain backward and the JAX
package's Pallas backward (interpret mode); and the fp32 routing of
``flash_attention_bwd``.

The model does what the kernels do, tile by tile: each of the five
products (S = Q K^T, dP = dO V^T, dQ = dS K, dV = P^T dO, dK = dS^T Q) as
three tf32 products, a_hi b_lo + a_lo b_hi + a_hi b_hi, summed in fp32
(``_product`` of the fp32 forward's model); p = exp2(s D^-0.5 log2(e) -
lse log2(e)) from the forward's lse, 0 where masked; ds = p (dp - Dvec)
D^-0.5 in fp32.  dq walks 32-key tiles in order, dk/dv 16-query steps (the
query tiles in order and, inside each, the G q-heads of the kv-head in
order); each tile's or step's product is summed apart and added to the
running sum in fp32 (the kernels' fresh accumulators).  The kernels pair
dS's (and P^T's) registers with K^T's keys (dO^T's and Q^T's queries)
through an 8-row permutation (``_transposed_slot``); the model takes each
of those products over its rows in that order.  V, dO, dV and the
transposed dO^T are Dv wide, Q, K, dQ, dK and Q^T D wide (MLA's (96, 64));
at D = 96 a row is three 128-byte atoms, and the layout tests below mirror
the kernels' loops and offsets at each width.

The element check is chip_smoke.py's for fp32 gradients: |got - ref| <=
1e-4 (BWD_ATOL, with no relative part in fp32).  Phase 7 of chip_smoke.py
also holds a full-width fp32 training step's gradients to a relative
difference of 1e-5 (``GRAD_LIMIT``), a norm over each parameter group;
the model's ||got - ref|| / ||ref|| of dq, dk and dv stands for it here.
Against the Pallas backward the tolerance is the reference's own fp32 one,
1e-3 (tests/test_kernels_flash_bwd.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_fp32_sm90 import (_a_slot_key, _key_order, _product, _tf32,
                                        _tma_offset)

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
def _one_thread():
    """One intra-op thread for each test here, as in the other
    tight-tolerance port tests; the previous count afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


DQ_BK = 32    # dq: keys per tile
DKV_BQ = 16   # dk/dv: queries per step
BWD_ATOL = 1e-4
GRAD_LIMIT = 1e-5
LOG2E = np.float32(1.4426950408889634)
PRODUCTS = ("s", "dp", "dq", "dv", "dk")

CASES = [
    # (B, Sq, Skv, H, K, D, Dv, causal)
    (1, 512, 512, 4, 2, 128, 128, True),
    (2, 13, 13, 4, 2, 64, 64, True),
    (1, 130, 70, 4, 4, 32, 32, True),
    (1, 100, 37, 4, 2, 64, 64, False),
    (1, 96, 160, 4, 1, 32, 32, True),
    # D = 96: phi-3's (96, 96), minicpm3's MLA (96, 64)
    (1, 256, 256, 4, 2, 96, 96, True),
    (2, 13, 13, 4, 2, 96, 96, True),     # ragged
    (1, 256, 256, 4, 2, 96, 64, True),
    (1, 96, 160, 4, 1, 96, 64, True),    # Sq < Skv
    (1, 100, 37, 4, 2, 96, 64, False),   # non-causal, Sq > Skv
]


def _numpy_inputs(case, seed=0):
    B, Sq, Skv, H, K, D, Dv, _ = case
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, np.float32)
                 for shape in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, Dv),
                               (B, Sq, H, Dv)))


def _inputs(case, seed=0):
    """fp32 q, k, v, dO and the forward's (out, lse) for them."""
    q, k, v, g = (torch.from_numpy(x) for x in _numpy_inputs(case, seed))
    out, lse = flash_attention_plain(q, k, v, causal=case[-1])
    return q, k, v, out, lse, g


def fp32_bwd_model(q, k, v, out, lse, g, *, causal=True, terms=None):
    """The kernels' arithmetic on fp32 q (B,Sq,H,D), dO (B,Sq,H,Dv), k
    (B,Skv,K,D), v (B,Skv,K,Dv), the forward's out and lse: returns (dq, dk,
    dv), fp32.  ``terms`` maps
    a product of ``PRODUCTS`` to its tf32 terms (3 unless given; 2 drops
    a_hi b_lo, 1 keeps a_hi b_hi alone)."""
    terms = {**dict.fromkeys(PRODUCTS, 3), **(terms or {})}
    B, Sq, H, D = q.shape
    Skv, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // K
    root = np.sqrt(np.float32(D), dtype=np.float32)
    scale_log2, scale = float(LOG2E / root), float(np.float32(1.0) / root)
    qf = q.reshape(B, Sq, K, G, D)
    gf = g.reshape(B, Sq, K, G, Dv)
    # Dvec in the dq kernel's prologue; lse as a base-2 exponent
    dvec = (g * out).sum(-1).permute(0, 2, 1).reshape(B, K, G, Sq)
    l2 = (lse * float(LOG2E)).reshape(B, K, G, Sq)
    qpos, kpos = torch.arange(Sq), torch.arange(Skv)

    def p_ds(s, dp, l2_, dvec_, qp, kp):  # s, dp (..., queries, keys)
        p = torch.exp2(s * scale_log2 - l2_[..., None])
        if causal:
            p = torch.where(kp[None, :] <= qp[:, None], p, 0.0)
        return p, p * (dp - dvec_[..., None]) * scale

    dq = torch.zeros(B, K, G, Sq, D)
    for k0 in range(0, Skv, DQ_BK):
        kt, vt = k[:, k0:k0 + DQ_BK], v[:, k0:k0 + DQ_BK]
        s = _product("bqkgd,bnkd->bkgqn", qf, kt, terms["s"])
        dp = _product("bqkgd,bnkd->bkgqn", gf, vt, terms["dp"])
        _, ds = p_ds(s, dp, l2, dvec, qpos, kpos[k0:k0 + DQ_BK])
        order = torch.tensor(_key_order(kt.shape[1]))
        dq = dq + _product("bkgqn,bnkd->bkgqd", ds[..., order], kt[:, order],
                           terms["dq"])

    dk = torch.zeros(B, Skv, K, D)
    dv = torch.zeros(B, Skv, K, Dv)
    for q0 in range(0, Sq, DKV_BQ):
        for gi in range(G):
            rows = slice(q0, q0 + DKV_BQ)
            qt, gt = qf[:, rows, :, gi], gf[:, rows, :, gi]  # (B, n, K, D)
            st = _product("bskd,bnkd->bkns", k, qt, terms["s"])  # queries, keys
            dpt = _product("bskd,bnkd->bkns", v, gt, terms["dp"])
            p, ds = p_ds(st, dpt, l2[:, :, gi, rows], dvec[:, :, gi, rows],
                         qpos[rows], kpos)
            order = torch.tensor(_key_order(qt.shape[1]))
            dv = dv + _product("bkns,bnkd->bskd", p[:, :, order], gt[:, order],
                               terms["dv"])
            dk = dk + _product("bkns,bnkd->bskd", ds[:, :, order], qt[:, order],
                               terms["dk"])
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return dq, dk, dv


def _beyond(got, ref):
    """(elements beyond the check, largest |got - ref| / BWD_ATOL,
    ||got - ref|| / ||ref||)."""
    diff = (got - ref).abs()
    return (int((diff > BWD_ATOL).sum()), diff.max().item() / BWD_ATOL,
            ((got - ref).norm() / ref.norm()).item())


@pytest.mark.parametrize("case", CASES)
def test_model_matches_plain_elementwise(case):
    q, k, v, out, lse, g = _inputs(case)
    causal = case[-1]
    got = fp32_bwd_model(q, k, v, out, lse, g, causal=causal)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape
        n, worst, rel = _beyond(a, b)
        assert n == 0 and rel <= GRAD_LIMIT / 5, (name, n, worst, rel)


@pytest.mark.parametrize("product", PRODUCTS)
@pytest.mark.parametrize("n_terms", [1, 2])
def test_fewer_than_three_terms_move_the_gradients(product, n_terms):
    """Why each of the five products takes three tf32 terms: with one or two
    in any one of them, a gradient it feeds moves ~2^-11 relative from the
    plain backward, far beyond phase 7's 1e-5, and puts thousands of its
    elements beyond the element check; with three in all, ~1.2e-6, the
    floor of fp32 summation order (test_model_matches_plain_elementwise).  S and dP feed all three
    gradients (through p and ds), dP two, the other products one each."""
    q, k, v, out, lse, g = _inputs(CASES[0])
    ref = flash_attention_bwd_plain(q, k, v, out, lse, g, causal=True)
    got = fp32_bwd_model(q, k, v, out, lse, g, causal=True,
                         terms={product: n_terms})
    fed = {"s": "dq dk dv", "dp": "dq dk", "dq": "dq", "dv": "dv", "dk": "dk"}
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        n, _, rel = _beyond(a, b)
        if name in fed[product].split():
            assert rel > 20 * GRAD_LIMIT and n > 1000, (name, n, rel)
        else:
            assert rel <= GRAD_LIMIT / 5 and n == 0, (name, n, rel)


def test_inputs_below_tf32_precision_move_the_gradients():
    """The card's test of the lo terms (tests/test_torch_cuda.py) feeds
    inputs that differ only below tf32's mantissa: the gradients of the two
    differ well beyond the check, so a kernel that dropped the lo terms
    fails there; the model holds both."""
    case = (1, 256, 256, 4, 2, 128, 128, True)
    full = [torch.from_numpy(x) for x in _numpy_inputs(case, seed=3)]
    hi = [_tf32(x) for x in full]
    refs, models = [], []
    for q, k, v, g in (full, hi):
        out, lse = flash_attention_plain(q, k, v, causal=True)
        refs.append(flash_attention_bwd_plain(q, k, v, out, lse, g, causal=True))
        models.append(fp32_bwd_model(q, k, v, out, lse, g, causal=True))
    for a, b in zip(*refs):
        assert _beyond(a, b)[0] > 1000
    for got, ref in zip(models, refs):
        for a, b in zip(got, ref):
            assert _beyond(a, b)[0] == 0


def _transposed_slot(row):
    """The k slot at which a transposed tile (K^T in dq, Q^T and dO^T in
    dk/dv; sm90.cuh's transpose_split_tf32) holds row ``row`` of the tile
    TMA brought: row 8g + 2i + e at slot 8g + 4e + i."""
    g, r = divmod(row, 8)
    return 8 * g + 4 * (r % 2) + r // 2


@pytest.mark.parametrize("rows", [DQ_BK, DKV_BQ])
def test_ds_and_p_registers_meet_their_own_rows(rows):
    """The permutation: in every 8-row group, the row (key in dq, query in
    dk/dv) a thread's A-fragment slot holds, its accumulator column, is the
    row the transposed B tile holds at that slot, so each ds (and p) meets
    its own k (dO, q); and the transposed order covers every row once."""
    for t in range(4):
        for slot in (t, t + 4):
            row = _a_slot_key(t, slot)
            assert _transposed_slot(row) == slot
    assert sorted(_transposed_slot(r) for r in range(rows)) == list(range(rows))
    # the model takes each product over its rows in the kernels' order
    assert [_transposed_slot(r) for r in _key_order(rows)] == list(range(rows))


@pytest.mark.parametrize("rows", [DQ_BK, DKV_BQ])
def test_transposed_tiles_are_the_swizzled_k_major_layout(rows):
    """The byte offset at which transpose_split_tf32 writes element (d,
    slot) of a transposed tile (rows of ``rows`` fp32: 128 bytes at 32, 64
    at 16) is that of the K-major layout a wgmma descriptor of
    ``desc_k_tf32<rows>`` reads: CUTLASS's Swizzle<3,4,3> (128-byte) or
    Swizzle<2,4,3> (64-byte) of the row-major offset; and the 16-byte
    chunks a warp writes at once fall in distinct banks."""
    rb = rows * 4
    bits = 3 if rb == 128 else 2

    def swizzle(off):  # CuTe's Swizzle<bits, 4, 3> on a byte offset
        return off ^ (((off >> 7) & ((1 << bits) - 1)) << 4)

    def kernel_offset(d, slot):  # sm90.cuh's transpose_split_tf32
        chunk = slot // 4
        return d * rb + ((chunk ^ ((d * rb >> 7) & (rb // 16 - 1))) * 16) + slot % 4 * 4

    seen = set()
    for d in range(128):
        for slot in range(rows):
            off = kernel_offset(d, slot)
            assert off == swizzle(d * rb + slot * 4)
            seen.add(off)
    assert seen == set(range(0, 128 * rb, 4))
    # a warp's 16-byte stores, 8 lanes (d = 8w .. 8w + 7) a phase, of one chunk
    for chunk in range(rb // 16):
        for w in range(4):
            banks = [kernel_offset(d, 4 * chunk) // 4 % 32 for d in range(8 * w, 8 * w + 8)]
            assert sorted(b + i for b in banks for i in range(4)) == list(range(32))


def _transpose_split(d, rows):
    """sm90.cuh's transpose_split_tf32<D, ROWS> over one tile, warp step by
    warp step and lane by lane: for each element, (the byte it reads from
    the tile TMA wrote, the (row, column) ``_tma_offset`` puts there, the
    byte of the transposed tile it writes, the transposed (row, k slot) of
    that byte)."""
    rb = rows * 4
    seen = []
    for u in range(d * rows // 128):
        atom, g, e = u // (rows // 4), u % (rows // 4) // 2, u % 2
        for lane in range(32):
            col = atom * rows * 128 + (lane % 4) * 4
            dd = 32 * atom + lane
            toff = dd * rb + ((2 * g + e) ^ ((dd * rb >> 7) & (rb // 16 - 1))) * 16
            for i in range(4):
                row = 8 * g + 2 * i + e
                src = col + row * 128 + ((lane // 4) ^ (row % 8)) * 16
                seen.append((src, (row, dd), toff + 4 * i, (dd, 8 * g + 4 * e + i)))
    return seen


@pytest.mark.parametrize("d, rows", [(96, DQ_BK), (96, DKV_BQ), (64, DKV_BQ), (128, DKV_BQ)])
def test_split_transpose_reads_each_atom_and_writes_the_swizzled_layout(d, rows):
    """transpose_split_tf32 at three atoms (K^T in dq, Q^T in dk/dv at D =
    96) and at MLA's dO^T (64 rows): every element of the tile is read
    once, from where TMA wrote it, and lands at its permuted k slot in the
    swizzled K-major layout the descriptors read (the byte-level check of
    test_transposed_tiles_are_the_swizzled_k_major_layout, at this many
    rows); every byte of the transposed tile is written once."""
    rb = rows * 4
    bits = 3 if rb == 128 else 2
    seen = _transpose_split(d, rows)
    assert len(seen) == d * rows
    reads = {src: what for src, what, _, _ in seen}
    assert len(reads) == d * rows
    assert all(_tma_offset(row, col, rows) == src for src, (row, col) in reads.items())
    for _, (row, col), dst, (t_row, slot) in seen:
        assert t_row == col and slot == _transposed_slot(row)
        off = t_row * rb + slot * 4
        assert dst == off ^ (((off >> 7) & ((1 << bits) - 1)) << 4)
    assert sorted(dst for *_, dst, _ in seen) == list(range(0, d * rb, 4))


@pytest.mark.parametrize("d, dv", [(32, 32), (64, 64), (96, 96), (96, 64), (128, 128)])
def test_transposed_halves_and_parts_start_on_the_swizzle_period(d, dv):
    """Where a wgmma descriptor starts inside a transposed tile, it starts
    on the swizzle's period (8 rows), so no base offset is needed: dk/dv's
    warpgroup halves of Q^T (D/2 rows) and dO^T (Dv/2 rows) of 64-byte rows
    (period 512 bytes; 3,072 bytes in at D = 96), each half a form of
    sm90.cuh (n48 at 96); dq's parts of K^T (NH = 2 at D > 64: 48 rows at
    96) of 128-byte rows (period 1024).  And every buffer of both kernels
    lies on a 1024-byte boundary, their shared memory at 128 columns the
    224 KB their sources state."""
    for width in (d, dv):
        half = width // 2
        assert half in (16, 32, 48, 64)
        assert half * DKV_BQ * 4 % 512 == 0
    parts = 2 if d > 64 else 1
    assert d // parts in (16, 32, 48, 64)
    assert all(p * (d // parts) * DQ_BK * 4 % 1024 == 0 for p in range(parts))

    def tile(width, rows):
        return rows * width * 4

    dq = [tile(d, 64), tile(d, 64), tile(dv, 64), tile(dv, 64), tile(d, DQ_BK),
          tile(dv, DQ_BK), tile(d, DQ_BK), tile(dv, DQ_BK), tile(d, DQ_BK), tile(d, DQ_BK)]
    dkv = [tile(d, 64), tile(d, 64), tile(dv, 64), tile(dv, 64), tile(d, DKV_BQ),
           tile(dv, DKV_BQ)] + [tile(w, DKV_BQ) for w in (d, d, dv, dv, d, d, dv, dv)]
    dkv.append(2 * 2 * (DKV_BQ // 2) * 128 * 4)  # the swap of S^T and dP^T halves
    for sizes in (dq, dkv):
        assert all(sum(sizes[:i]) % 1024 == 0 for i in range(len(sizes) + 1))
    if (d, dv) == (128, 128):
        assert sum(dq) == sum(dkv) == 224 * 1024


@pytest.mark.parametrize("case", CASES)
def test_model_matches_pallas_reference(case):
    B, Sq, Skv, H, K, D, Dv, causal = case
    qn, kn, vn, gn = _numpy_inputs(case, seed=1)
    qj, kj, vj, gj = (jnp.asarray(x) for x in (qn, kn, vn, gn))
    bq = 64 if Sq % 64 == 0 else Sq
    bk = 64 if Skv % 64 == 0 else Skv
    out_j, lse_j = jax_fwd(qj, kj, vj, causal=causal, block_q=bq, block_k=bk,
                           interpret=True, return_lse=True)
    ref = jax_bwd(qj, kj, vj, out_j, lse_j, gj, causal=causal, block_q=bq,
                  block_k=bk, interpret=True)
    got = fp32_bwd_model(*(torch.from_numpy(x) for x in (qn, kn, vn)),
                         torch.from_numpy(np.array(out_j)),
                         torch.from_numpy(np.array(lse_j)), torch.from_numpy(gn),
                         causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3,
                                   rtol=1e-3, err_msg=name)


def test_routing_picks_the_fp32_pair():
    """fp32 goes to the Hopper fp32 pair; a CPU call takes the plain
    backward: no library is loaded and no launch is counted."""
    assert backward_kernels(torch.float32) == (DQ_SM90_FP32_KERNEL,
                                               DKV_SM90_FP32_KERNEL)
    q, k, v, out, lse, g = _inputs(CASES[1])
    kerns = (DQ_SM90_KERNEL, DKV_SM90_KERNEL, DQ_SM90_FP32_KERNEL,
             DKV_SM90_FP32_KERNEL)
    before = tuple(kern.launches for kern in kerns)
    got = flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, g, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert tuple(kern.launches for kern in kerns) == before
    assert all(kern._fn is None for kern in kerns)


def test_the_fp32_pair_has_its_own_sources():
    pair = (DQ_SM90_FP32_KERNEL, DKV_SM90_FP32_KERNEL)
    assert [kern.source.name for kern in pair] == [
        "flash_bwd_dq_sm90_fp32.cu", "flash_bwd_dkv_sm90_fp32.cu"]
    assert all(kern.source.is_file() for kern in pair)
    assert len({kern.symbol for kern in pair + (DQ_SM90_KERNEL, DKV_SM90_KERNEL)}) == 4
    # the CUDA-core fp32 pair they replace is gone
    csrc = DQ_SM90_FP32_KERNEL.source.parent
    assert not (csrc / "flash_bwd_dq.cu").exists()
    assert not (csrc / "flash_bwd_dkv.cu").exists()


if __name__ == "__main__":
    # The table of terms in the kernels' source notes: for each product at
    # one and at two tf32 terms (the others at three), then all at three,
    # the elements of dq, dk, dv beyond the element check and their
    # relative differences from the plain backward, at CASES[0], numpy
    # seed 0.
    torch.set_num_threads(1)
    q, k, v, out, lse, g = _inputs(CASES[0])
    ref = flash_attention_bwd_plain(q, k, v, out, lse, g, causal=True)
    configs = [{p: n} for p in PRODUCTS for n in (1, 2)] + [{}]
    for terms in configs:
        got = fp32_bwd_model(q, k, v, out, lse, g, causal=True, terms=terms)
        label = ", ".join(f"{p} {n}" for p, n in terms.items()) or "all 3"
        cells = []
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            n, worst, rel = _beyond(a, b)
            cells.append(f"{name} {n:,} beyond (worst {worst:.3f}), rel {rel:.2e}")
        print(f"{label:>6}: " + "; ".join(cells))
