"""The port's autotuning farm (``repro_torch.tune``) against the reference's
(``repro.tune``), on the CPU.

Carries the cases of ``tests/test_tune.py`` through the port; where a case
holds a contract the two packages share, it runs through both on the same
seeds:

- **static pruning invariant**: every candidate ``search_space`` returns
  passes ``validate_config``, for each port family and backend, fuzzed
  over shapes; the ``"torch"`` spaces (the chunked paths) are the
  reference's candidate lists in the reference's order;
- **typed validation**: a well-formed tile that doesn't fit the shape
  degrades to one that does, a malformed one raises
  :class:`KernelConfigError`, also at the wrappers' own resolution;
- **cache**: round-trip through JSON, shape bucketing, merge-on-write
  under concurrent writers, ``best_config``'s memo and the wrappers'
  ``ConfigProbe`` (keyed on raw dims; invalidated by ``put`` and by
  another cache);
- **measurement**: a bad candidate fails its task, not its worker;
  ``scripted_cost_us`` is the reference's, value for value, on the
  reference's knobs;
- **tuner**: two same-seed ``sim://`` sweeps pick byte-identical winners
  and emit identical ``tune-*`` streams, and the port's ``xla_flash``
  summary equals the reference's apart from the backend key;
- **dispatch through a reloaded cache**: ``chunked_attention``'s chunks
  (windowed dispatch) and ``mamba_scan_plain``'s chunk on CPU tensors,
  against the reference's outputs at 2e-5 and 1e-4 (its own tolerances);
- **Hopper spaces**: pruned by ``smem_bytes`` (227 KB a block) and by
  registers, each space's default equal to the kernels' own tiles as the
  CUDA sources spell them; the port imports no ``jax``.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.tune as rtune
import repro_torch.tune as ptune
from repro.obs import Observability as RObs
from repro.sim import SimCluster as RSim
from repro_torch.obs import Observability as PObs
from repro_torch.sim import SimCluster as PSim
from repro_torch.tune import (KernelConfigError, KernelTuner, TuningCache,
                              best_config, measure_candidate, resolve_config,
                              scripted_cost_us, search_space, set_cache,
                              validate_config)
from repro_torch.tune import space

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
PACKAGES = {"repro": rtune, "repro_torch": ptune}
# the backend key each package writes for the chunked paths
CHUNKED = {"repro": "xla", "repro_torch": "torch"}

QWEN3 = {"B": 4, "Sq": 512, "Skv": 512, "H": 16, "K": 8, "D": 128, "Dv": 128}
SHAPES = {
    # (family, backend, dtype): the shape its space is swept at
    ("flash_fwd", "cuda", "bfloat16"): QWEN3,
    ("flash_fwd", "cuda", "float32"): QWEN3,
    ("flash_bwd", "cuda", "bfloat16"): dict(QWEN3, H=40),
    ("flash_bwd", "cuda", "float32"): QWEN3,
    ("decode", "cuda", "bfloat16"): {"B": 4, "S": 576, "H": 16, "K": 8, "D": 128,
                                     "Dv": 128},
    ("mamba", "cuda", "float32"): {"b": 4, "s": 512, "d": 8192, "n": 16},
    ("mamba", "torch", "float32"): {"b": 2, "s": 1024, "d": 128, "n": 16},
    ("xla_flash", "torch", "float32"): {"B": 1, "Sq": 1024, "Skv": 1024, "H": 8,
                                        "K": 2, "D": 64, "Dv": 64},
}
SIM_SHAPE = {"B": 1, "Sq": 1024, "Skv": 1024, "H": 8, "K": 2, "D": 64, "Dv": 64}


@pytest.fixture(autouse=True)
def _no_ambient_cache():
    """Tests control the active cache of both packages explicitly."""
    prev = set_cache(None), rtune.set_cache(None)
    yield
    set_cache(prev[0])
    rtune.set_cache(prev[1])


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, as in the other
    tight-tolerance port tests; the previous count afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------- search space / static pruning ---------------------- #

@pytest.mark.parametrize("key", list(SHAPES), ids="-".join)
def test_search_space_never_emits_invalid(key):
    kernel, backend, dtype = key
    cands, pruned = search_space(kernel, SHAPES[key], dtype, backend)
    assert cands, f"{key}: empty space"
    assert pruned >= 0
    for cand in cands:
        validate_config(kernel, SHAPES[key], cand, backend, dtype)  # must not raise


@pytest.mark.parametrize("key", list(SHAPES), ids="-".join)
def test_search_space_fuzzed_shapes(key):
    kernel, backend, dtype = key
    rng = np.random.default_rng(7)
    for _ in range(10):
        shape = dict(SHAPES[key])
        for name in shape:
            if name in ("Sq", "Skv", "S", "s"):
                shape[name] = int(rng.choice([13, 128, 192, 384, 1024, 1536]))
            elif name in ("B", "b"):
                shape[name] = int(rng.integers(1, 5))
            elif name == "H":
                shape[name] = shape["K"] * int(rng.integers(1, 9))
            elif name == "n":
                shape[name] = int(rng.choice([4, 8, 16, 32]))
        cands, _ = search_space(kernel, shape, dtype, backend)
        assert cands, (key, shape)
        for cand in cands:
            validate_config(kernel, shape, cand, backend, dtype)


@pytest.mark.parametrize("kernel", ["xla_flash", "mamba"])
def test_chunked_spaces_are_the_references(kernel):
    """The port's "torch" spaces keep the reference's candidates in its
    order; the scan's drops ``block_d`` (the plain scan has no channel
    blocks), keeping the reference's chunks."""
    shape = SHAPES[(kernel, "torch", "float32")]
    a, _ = search_space(kernel, shape)
    assert a == search_space(kernel, shape)[0]  # deterministic order
    ref, ref_pruned = rtune.search_space(kernel, shape)
    if kernel == "xla_flash":
        assert (a, _) == (ref, ref_pruned)
    else:
        assert [c["chunk"] for c in a] == sorted({c["chunk"] for c in ref})


@pytest.mark.parametrize("pkg", PACKAGES)
def test_resolve_block_fallback_and_typed_errors(pkg):
    tune = PACKAGES[pkg]
    assert tune.resolve_block("block_q", 128, 100) == 64
    assert tune.resolve_block("block_q", 128, 128) == 128
    assert tune.resolve_block("block_q", 128, 4096) == 128
    assert tune.resolve_block("block_q", 48, 33) == 24  # largest divisor <= 33
    for bad in (0, -4, True, False, 64.0, "64", None):
        with pytest.raises(tune.KernelConfigError):
            tune.resolve_block("block_q", 128, bad)


@pytest.mark.parametrize("kernel, backend, dtype, shape, config, want", [
    # the chunked paths: the reference's largest-divisor rule
    ("xla_flash", "torch", "float32", dict(SIM_SHAPE, Sq=384, Skv=384),
     {"q_chunk": 512, "kv_chunk": 1024}, {"q_chunk": 384, "kv_chunk": 384}),
    ("mamba", "torch", "float32", {"b": 1, "s": 96, "d": 8, "n": 4}, {"chunk": 64},
     {"chunk": 48}),
    # the bf16 flash tiles: at most the dim rounded up to 64, at least 64
    ("flash_fwd", "cuda", "bfloat16", dict(QWEN3, Sq=13, Skv=13),
     {"block_q": 128, "block_k": 128}, {"block_q": 64, "block_k": 64}),
    ("flash_fwd", "cuda", "bfloat16", dict(QWEN3, Sq=200, Skv=70, H=40),
     {"block_q": 128, "block_k": 100}, {"block_q": 128, "block_k": 64}),
    ("flash_fwd", "cuda", "bfloat16", QWEN3, {"block_q": 32, "block_k": 64},
     {"block_q": 64, "block_k": 64}),
    # decode: 0 is choose_splits; a count past the key tiles falls to them
    ("decode", "cuda", "bfloat16", SHAPES[("decode", "cuda", "bfloat16")], {"splits": 0},
     {"splits": 8}),
    ("decode", "cuda", "bfloat16", {"B": 4, "S": 64, "H": 16, "K": 8, "D": 128},
     {"splits": 8}, {"splits": 2}),
    # the scan: 0 is the kernel's geometry
    ("mamba", "cuda", "float32", {"b": 1, "s": 8, "d": 8, "n": 16}, {"lanes": 0},
     {"lanes": 1}),
    ("mamba", "cuda", "float32", {"b": 1, "s": 8, "d": 8, "n": 32}, {"lanes": 0},
     {"lanes": 2}),
])
def test_resolve_config_degrades_like_dispatch(kernel, backend, dtype, shape, config, want):
    eff = resolve_config(kernel, shape, config, backend, dtype)
    assert eff == want
    validate_config(kernel, shape, eff, backend, dtype)


def test_reference_resolve_config_degrades_like_dispatch():
    # the shipped mamba default block_d=256 cannot tile d=64
    eff = rtune.resolve_config("mamba", {"b": 2, "s": 1024, "d": 64, "n": 16},
                               rtune.DEFAULTS["mamba"])
    assert eff == {"chunk": 256, "block_d": 64}


def test_wrappers_resolution_is_typed():
    """What the CUDA wrappers resolve before a launch, callable on the
    CPU: explicit or cached values degrade or raise as the space says."""
    from repro_torch.kernels.decode_attention.decode_attention import decode_splits
    from repro_torch.kernels.flash_attention.flash_attention import forward_tiles
    from repro_torch.kernels.mamba_scan.mamba_scan import scan_lanes

    bf = torch.bfloat16
    assert forward_tiles(bf, 4, 512, 512, 16, 8, 128, 128) == (64, 64)
    assert forward_tiles(bf, 4, 512, 512, 16, 8, 128, 128, 64, 128) == (64, 128)
    assert forward_tiles(bf, 4, 13, 13, 40, 8, 128, 128, 128, 128) == (64, 64)
    assert forward_tiles(torch.float32, 4, 512, 512, 16, 8, 128, 128) == (64, 32)
    for bad in ({"block_q": 0}, {"block_q": True}, {"block_k": -64}):
        with pytest.raises(KernelConfigError):
            forward_tiles(bf, 4, 512, 512, 16, 8, 128, 128, **bad)
    with pytest.raises(KernelConfigError, match="registers"):  # not built at G = 2
        forward_tiles(bf, 4, 512, 512, 16, 8, 128, 128, 128, 64)
    # fp32: 16-key tiles are built at D = 128, 64-key tiles take 294 KB
    assert forward_tiles(torch.float32, 4, 512, 512, 16, 8, 128, 128, 64, 16) == (64, 16)
    with pytest.raises(KernelConfigError, match="shared memory"):
        forward_tiles(torch.float32, 4, 512, 512, 16, 8, 128, 128, 64, 64)
    assert decode_splits(bf, 4, 576, 16, 8, 128, 128, 575) == 0
    assert decode_splits(bf, 4, 576, 16, 8, 128, 128, 575, 4) == 4
    assert decode_splits(bf, 4, 576, 16, 8, 128, 128, 40, 8) == 1  # 41 keys: one tile
    for bad in (9, -1, True, 2.0):
        with pytest.raises(KernelConfigError):
            decode_splits(bf, 4, 576, 16, 8, 128, 128, 575, bad)
    assert scan_lanes(torch.float32, 4, 512, 8192, 16) == 0
    assert scan_lanes(torch.float32, 4, 512, 8192, 16, 4) == 4
    for n, bad in ((16, 3), (32, 1), (32, 4), (16, True)):
        with pytest.raises(KernelConfigError):
            scan_lanes(torch.float32, 4, 512, 8192, n, bad)


# ---------------- the Hopper spaces ---------------------------------- #

def _constants(source, *names):
    text = (CSRC / source).read_text()
    return [int(re.search(rf"\b{n} = (\d+)[;,]", text).group(1)) for n in names]


def test_each_default_is_the_kernels_own_tiles():
    """The untuned configs are the tiles the CUDA sources name as their
    defaults (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K; the fp32 dq's one row
    warpgroup BQ and the fp32 dk/dv's 64 keys BKV, which tuning leaves);
    decode's 0 and the scan's 0 are the kernels' own rules."""
    bq, bk = _constants("flash_attention_sm90.cu", "DEFAULT_BLOCK_Q", "DEFAULT_BLOCK_K")
    assert space.default_config("flash_fwd", "cuda", "bfloat16") == {
        "block_q": bq, "block_k": bk} == {"block_q": 64, "block_k": 64}
    assert space.default_config("flash_fwd", "cuda", "float32") == dict(zip(
        ("block_q", "block_k"), _constants("flash_attention_sm90_fp32.cu", "DEFAULT_BLOCK_Q",
                                           "DEFAULT_BLOCK_K"))) == {"block_q": 64, "block_k": 32}
    pairs = {"bfloat16": (_constants("flash_bwd_dq_sm90.cu", "DEFAULT_BLOCK_Q",
                                     "DEFAULT_BLOCK_K"),
                          _constants("flash_bwd_dkv_sm90.cu", "DEFAULT_BLOCK_K",
                                     "DEFAULT_BLOCK_Q")),
             "float32": (_constants("flash_bwd_dq_sm90_fp32.cu", "BQ", "DEFAULT_BLOCK_K"),
                         _constants("flash_bwd_dkv_sm90_fp32.cu", "BKV", "DEFAULT_BLOCK_Q"))}
    for dtype, (dq, dkv) in pairs.items():
        assert space.default_config("flash_bwd", "cuda", dtype) == {
            "dq_block_q": dq[0], "dq_block_k": dq[1], "dkv_block_k": dkv[0],
            "dkv_block_q": dkv[1]}
    assert space.default_config("flash_bwd", "cuda", "float32") == {
        "dq_block_q": 64, "dq_block_k": 32, "dkv_block_k": 64, "dkv_block_q": 16}
    assert space.default_config("decode", "cuda") == {"splits": 0}
    assert space.default_config("mamba", "cuda") == {"lanes": 0}
    # each register rule is its kernel's admits(): the same base
    for source, base in (("flash_attention_sm90.cu", space.FLASH_REG_BASE),
                         ("flash_attention_sm90_fp32.cu", space.FP32_FWD_REG_BASE),
                         ("flash_bwd_dq_sm90.cu", space.DQ_REG_BASE),
                         ("flash_bwd_dkv_sm90.cu", space.DKV_REG_BASE),
                         ("flash_bwd_dq_sm90_fp32.cu", space.FP32_DQ_REG_BASE),
                         ("flash_bwd_dkv_sm90_fp32.cu", space.FP32_DKV_REG_BASE)):
        assert _constants(source, "REG_BASE") == [base], source
    assert _constants("decode_attention_sm90.cu", "MAX_SPLITS") == [space.MAX_SPLITS]


@pytest.mark.parametrize("key", [k for k in SHAPES if k[1] == "cuda"], ids="-".join)
def test_cuda_spaces_are_pruned_by_shared_memory(key, monkeypatch):
    """Every admitted candidate fits a block's 227 KB; with less room the
    space prunes what no longer fits, and validation names it."""
    kernel, backend, dtype = key
    shape = SHAPES[key]
    cands, _ = search_space(kernel, shape, dtype, backend)
    sizes = [space.smem_bytes(kernel, shape, c, dtype) for c in cands]
    assert all(0 < b <= space.SMEM_BYTES == 232_448 for b in sizes)
    monkeypatch.setattr(space, "SMEM_BYTES", min(sizes) - 1)
    kept, pruned = search_space(kernel, shape, dtype, backend)
    assert kept == [] and pruned >= len(cands)
    with pytest.raises(KernelConfigError, match="shared memory"):
        validate_config(kernel, shape, cands[0], backend, dtype)


def test_flash_space_follows_the_register_rule():
    """Two q-heads a block (G even) at D = 128: 128 query rows would be a
    512-thread block, 128 registers a thread, too few; one q-head a block
    takes all four tiles.  Today's tiles are always built."""
    g2, pruned = search_space("flash_fwd", QWEN3, "bfloat16")
    assert g2 == [{"block_k": 64, "block_q": 64}, {"block_k": 128, "block_q": 64}]
    assert pruned == 2
    g5, pruned = search_space("flash_fwd", dict(QWEN3, H=40), "bfloat16")
    assert len(g5) == 4 and pruned == 0
    for D, Dv in ((32, 32), (64, 64), (96, 96), (96, 64), (128, 128)):
        for heads in (1, 2):
            assert space.flash_instantiated(D, Dv, heads, 64, 64)
            need, cap = space.flash_registers(heads, 128, 64, Dv)
            assert space.flash_instantiated(D, Dv, heads, 128, 64) == (need <= cap)
    assert not space.flash_instantiated(48, 48, 1, 64, 64)
    # the smem formula of today's tiles: the kernel's own figure, 2 q-heads
    assert space.smem_bytes("flash_fwd", QWEN3, {"block_q": 64, "block_k": 64},
                            "bfloat16") == 2 * 64 * 128 * 2 + 2 * 64 * 256 * 2 + 1024


# ---------------- the fp32 forward's and the pairs' spaces ------------ #

MINICPM3 = dict(QWEN3, H=40, K=40, D=96, Dv=64)
WHISPER = {"B": 4, "Sq": 1500, "Skv": 1500, "H": 6, "K": 6, "D": 64, "Dv": 64}
TILE_SHAPES = [("qwen3", QWEN3), ("minicpm3", MINICPM3), ("whisper", WHISPER),
               ("G=5", dict(QWEN3, H=40))]
TILE_SPACES = [("flash_fwd", "float32"), ("flash_bwd", "bfloat16"), ("flash_bwd", "float32")]


@pytest.mark.parametrize("kernel, dtype", TILE_SPACES, ids="-".join)
@pytest.mark.parametrize("label, shape", TILE_SHAPES)
def test_the_tile_spaces_admit_the_untuned_tiles(kernel, dtype, label, shape):
    """Each space at qwen3's, minicpm3's, whisper's and a G = 5 shape:
    today's tiles among its candidates, every candidate valid, and at
    qwen3's D = 128 at least two candidates."""
    cands, pruned = search_space(kernel, shape, dtype, "cuda")
    assert space.default_config(kernel, "cuda", dtype) in cands
    assert len(cands) >= 2 and pruned >= 0
    for c in cands:
        validate_config(kernel, shape, c, "cuda", dtype)
        assert space.instantiated(kernel, shape, c, dtype)


def test_the_tile_spaces_at_qwen3():
    """What qwen3's D = 128 admits: fp32 forward tiles of 16 keys or one
    32-key row warpgroup (64 x 64 and 128 x 32 take more than a block's
    shared memory); the bf16 pair's dq at 64 x 64 only (two q-heads of 128
    rows are 512 threads, 128 registers a thread; 128-key tiles 256
    registers) with dk/dv at 64 or 128 keys and 16 or 32 queries (64-query
    steps 286 registers); the fp32 pair's 16- or 32-key dq tiles and 8- or
    16-query dk/dv steps."""
    def tiles(kernel, dtype, names):
        return [tuple(c[n] for n in names) for c in search_space(kernel, QWEN3, dtype, "cuda")[0]]

    assert tiles("flash_fwd", "float32", ("block_q", "block_k")) == [(64, 16), (128, 16), (64, 32)]
    pair = ("dq_block_q", "dq_block_k", "dkv_block_k", "dkv_block_q")
    assert tiles("flash_bwd", "bfloat16", pair) == [
        (64, 64, 64, 16), (64, 64, 64, 32), (64, 64, 128, 16), (64, 64, 128, 32)]
    assert tiles("flash_bwd", "float32", pair) == [
        (64, 16, 64, 8), (64, 32, 64, 8), (64, 16, 64, 16), (64, 32, 64, 16)]


def test_tile_smem_bytes_is_the_reckoning():
    """The shared memory of each kernel at a few tiles, reckoned here
    buffer by buffer as its source lays them out, and 1,024 bytes to align
    them."""
    fp32 = lambda shape, bq, bk: space.smem_bytes(  # noqa: E731
        "flash_fwd", shape, {"block_q": bq, "block_k": bk}, "float32")
    # Q hi and lo a row warpgroup; 2 stages of K and V; K lo; V^T hi, lo
    assert fp32(QWEN3, 64, 32) == 4 * (2 * 64 * 128 + 2 * 32 * 256 + 32 * 128
                                       + 2 * 32 * 128) + 1024 == 181_248
    assert fp32(QWEN3, 128, 16) == 4 * (4 * 64 * 128 + 2 * 16 * 256 + 16 * 128
                                        + 2 * 16 * 128) + 1024 == 189_440
    assert fp32(MINICPM3, 64, 16) == 4 * (2 * 64 * 96 + 2 * 16 * 160 + 16 * 96
                                          + 2 * 16 * 64) + 1024 == 84_992
    pair = lambda shape, dt, **t: space.bwd_smem_bytes(  # noqa: E731
        shape, dict(space.default_config("flash_bwd", "cuda", dt), **t), dt)
    # fp32 dq: Q, dO hi and lo; K, V hi and lo; K^T hi and lo
    assert pair(QWEN3, "float32")["dq"] == 4 * (2 * 64 * 256 + 2 * 32 * 256
                                                + 2 * 32 * 128) + 1024 == 230_400
    assert pair(QWEN3, "float32", dq_block_k=16)["dq"] == 4 * (
        2 * 64 * 256 + 2 * 16 * 256 + 2 * 16 * 128) + 1024
    # fp32 dk/dv: K, V hi and lo; the raw stage; Q, dO hi, lo, transposed
    # hi, lo; the swap of two warpgroups' S^T and dP^T (8 queries: 4 each)
    assert pair(QWEN3, "float32", dkv_block_q=8)["dkv"] == 4 * (
        2 * 64 * 256 + 5 * 8 * 256) + 2 * 2 * 4 * 128 * 4 + 1024 == 181_248
    # bf16 dq: a (Q, dO) pair a warpgroup (2 q-heads), the 2-stage K/V ring
    assert pair(QWEN3, "bfloat16")["dq"] == 2 * (2 * 64 * 256 + 2 * 64 * 256) + 1024
    # bf16 dk/dv at 128 keys: K and V, one shared ring of 3 (Q, dO) stages
    assert pair(QWEN3, "bfloat16", dkv_block_k=128)["dkv"] == (
        2 * 128 * 256 + 3 * 2 * 32 * 256 + 1024) == 115_712
    # at 64 keys and 16 queries the two rings (48 KB) are smaller than
    # warpgroup 1's dK and dV (64 KB), which pass through them
    assert pair(QWEN3, "bfloat16", dkv_block_q=16)["dkv"] == (
        2 * 64 * 256 + (64 + 64) * 128 * 4 + 1024) == 99_328
    assert pair(QWEN3, "bfloat16")["dkv"] == 2 * 64 * 256 + 2 * 3 * 2 * 32 * 256 + 1024


def test_tile_register_rules():
    """The register rules as ptxas reported every instantiation on the
    card: the bf16 dq spills at 512 threads (two q-heads x 128 rows) but
    at D = 64 and 32 with 64-key tiles, and the bf16 dk/dv at D = 128 with
    64-query steps; the others fit.  The untuned tiles are always built."""
    bf, f32 = "bfloat16", "float32"
    base = {dt: space.default_config("flash_bwd", "cuda", dt) for dt in (bf, f32)}
    for D, Dv in ((32, 32), (64, 64)):
        g2 = {"H": 2, "K": 1, "D": D, "Dv": Dv}
        assert space.instantiated("flash_bwd", g2, dict(base[bf], dq_block_q=128), bf, "dq")
        assert not space.instantiated("flash_bwd", g2, dict(base[bf], dq_block_q=128,
                                                             dq_block_k=128), bf, "dq")
    for D, Dv in ((96, 96), (96, 64), (128, 128)):
        g2 = {"H": 2, "K": 1, "D": D, "Dv": Dv}
        need, cap = space.bwd_registers("dq", bf, g2, dict(base[bf], dq_block_q=128))
        assert cap == 128 and need > cap
        assert not space.instantiated("flash_bwd", g2, dict(base[bf], dq_block_q=128), bf, "dq")
        g1 = {"H": 1, "K": 1, "D": D, "Dv": Dv}
        assert space.instantiated("flash_bwd", g1, dict(base[bf], dq_block_q=128), bf, "dq")
    d128 = {"H": 1, "K": 1, "D": 128, "Dv": 128}
    assert not space.instantiated("flash_bwd", d128, dict(base[bf], dkv_block_q=64), bf, "dkv")
    assert space.instantiated("flash_bwd", dict(d128, D=96, Dv=96),
                              dict(base[bf], dkv_block_q=64), bf, "dkv")
    for dt in (bf, f32):
        for D, Dv in space.HEAD_PAIRS:
            shape = {"H": 2, "K": 1, "D": D, "Dv": Dv}
            assert space.instantiated("flash_bwd", shape, base[dt], dt)
            assert space.instantiated("flash_fwd", shape, {"block_q": 64, "block_k": 32}, f32)
    # no fp32 tile that fits a block's shared memory needs more registers
    # than a thread has
    for D, Dv in space.HEAD_PAIRS:
        for bq, bk in ((64, 16), (64, 64), (128, 16), (128, 32), (128, 64)):
            shape = {"H": 1, "K": 1, "D": D, "Dv": Dv}
            cfg = {"block_q": bq, "block_k": bk}
            fits = space.smem_bytes("flash_fwd", shape, cfg, f32) <= space.SMEM_BYTES
            assert space.instantiated("flash_fwd", shape, cfg, f32) == fits


def test_tile_resolution_and_validation_raise_by_name():
    """A well-formed tile the knob does not take degrades to one it does
    (at least its smallest, at most the dim rounded up to 64); a malformed
    one, or one the kernel is not built for, raises naming it."""
    cfg = resolve_config("flash_bwd", QWEN3, {"dq_block_q": 64, "dq_block_k": 48,
                                              "dkv_block_k": 64, "dkv_block_q": 12},
                         "cuda", "float32")
    assert cfg == {"dq_block_q": 64, "dq_block_k": 32, "dkv_block_k": 64, "dkv_block_q": 8}
    short = dict(QWEN3, Sq=13, Skv=13)
    cfg = resolve_config("flash_bwd", short, {"dq_block_q": 128, "dq_block_k": 128,
                                              "dkv_block_k": 128, "dkv_block_q": 64},
                         "cuda", "bfloat16")
    assert cfg == {"dq_block_q": 64, "dq_block_k": 64, "dkv_block_k": 64, "dkv_block_q": 64}
    assert resolve_config("flash_fwd", short, {"block_q": 128, "block_k": 8}, "cuda",
                          "float32") == {"block_q": 64, "block_k": 16}
    for bad in (0, True, -16, 2.0):
        with pytest.raises(KernelConfigError, match="dkv_block_q"):
            resolve_config("flash_bwd", QWEN3, {"dkv_block_q": bad}, "cuda", "bfloat16")
    with pytest.raises(KernelConfigError, match="dkv_block_q=12"):
        validate_config("flash_bwd", QWEN3, dict(space.default_config(
            "flash_bwd", "cuda", "float32"), dkv_block_q=12), "cuda", "float32")
    with pytest.raises(KernelConfigError, match="missing 'dq_block_k'"):
        validate_config("flash_bwd", QWEN3, {"dq_block_q": 64}, "cuda", "bfloat16")
    with pytest.raises(KernelConfigError, match="registers"):
        validate_config("flash_bwd", QWEN3, dict(space.default_config(
            "flash_bwd", "cuda", "bfloat16"), dq_block_k=128), "cuda", "bfloat16")
    with pytest.raises(KernelConfigError, match="shared memory"):
        validate_config("flash_fwd", QWEN3, {"block_q": 128, "block_k": 32}, "cuda",
                        "float32")


def test_scripted_cost_of_the_pairs_knobs():
    """The pair's four tiles: a cost for each candidate, finite, positive
    and seed-dependent, with one cheapest candidate (the winner successive
    halving converges on), the dq kernel's part and the dk/dv kernel's
    each moving with their own tiles."""
    cands, _ = search_space("flash_bwd", MINICPM3, "bfloat16", "cuda")
    costs = [scripted_cost_us("flash_bwd", MINICPM3, c, seed=1, noise=0.0) for c in cands]
    assert all(np.isfinite(costs)) and min(costs) > 0 and costs.count(min(costs)) == 1
    c = cands[0]
    assert (scripted_cost_us("flash_bwd", MINICPM3, c, seed=1)
            != scripted_cost_us("flash_bwd", MINICPM3, c, seed=2))
    for knob, value in (("dq_block_k", 128), ("dkv_block_k", 128)):
        other = dict(c, **{knob: value})
        assert (scripted_cost_us("flash_bwd", MINICPM3, other, noise=0.0)
                != scripted_cost_us("flash_bwd", MINICPM3, c, noise=0.0))


def test_a_flash_bwd_cache_entry_reaches_the_backward_probe(tmp_path):
    """A ``flash_bwd`` entry is what ``backward_tiles`` resolves for a
    call that names no tiles (the wrapper's probe on the call's raw dims),
    the untuned tiles on a miss and without a cache; CPU tensors still
    take the plain backward, build and launch nothing."""
    fl = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")

    bf = torch.bfloat16
    dims = tuple(QWEN3[n] for n in ("B", "Sq", "Skv", "H", "K", "D", "Dv"))
    assert fl.backward_tiles(bf, *dims) == (64, 64, 64, 32)
    assert fl.backward_tiles(torch.float32, *dims) == (64, 32, 64, 16)
    cache = TuningCache(str(tmp_path / "tune.json"))
    cache.put("flash_bwd", QWEN3, "bfloat16", "cuda",
              {"dq_block_q": 64, "dq_block_k": 64, "dkv_block_k": 128, "dkv_block_q": 16}, 1.0)
    cache.put("flash_fwd", QWEN3, "float32", "cuda", {"block_q": 128, "block_k": 16}, 1.0)
    set_cache(TuningCache(str(tmp_path / "tune.json")))  # reloaded from disk
    assert fl.backward_tiles(bf, *dims) == (64, 64, 128, 16)
    assert fl.backward_tiles(bf, *dims, dkv_block_q=32) == (64, 64, 128, 32)
    assert fl.backward_tiles(torch.float32, *dims) == (64, 32, 64, 16)  # a miss
    assert fl.forward_tiles(torch.float32, *dims) == (128, 16)
    rng = np.random.default_rng(5)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s, np.float32)) for s in
                  ((1, 9, 4, 32), (1, 9, 2, 32), (1, 9, 2, 32), (1, 9, 4, 32)))
    out, lse = fl.flash_attention_plain(q, k, v)
    kerns = fl.backward_kernels(torch.float32) + fl.backward_kernels(bf)
    before = [kern.launches for kern in kerns]
    got = fl.flash_attention_bwd(q, k, v, out, lse, g, dkv_block_q=8)
    want = fl.flash_attention_bwd_plain(q, k, v, out, lse, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [kern.launches for kern in kerns] == before
    assert all(kern._fn is None for kern in kerns)


# ---------------- cache ---------------------------------------------- #

@pytest.mark.parametrize("pkg", PACKAGES)
def test_cache_roundtrip(pkg, tmp_path):
    tune, backend = PACKAGES[pkg], CHUNKED[pkg]
    path = str(tmp_path / "tune.json")
    shape = SHAPES[("xla_flash", "torch", "float32")]
    c = tune.TuningCache(path)
    key = c.put("xla_flash", shape, "float32", backend,
                {"q_chunk": 128, "kv_chunk": 256}, 123.4, meta={"speedup": 2.0})
    reloaded = tune.TuningCache(path)
    rec = reloaded.lookup("xla_flash", shape, "float32", backend)
    assert rec["config"] == {"q_chunk": 128, "kv_chunk": 256}
    assert rec["us"] == 123.4
    assert rec["meta"]["speedup"] == 2.0
    assert key in json.load(open(path))["entries"]


def test_the_two_packages_caches_never_mix(tmp_path):
    """One file written by both: the same schema, the entries apart by
    their backend key."""
    path = str(tmp_path / "tune.json")
    shape = SHAPES[("xla_flash", "torch", "float32")]
    rtune.TuningCache(path).put("xla_flash", shape, "float32", "xla", {"q_chunk": 64}, 1.0)
    TuningCache(path).put("xla_flash", shape, "float32", "torch", {"q_chunk": 128}, 2.0)
    for tune in (rtune, ptune):
        c = tune.TuningCache(path)
        assert len(c) == 2
        assert c.lookup("xla_flash", shape, "float32", "xla")["config"] == {"q_chunk": 64}
        assert c.lookup("xla_flash", shape, "float32", "torch")["config"] == {"q_chunk": 128}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_shape_bucketing(pkg):
    tune = PACKAGES[pkg]
    # sequence/batch dims bucket to the next pow2; head dims stay exact
    assert tune.shape_bucket({"Sq": 1000, "D": 64}) == "D=64,Sq=1024"
    assert (tune.cache_key("xla_flash", {"B": 3, "Sq": 700, "D": 64}, "float32", "xla")
            == tune.cache_key("xla_flash", {"B": 4, "Sq": 1024, "D": 64}, "float32", "xla"))
    assert (tune.cache_key("xla_flash", {"Sq": 1024, "D": 64}, "float32", "xla")
            != tune.cache_key("xla_flash", {"Sq": 1024, "D": 128}, "float32", "xla"))
    assert (tune.cache_key("xla_flash", {"Sq": 1024, "D": 64}, "float32", "xla")
            != tune.cache_key("xla_flash", {"Sq": 1025, "D": 64}, "float32", "xla"))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cache_bucketed_lookup_covers_nearby_shapes(pkg, tmp_path):
    tune, backend = PACKAGES[pkg], CHUNKED[pkg]
    c = tune.TuningCache(str(tmp_path / "tune.json"))
    c.put("xla_flash", {"B": 1, "Sq": 1024, "D": 64}, "float32", backend,
          {"q_chunk": 128}, 1.0)
    # a sweep at 1024 serves a 1000-token prompt (same bucket)...
    assert c.lookup("xla_flash", {"B": 1, "Sq": 1000, "D": 64}, "float32",
                    backend) is not None
    # ...but not a 2048-token one
    assert c.lookup("xla_flash", {"B": 1, "Sq": 2048, "D": 64}, "float32",
                    backend) is None


def test_concurrent_cache_writes_lose_nothing(tmp_path):
    """16 writers with the interpreter switching threads as often as it
    can: no torn file, no lost key."""
    path = str(tmp_path / "tune.json")
    n = 16

    def writer(i):
        # D is exact in the key (not pow2-bucketed): 16 distinct keys
        c = TuningCache(path)
        c.put("xla_flash", {"Sq": 1024, "D": 8 * (i + 1)}, "float32", "torch",
              {"q_chunk": 64}, float(i))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    doc = json.load(open(path))  # valid JSON: no torn file
    assert len(doc["entries"]) == len(TuningCache(path)) == n


@pytest.mark.parametrize("pkg", PACKAGES)
def test_best_config_fallback_and_memo(pkg, tmp_path):
    tune, backend = PACKAGES[pkg], CHUNKED[pkg]
    shape = SHAPES[("xla_flash", "torch", "float32")]
    default = {"q_chunk": 512, "kv_chunk": 1024}
    # no active cache: the default comes straight back
    assert tune.best_config("xla_flash", shape, "float32", backend, default) == default
    c = tune.TuningCache(str(tmp_path / "tune.json"))
    tune.set_cache(c)
    # cache miss: default, memoized
    assert tune.best_config("xla_flash", shape, "float32", backend, default) == default
    c.put("xla_flash", shape, "float32", backend, {"q_chunk": 64}, 1.0)
    # generation bump invalidates the memo; partial entries merge over
    # the default
    cfg = tune.best_config("xla_flash", shape, "float32", backend, default)
    assert cfg == {"q_chunk": 64, "kv_chunk": default["kv_chunk"]}
    before = c.hits
    for _ in range(5):
        tune.best_config("xla_flash", shape, "float32", backend, default)
    assert c.hits == before + 5  # memoized hit path still counts


def test_config_probe_memo():
    """A wrapper's probe: the very default object with no cache; keyed on
    raw dims and the dtype as the caller has them; invalidated by a put
    and by another cache; every memo hit counted."""
    default = {"splits": 0}
    probe = ptune.cache.ConfigProbe("decode", ("B", "S", "H", "K", "D", "Dv"), "cuda",
                                    default)
    dims = (4, 576, 16, 8, 128, 128)
    assert probe(dims, torch.bfloat16) is default
    c = TuningCache()
    set_cache(c)
    assert probe(dims, torch.bfloat16) == default and c.misses == 1
    c.put("decode", dict(zip(probe.names, dims)), "bfloat16", "cuda", {"splits": 4}, 1.0,
          save=False)
    assert probe(dims, torch.bfloat16) == {"splits": 4}
    assert probe((3, 520, 16, 8, 128, 128), torch.bfloat16) == {"splits": 4}  # same bucket
    assert probe(dims, torch.float32) == default  # another dtype, another key
    hits = c.hits
    for _ in range(7):
        probe(dims, torch.bfloat16)
    assert c.hits == hits + 7
    other = TuningCache()
    set_cache(other)
    assert probe(dims, torch.bfloat16) == default


# ---------------- measurement: tasks fail, workers don't -------------- #

@pytest.mark.parametrize("pkg", PACKAGES)
def test_measure_candidate_invalid_config_fails_softly(pkg):
    res = PACKAGES[pkg].measure_candidate({
        "kernel": "xla_flash", "shape": SHAPES[("xla_flash", "torch", "float32")],
        "config": {"q_chunk": 333, "kv_chunk": 128}, "cost_model": "scripted"})
    assert res["ok"] is False
    assert res["us"] == float("inf")
    assert "KernelConfigError" in res["error"]


@pytest.mark.parametrize("payload", [
    {"kernel": "no-such-kernel", "shape": {}, "config": {}},
    {"shape": {}, "config": {}},
    {"kernel": "decode", "shape": {"S": 64}, "config": {"splits": 16}, "backend": "cuda"},
    {"kernel": "flash_fwd", "shape": QWEN3, "config": {"block_q": 128, "block_k": 64},
     "dtype": "bfloat16", "backend": "cuda"},
])
def test_measure_candidate_malformed_payload_fails_softly(payload):
    res = measure_candidate(payload)
    assert res["ok"] is False and res["us"] == float("inf")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_scripted_cost_pure_function(pkg):
    tune = PACKAGES[pkg]
    shape = SHAPES[("xla_flash", "torch", "float32")]
    cfg = {"q_chunk": 128, "kv_chunk": 256}
    a = tune.scripted_cost_us("xla_flash", shape, cfg, seed=3)
    assert a == tune.scripted_cost_us("xla_flash", shape, cfg, seed=3)
    assert a != tune.scripted_cost_us("xla_flash", shape, cfg, seed=4)


@pytest.mark.parametrize("kernel, shape", [
    ("xla_flash", SIM_SHAPE),
    ("mamba", {"b": 2, "s": 1024, "d": 128, "n": 16}),
    ("flash_fwd", {"B": 1, "Sq": 1024, "Skv": 1024, "H": 8, "K": 2, "D": 64, "Dv": 64}),
    ("decode", {"B": 2, "S": 2048, "H": 8, "K": 2, "D": 64, "Dv": 64}),
    ("flash_bwd", {"B": 1, "Sq": 1024, "Skv": 1024, "H": 8, "K": 2, "D": 64, "Dv": 64}),
])
def test_scripted_cost_equals_the_references(kernel, shape):
    """Value for value on every reference candidate: the same knobs, the
    same model, the same seed."""
    cands, _ = rtune.search_space(kernel, shape)
    assert cands
    for cfg in cands:
        for seed in (0, 3):
            assert (scripted_cost_us(kernel, shape, cfg, seed=seed)
                    == rtune.scripted_cost_us(kernel, shape, cfg, seed=seed))


@pytest.mark.parametrize("key", [("decode", "cuda", "bfloat16"), ("mamba", "cuda", "float32")],
                         ids="-".join)
def test_scripted_cost_of_the_ports_knobs(key):
    """splits and lanes: finite, positive, seed-dependent, and the
    default (0) costs what its resolved count costs, noise aside."""
    kernel, _, _ = key
    shape = SHAPES[key]
    cands, _ = search_space(*((kernel, shape) + key[2:0:-1]))
    costs = [scripted_cost_us(kernel, shape, c, seed=1, noise=0.0) for c in cands]
    assert all(np.isfinite(costs)) and min(costs) > 0 and len(set(costs)) == len(costs)
    knob = next(iter(cands[0]))
    resolved = resolve_config(kernel, shape, {knob: 0}, "cuda")
    assert (scripted_cost_us(kernel, shape, {knob: 0}, noise=0.0)
            == scripted_cost_us(kernel, shape, resolved, noise=0.0))


# ---------------- tuned dispatch numerics parity ---------------------- #

def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_dispatch_through_a_reloaded_cache_matches_the_reference(tmp_path, monkeypatch):
    """Each package tunes its own chunked paths into a cache file; a fresh
    cache reloaded from it drives dispatch: the port's windowed attention
    runs chunked_attention at the tuned chunks and the scan's plain
    version at the tuned chunk, on CPU tensors, and both agree with the
    reference's outputs (2e-5 attention, 1e-4 scan)."""
    import repro_torch.kernels as pk
    import repro_torch.models.attention as pattn
    from repro.kernels import flash_attention_dispatch as rflash
    from repro.kernels import mamba_scan_dispatch as rscan
    pscan_mod = importlib.import_module("repro_torch.kernels.mamba_scan.mamba_scan")

    B, S, H, K, D = 1, 256, 4, 2, 32
    shape = {"B": B, "Sq": S, "Skv": S, "H": H, "K": K, "D": D, "Dv": D}
    b, s, d, n = 1, 128, 8, 4
    sshape = {"b": b, "s": s, "d": d, "n": n}
    for pkg in PACKAGES:
        path = str(tmp_path / f"{pkg}.json")
        c = PACKAGES[pkg].TuningCache(path)
        c.put("xla_flash", shape, "float32", CHUNKED[pkg], {"q_chunk": 64, "kv_chunk": 128},
              1.0)
        c.put("mamba", sshape, "float32", CHUNKED[pkg], {"chunk": 32, "block_d": 8}, 1.0)
        PACKAGES[pkg].set_cache(PACKAGES[pkg].TuningCache(path))

    seen = {}
    chunked = pattn.chunked_attention

    def spy_chunked(*a, **kw):
        seen["chunks"] = (kw["q_chunk"], kw["kv_chunk"])
        return chunked(*a, **kw)

    chunk_size = pscan_mod._chunk_size

    def spy_chunk(seq, target=256):
        seen["chunk"] = target
        return chunk_size(seq, target)

    monkeypatch.setattr(pattn, "chunked_attention", spy_chunked)
    monkeypatch.setattr(pscan_mod, "_chunk_size", spy_chunk)

    q, k, v = _np(30, B, S, H, D), _np(31, B, S, K, D), _np(32, B, S, K, D)
    ref = rflash(*(jnp.asarray(x) for x in (q, k, v)), causal=True, window=S)
    out = pk.flash_attention_dispatch(*(torch.from_numpy(x) for x in (q, k, v)),
                                      causal=True, window=S)
    assert seen["chunks"] == (64, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)

    x, B_, C_ = _np(40, b, s, d), _np(41, b, s, n), _np(42, b, s, n)
    dt = np.logaddexp(0.0, _np(43, b, s, d)).astype(np.float32)
    A = -np.exp(_np(44, d, n) * 0.5)
    y_ref, h_ref = rscan(*(jnp.asarray(t) for t in (x, dt, A, B_, C_)))
    y, h = pk.mamba_scan_dispatch(*(torch.from_numpy(t) for t in (x, dt, A, B_, C_)))
    assert seen["chunk"] == 32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-4)
    assert ptune.get_cache().hits >= 2


@pytest.mark.parametrize("pkg", PACKAGES)
def test_scan_nondividing_chunk_matches_naive(pkg):
    """A chunk that doesn't tile s degrades to the largest divisor (64 ->
    48 at s = 96), exact against the step-by-step recurrence, in both
    packages; a malformed chunk raises in the port."""
    b, s, d, n = 1, 96, 8, 4
    x, B_, C_ = _np(50, b, s, d), _np(51, b, s, n), _np(52, b, s, n)
    dt = np.logaddexp(0.0, _np(53, b, s, d)).astype(np.float32)
    A = -np.exp(_np(54, d, n) * 0.5)
    if pkg == "repro":
        from repro.kernels.mamba_scan.ref import mamba_scan_naive, mamba_scan_ref

        args = [jnp.asarray(t) for t in (x, dt, A, B_, C_)]
        (y, h), (y0, h0) = mamba_scan_ref(*args, chunk=64), mamba_scan_naive(*args)
    else:
        from repro_torch.kernels.mamba_scan import mamba_scan_naive, mamba_scan_plain

        args = [torch.from_numpy(t) for t in (x, dt, A, B_, C_)]
        (y, h), (y0, h0) = mamba_scan_plain(*args, chunk=64), mamba_scan_naive(*args)
        with pytest.raises(KernelConfigError):
            mamba_scan_plain(*args, chunk=0)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y0), atol=1e-4)
    np.testing.assert_allclose(np.asarray(h), np.asarray(h0), atol=1e-4)


# ---------------- tuner on the sim:// farm ---------------------------- #

def _sim_sweep(pkg="repro_torch", seed=3, kernel="xla_flash", shape=SIM_SHAPE,
               dtype="float32", backend=None):
    obs = (PObs if pkg == "repro_torch" else RObs)()
    Sim = PSim if pkg == "repro_torch" else RSim
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    with Sim(speed_factors=[1, 1, 2, 4], seed=7, obs=obs, **kw) as cluster:
        with cluster.make_scheduler(max_batch=4) as sched:
            tuner = PACKAGES[pkg].KernelTuner(scheduler=sched,
                                              cache=PACKAGES[pkg].TuningCache())
            extra = {} if backend is None else {"backend": backend}
            r = tuner.tune(kernel, shape, dtype, cost_model="scripted", seed=seed, **extra)
    trace = [e for e in obs.events() if str(e[1]).startswith("tune-")]
    return r, trace


@pytest.mark.parametrize("kernel, shape, dtype, backend", [
    ("xla_flash", SIM_SHAPE, "float32", None),
    ("flash_fwd", dict(QWEN3, H=40), "bfloat16", "cuda"),
    ("decode", SHAPES[("decode", "cuda", "bfloat16")], "bfloat16", "cuda"),
    ("mamba", SHAPES[("mamba", "cuda", "float32")], "float32", "cuda"),
    ("flash_fwd", dict(QWEN3, H=40, K=40, D=96, Dv=64), "float32", "cuda"),
    ("flash_bwd", dict(QWEN3, H=40, K=40, D=96, Dv=64), "bfloat16", "cuda"),
    ("flash_bwd", QWEN3, "float32", "cuda"),
])
def test_sim_sweep_same_seed_identical_winner_and_trace(kernel, shape, dtype, backend):
    r1, t1 = _sim_sweep(kernel=kernel, shape=shape, dtype=dtype, backend=backend)
    r2, t2 = _sim_sweep(kernel=kernel, shape=shape, dtype=dtype, backend=backend)
    assert (json.dumps(r1.summary(), sort_keys=True)
            == json.dumps(r2.summary(), sort_keys=True))
    assert t1 == t2
    assert any(str(e[1]) == "tune-winner" for e in t1)
    # the scripted model makes the winner a pure function of the seed:
    # the global argmin survives every halving round, so it must win
    cands, _ = search_space(kernel, shape, dtype, backend)
    names = sorted(cands[0])
    expect = min(cands, key=lambda c: (scripted_cost_us(kernel, shape, c, seed=3),
                                       tuple(c[n] for n in names)))
    assert r1.config == expect


def test_sim_sweep_summary_equals_the_references():
    """The same seed through both packages: the same winner, times,
    rounds and counts; only the backend key differs."""
    mine, _ = _sim_sweep("repro_torch")
    ref, _ = _sim_sweep("repro")
    a, b = mine.summary(), ref.summary()
    assert (a.pop("backend"), b.pop("backend")) == ("torch", "xla")
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_sim_sweep_caches_winner_and_dispatch_reads_it(tmp_path):
    path = str(tmp_path / "tune.json")
    with PSim(speed_factors=[1, 1], seed=5, device="cpu") as cluster:
        with cluster.make_scheduler(max_batch=4) as sched:
            tuner = KernelTuner(scheduler=sched, cache=TuningCache(path))
            r = tuner.tune("xla_flash", SIM_SHAPE, cost_model="scripted", seed=3)
    assert r.speedup > 0 and r.failed == 0
    # fresh process-equivalent: reload from disk, dispatch must read it
    set_cache(TuningCache(path))
    got = best_config("xla_flash", SIM_SHAPE, "float32", "torch",
                      space.default_config("xla_flash", "torch"))
    assert {k: got[k] for k in r.config} == r.config


def test_tuner_bad_candidates_fail_tasks_not_workers():
    """An always-invalid candidate beside a valid one: the round completes
    and reports the failure instead of losing workers."""
    with PSim(speed_factors=[1, 1], seed=5, device="cpu") as cluster:
        with cluster.make_scheduler(max_batch=4) as sched:
            tuner = KernelTuner(scheduler=sched, cache=TuningCache())
            timed = tuner._measure_round(
                "xla_flash", SIM_SHAPE, "float32",
                [{"q_chunk": 333, "kv_chunk": 128},   # invalid
                 {"q_chunk": 128, "kv_chunk": 128}],  # valid
                1, 0, "scripted", 0, backend="torch")
    assert timed[0][0] == float("inf")
    assert np.isfinite(timed[1][0])


def test_real_sweep_on_cpu_services_times_the_plain_paths():
    """A real (not scripted) sweep of the windowed attention's chunks on
    an in-process CPU service: every candidate timed, none failed, the
    winner cached under the "torch" backend."""
    from repro_torch.core import LookupService, Service

    lookup = LookupService()
    Service(lookup, device="cpu").start()
    shape = {"B": 1, "Sq": 128, "Skv": 128, "H": 2, "K": 1, "D": 16, "Dv": 16}
    cache = TuningCache()
    with KernelTuner(lookup, cache=cache) as tuner:
        r = tuner.tune("xla_flash", shape, device="cpu", base_reps=1, full_reps=2)
    assert r.failed == 0 and np.isfinite(r.us) and np.isfinite(r.default_us)
    assert r.us <= r.default_us
    assert cache.lookup("xla_flash", shape, "float32", "torch")["config"] == r.config


def test_tune_imports_no_jax():
    code = ("import sys\n"
            "import repro_torch.tune, repro_torch.kernels\n"
            "from repro_torch.sim import SimCluster\n"
            "from repro_torch.tune import KernelTuner, TuningCache\n"
            "with SimCluster(2, seed=1, device='cpu') as c:\n"
            "    with c.make_scheduler() as s:\n"
            "        KernelTuner(scheduler=s, cache=TuningCache()).tune(\n"
            "            'decode', {'B': 1, 'S': 256, 'H': 8, 'K': 2, 'D': 64},\n"
            "            'bfloat16', cost_model='scripted')\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
