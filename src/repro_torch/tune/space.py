"""Search spaces for the kernel autotuner, with static pruning for Hopper.

One space per kernel family and backend:

    ``flash_fwd``  ``"cuda"``   the flash forward's tiles: ``block_q``
                   (64 or 128: one or two 64-row warpgroups over the query
                   rows of one q-head) and ``block_k`` (keys a K/V tile:
                   64 or 128 in bf16, 16, 32 or 64 in fp32)
    ``flash_bwd``  ``"cuda"``   the backward pair's tiles: the dq kernel's
                   ``dq_block_q`` (64 or 128 rows in bf16, 64 in fp32) and
                   ``dq_block_k`` (64 or 128 keys in bf16, 16, 32 or 64
                   in fp32), the dk/dv kernel's ``dkv_block_k`` (keys a
                   block: 64 or 128 in bf16, 64 in fp32) and
                   ``dkv_block_q`` (queries a step: 16, 32 or 64 in bf16,
                   8, 16 or 32 in fp32)
    ``decode``     ``"cuda"``   ``splits``, the KV splits of a cluster
    ``mamba``      ``"cuda"``   ``lanes``, the threads a channel of the scan
    ``mamba``      ``"torch"``  ``chunk`` of ``mamba_scan_plain`` (the
                   scan's backward on the card)
    ``xla_flash``  ``"torch"``  ``q_chunk``, ``kv_chunk`` of
                   ``chunked_attention`` (windowed attention)

The ``"torch"`` spaces are the reference package's ``xla_flash`` and
``mamba`` spaces: the same candidate lists in the same order, the same
defaults and divisibility rule (every chunk divides its sequence dim), so
a same-seed ``sim://`` sweep picks the reference's winner.  The ``mamba``
space drops the reference's ``block_d``: the plain chunked scan has no
channel blocks.

The ``"cuda"`` spaces are pruned by what a Hopper block can hold, not by
TPU VMEM: a block's dynamic shared memory at most 227 KB (232,448 B,
:func:`smem_bytes`, equal to each kernel's own query), and its registers
within the 65,536 of an SM at the kernel's ``__launch_bounds__`` (at most
255 a thread; each kernel's rule from ptxas's report of every
instantiation, the same rule its ``admits`` builds by).  Their
divisibility rules are the kernels' own: tiles of 64-row warpgroups, a
cluster of at most 8 blocks, no KV split shorter than one 32-key tile;
ragged edges are masked in the kernels, so no tile has to divide its
dim.  A candidate never reaches a farm worker unless it
passes :func:`validate_config`.

Shapes are plain dicts of named dims (``{"B": 4, "Sq": 512, ...}``) so
they serialize through the wire protocol and into the JSON cache
unchanged.
"""

from __future__ import annotations

import itertools

#: dynamic shared memory a block may take on an H100 (227 KB)
SMEM_BYTES = 232_448
#: registers of an SM, and the most one thread may take
REGISTERS, MAX_THREAD_REGISTERS = 65_536, 255
#: threads of a warpgroup
WG = 128
#: SMs of an H100 SXM, whose count decode's split rule reads on the card
SMS = 132
#: the reference's working-set cap of one chunked-attention chunk pair
#: (B H q_chunk kv_chunk fp32 scores)
XLA_FLASH_BYTES = 256 * 1024 * 1024

#: candidate block sizes of the reference's chunked paths (the port's
#: ``"torch"`` spaces keep them)
_BLOCKS = (32, 64, 128, 256, 512, 1024, 2048)
_CHUNKS = (64, 128, 256, 512, 1024, 2048, 4096)
#: the flash forward's tiles (block_q in both dtypes; block_k by dtype)
_FLASH_BLOCK_Q = (64, 128)
_FLASH_BLOCK_K = (64, 128)
_FP32_FLASH_BLOCK_K = (16, 32, 64)
#: the backward pairs' tiles by dtype: each knob's values
_BWD_TILES = {
    "bfloat16": {"dq_block_q": (64, 128), "dq_block_k": (64, 128),
                 "dkv_block_k": (64, 128), "dkv_block_q": (16, 32, 64)},
    "float32": {"dq_block_q": (64,), "dq_block_k": (16, 32, 64),
                "dkv_block_k": (64,), "dkv_block_q": (8, 16, 32)},
}
#: the dim each flash tile knob tiles
_TILE_DIM = {"block_q": "Sq", "block_k": "Skv", "dq_block_q": "Sq", "dq_block_k": "Skv",
             "dkv_block_k": "Skv", "dkv_block_q": "Sq"}
#: the (D, Dv) pairs every attention kernel takes
HEAD_PAIRS = ((32, 32), (64, 64), (96, 96), (96, 64), (128, 128))
#: the most dynamic shared memory a kernel builds an instantiation for
#: (its ``admits``; :data:`SMEM_BYTES` is the space's own bound)
_BLOCK_SMEM = 232_448
#: decode's KV splits: cluster sizes up to the portable 8; keys a tile
_SPLITS = (1, 2, 4, 8)
MAX_SPLITS, DECODE_TILE = 8, 32
#: the scan's lanes a channel, by state size
_LANES_N16, _LANES_N32 = (1, 2, 4), (2,)
MAX_STATE = 32
#: the bf16 flash forward's register need a thread: a base (addresses,
#: row state, loop) plus the O accumulator (Dv/2) plus what a 128-key
#: tile adds over a 64-key one (S and P, (block_k - 64)/2).  ptxas
#: reported 107-165 registers for today's instantiations unconstrained
#: (Dv = 32 .. 128); the base is set above that fit, so that what the
#: space admits compiles without spills (chip_smoke.py phase 23 checks).
FLASH_REG_BASE = 100
#: the same base of the other kernels' register rules (each kernel's
#: REG_BASE; what a thread needs beyond its accumulators and a tile's
#: scores and their split terms, :func:`fp32_flash_registers`,
#: :func:`bwd_registers`), set from ptxas's report of every instantiation
#: within the shared-memory bounds (chip_smoke.py phase 1's register
#: probe) so that what the spaces admit compiles without spills (phase 23
#: checks)
FP32_FWD_REG_BASE = 80
DQ_REG_BASE = 0
DKV_REG_BASE = 30
FP32_DQ_REG_BASE = 50
FP32_DKV_REG_BASE = 60

KERNELS = ("flash_fwd", "flash_bwd", "decode", "mamba", "xla_flash")

#: (kernel, backend[, dtype]) -> the hand-picked config each path shipped
#: with: the tuner's baseline and the dispatch fallback when the cache has
#: no entry; a dtype's own entry first.  The flash kernels' are their
#: untuned tiles, as the CUDA sources name them (DEFAULT_BLOCK_Q, ...).
#: decode's ``splits`` 0 and the scan's ``lanes`` 0 are the kernels' own
#: rules (``choose_splits``, ``geometry``), which :func:`resolve_config`
#: spells out.
DEFAULTS = {
    ("flash_fwd", "cuda", "bfloat16"): {"block_q": 64, "block_k": 64},
    ("flash_fwd", "cuda", "float32"): {"block_q": 64, "block_k": 32},
    ("flash_bwd", "cuda", "bfloat16"): {"dq_block_q": 64, "dq_block_k": 64,
                                        "dkv_block_k": 64, "dkv_block_q": 32},
    ("flash_bwd", "cuda", "float32"): {"dq_block_q": 64, "dq_block_k": 32,
                                       "dkv_block_k": 64, "dkv_block_q": 16},
    ("decode", "cuda"): {"splits": 0},
    ("mamba", "cuda"): {"lanes": 0},
    ("mamba", "torch"): {"chunk": 256},
    ("xla_flash", "torch"): {"q_chunk": 512, "kv_chunk": 1024},
}


class KernelConfigError(ValueError):
    """A kernel tiling config is malformed or invalid for its shape.

    Raised by :func:`validate_config` (the tuner's static pruning) and by
    the kernels' wrappers on *typed* nonsense (non-int / non-positive
    blocks) or on a config the kernel was not built for.  Shape-
    incompatible but well-typed blocks never raise at the wrappers: they
    fall back to a valid one, so a bad candidate fails its task with this
    error at validation time and can never kill a farm worker mid-sweep."""


def default_backend(kernel: str) -> str:
    """The reference's choice: the chunked paths' backend for
    ``xla_flash`` and ``mamba``, the kernels' otherwise."""
    return "torch" if kernel in ("xla_flash", "mamba") else "cuda"


def default_config(kernel: str, backend: str, dtype: str = "float32") -> dict:
    """The hand-picked config of ``kernel`` on ``backend`` in ``dtype``."""
    cfg = DEFAULTS.get((kernel, backend, dtype), DEFAULTS.get((kernel, backend)))
    if cfg is None:
        raise KernelConfigError(f"no {backend!r} space for kernel {kernel!r}")
    return dict(cfg)


def _positive_int(name: str, v) -> None:
    if isinstance(v, bool) or not isinstance(v, int):
        raise KernelConfigError(f"{name} must be a positive int, got {v!r}")
    if v <= 0:
        raise KernelConfigError(f"{name} must be positive, got {v}")


def resolve_block(name: str, dim: int, requested) -> int:
    """Typed validation + largest-valid-divisor fallback for one block of
    a chunked path.

    A well-formed block that doesn't tile ``dim`` degrades to the largest
    divisor of ``dim`` that is <= the request (always >= 1), while a
    malformed one (bool, non-int, <= 0) raises :class:`KernelConfigError`.
    """
    _positive_int(name, requested)
    b = min(requested, dim)
    while dim % b:
        b -= 1
    return b


def _dims(shape: dict, *names: str) -> list[int]:
    try:
        return [int(shape[n]) for n in names]
    except KeyError as e:
        raise KernelConfigError(f"shape is missing dim {e.args[0]!r}") from e


def _round64(n: int) -> int:
    return max(64, -(-n // 64) * 64)


def flash_heads_a_block(H: int, K: int) -> int:
    """q-heads a block of the bf16 forward: two when they share a
    kv-head (H/K even), else one (the kernel's own rule)."""
    return 2 if (H // K) % 2 == 0 else 1


def flash_registers(heads: int, block_q: int, block_k: int,
                    dv: int) -> tuple[int, int]:
    """(registers a thread needs, registers a thread may have) of the
    bf16 forward's instantiation: a block of ``heads`` x block_q/64
    warpgroups.  Today's tiles (block_q 64, block_k 64) keep their
    ``__launch_bounds__(threads, 2)``; every other instantiation takes
    ``(threads, 1)``."""
    threads = heads * (block_q // 64) * WG
    min_blocks = 2 if (block_q, block_k) == (64, 64) else 1
    cap = min(MAX_THREAD_REGISTERS, REGISTERS // (threads * min_blocks))
    return FLASH_REG_BASE + dv // 2 + (block_k - 64) // 2, cap


def flash_instantiated(D: int, Dv: int, heads: int, block_q: int,
                       block_k: int) -> bool:
    """Whether ``flash_attention_sm90.cu`` builds this instantiation: today's
    tiles always (they ran since the kernel's first Hopper version), any
    other only where its registers fit (:func:`flash_registers`); the
    kernel's ``admits`` is the same rule."""
    if (D, Dv) not in ((32, 32), (64, 64), (96, 96), (96, 64), (128, 128)):
        return False
    if heads not in (1, 2) or block_q not in _FLASH_BLOCK_Q \
            or block_k not in _FLASH_BLOCK_K:
        return False
    if (block_q, block_k) == (64, 64):
        return True
    need, cap = flash_registers(heads, block_q, block_k, Dv)
    return need <= cap


def _cap(threads: int) -> int:
    """Registers a thread may have in one block of ``threads`` an SM."""
    return min(MAX_THREAD_REGISTERS, REGISTERS // threads)


def fp32_flash_registers(block_q: int, block_k: int, dv: int) -> tuple[int, int]:
    """(registers a thread needs, registers a thread may have) of the
    fp32 forward's instantiation (``flash_attention_sm90_fp32.cu``'s
    ``admits``): a base plus O (Dv/2), the tile's fresh part of O (Dv/2
    over the parts it is summed in: two above Dv = 64) and S with P's two
    tf32 terms (3 block_k/2); block_q/64 warpgroups, one block an SM."""
    parts = 2 if dv > 64 else 1
    need = FP32_FWD_REG_BASE + dv // 2 + dv // 2 // parts + 3 * block_k // 2
    return need, _cap(block_q // 64 * WG)


def bwd_registers(part: str, dtype: str, shape: dict, config: dict) -> tuple[int, int]:
    """(registers a thread needs, registers a thread may have) of one
    kernel of the backward pair (``part`` "dq" or "dkv") at this config,
    each kernel's ``admits``: a base plus its accumulators and a tile's
    scores with their split terms.  bf16 dq: dQ (D/2), S, dP and dS's two
    terms (3 dq_block_k/2), q-heads a block x dq_block_q/64 warpgroups;
    bf16 dk/dv: dK and dV (D/2 + Dv/2), S^T, dP^T and their terms (2
    dkv_block_q), two warpgroups; fp32 dq: dQ and its fresh part (D/2 +
    D/2 over its parts), S, dP and dS's terms (2 dq_block_k), one
    warpgroup; fp32 dk/dv: a warpgroup's half of dK and dV and the larger
    fresh product (D/4 + Dv/4 + max(D, Dv)/4), S^T, dP^T and their terms
    (2 dkv_block_q), two warpgroups."""
    H, K, D = _dims(shape, "H", "K", "D")
    dv = int(shape.get("Dv", D))
    if part == "dq" and dtype == "float32":
        parts = 2 if D > 64 else 1
        need = FP32_DQ_REG_BASE + D // 2 + D // 2 // parts + 2 * config["dq_block_k"]
        return need, _cap(WG)
    if part == "dq":
        threads = flash_heads_a_block(H, K) * config["dq_block_q"] // 64 * WG
        return DQ_REG_BASE + D // 2 + 3 * config["dq_block_k"] // 2, _cap(threads)
    if dtype == "float32":
        need = (FP32_DKV_REG_BASE + D // 4 + dv // 4 + max(D, dv) // 4
                + 2 * config["dkv_block_q"])
        return need, _cap(2 * WG)
    return DKV_REG_BASE + D // 2 + dv // 2 + 2 * config["dkv_block_q"], _cap(2 * WG)


def _tiles(kernel: str, dtype: str) -> dict[str, tuple]:
    """The flash kernels' tile knobs and the values each takes."""
    if kernel == "flash_bwd":
        return _BWD_TILES[dtype]
    return {"block_q": _FLASH_BLOCK_Q,
            "block_k": _FP32_FLASH_BLOCK_K if dtype == "float32" else _FLASH_BLOCK_K}


def _untuned(kernel: str, dtype: str, config: dict, names) -> bool:
    default = DEFAULTS[(kernel, "cuda", dtype)]
    return all(config[n] == default[n] for n in names)


def instantiated(kernel: str, shape: dict, config: dict, dtype: str,
                 part: str | None = None) -> bool:
    """Whether the CUDA library builds the instantiation of these tiles at
    this shape's (D, Dv) (and q-heads a block): the untuned tiles always;
    any other where its shared memory fits a block and its registers a
    thread (each kernel's ``admits``, the same rule).  For ``flash_bwd``
    both kernels of the pair, or the one ``part`` ("dq", "dkv") names."""
    D = _dims(shape, "D")[0]
    dv = int(shape.get("Dv", D))
    if (D, dv) not in HEAD_PAIRS:
        return False
    tiles = _tiles(kernel, dtype)
    if any(config.get(n) not in values for n, values in tiles.items()):
        return False
    if kernel == "flash_fwd" and dtype != "float32":
        H, K = _dims(shape, "H", "K")
        return flash_instantiated(D, dv, flash_heads_a_block(H, K), config["block_q"],
                                  config["block_k"])
    if kernel == "flash_fwd":
        if _untuned(kernel, dtype, config, tiles):
            return True
        need, cap = fp32_flash_registers(config["block_q"], config["block_k"], dv)
        return need <= cap and smem_bytes(kernel, shape, config, dtype) <= _BLOCK_SMEM
    parts = (part,) if part else ("dq", "dkv")
    for p in parts:
        names = [n for n in tiles if n.startswith(p + "_")]
        if _untuned(kernel, dtype, config, names):
            continue
        need, cap = bwd_registers(p, dtype, shape, config)
        if need > cap or bwd_smem_bytes(shape, config, dtype)[p] > _BLOCK_SMEM:
            return False
    return True


def choose_splits(B: int, H: int, K: int, n_keys: int, sms: int = SMS) -> int:
    """decode_attention_sm90.cu's ``choose_splits``: about two blocks on
    each SM, at most 8, no split shorter than a 32-key tile."""
    G = H // K
    heads = 1 if G <= 1 else 2 if G <= 2 else 4 if G <= 4 else 8
    pairs = B * K * -(-G // heads)
    splits = min(-(-2 * sms // pairs), MAX_SPLITS, n_keys // DECODE_TILE)
    return max(splits, 1)


def scan_geometry(n: int, lanes: int = 0) -> tuple[int, int]:
    """(lanes a channel, states a lane) of mamba_scan_sm90.cu at state
    size ``n``: ``lanes`` 0 is the kernel's ``geometry`` (one lane at
    n <= 16, two above); states a lane round up to 4, 8 or 16."""
    if lanes == 0:
        lanes = 2 if n > 16 else 1
    per_lane = -(-n // lanes)
    return lanes, 4 if per_lane <= 4 else 8 if per_lane <= 8 else 16


def bwd_smem_bytes(shape: dict, config: dict, dtype: str = "float32") -> dict[str, int]:
    """Dynamic shared memory a block of each kernel of the backward pair
    takes at this config, {"dq": bytes, "dkv": bytes}: each equal to the
    kernel's own query."""
    H, K, D = _dims(shape, "H", "K", "D")
    dv = int(shape.get("Dv", D))
    dq_q, dq_k = config["dq_block_q"], config["dq_block_k"]
    kv_k, kv_q = config["dkv_block_k"], config["dkv_block_q"]
    if dtype == "float32":
        # dq: Q, dO hi and lo; K, V hi and lo; K^T hi and lo
        dq = 4 * (2 * dq_q * (D + dv) + 2 * dq_k * (D + dv) + 2 * dq_k * D) + 1024
        # dk/dv: K, V hi and lo; the TMA stage; Q, dO hi and lo and
        # transposed; the swap space of 2 warpgroups' accumulators
        dkv = (4 * (2 * kv_k * (D + dv) + 5 * kv_q * (D + dv))
               + 2 * 2 * (kv_q // 2) * WG * 4 + 1024)
        return {"dq": dq, "dkv": dkv}
    # dq: a (Q, dO) pair a warpgroup (q-heads a block x dq_q/64), the
    # K/V ring's 2 stages
    dq = 2 * (flash_heads_a_block(H, K) * dq_q * (D + dv) + 2 * dq_k * (D + dv)) + 1024
    # dk/dv: K and V, the (Q, dO) rings of 3 stages, one a warpgroup at 64
    # keys (which also hold warpgroup 1's dK and dV at the end), one shared
    # at 128
    rings = (2 if kv_k == 64 else 1) * 3 * 2 * kv_q * (D + dv)
    red = (D // 2 + dv // 2) * WG * 4 if kv_k == 64 else 0
    dkv = 2 * kv_k * (D + dv) + max(rings, red) + 1024
    return {"dq": dq, "dkv": dkv}


def smem_bytes(kernel: str, shape: dict, config: dict,
               dtype: str = "float32") -> int:
    """Dynamic shared memory a block of the CUDA kernel takes at this
    config: equal to the kernel's own query (``chip_smoke.py`` phase 23
    holds each against it).  For ``flash_bwd``, the larger of the pair's
    (:func:`bwd_smem_bytes`)."""
    if kernel == "flash_fwd":
        H, K, D = _dims(shape, "H", "K", "D")
        dv = int(shape.get("Dv", D))
        bq, bk = config["block_q"], config["block_k"]
        if dtype == "float32":
            # Q hi and lo a warpgroup, the K/V ring's 2 stages, K lo, V^T
            # hi and lo
            return 4 * (2 * bq * D + 2 * bk * (D + dv) + bk * D
                        + 2 * bk * dv) + 1024
        # one 64-row Q tile a warpgroup, the K/V ring's 2 stages
        heads = flash_heads_a_block(H, K)
        return 2 * (heads * bq * D + 2 * bk * (D + dv)) + 1024
    if kernel == "flash_bwd":
        return max(bwd_smem_bytes(shape, config, dtype).values())
    if kernel == "decode":
        # the K/V ring: 32-key tiles, 2-4 stages within 64 KB
        D = _dims(shape, "D")[0]
        tile = DECODE_TILE * D * (4 if dtype == "float32" else 2)
        stages = min(max(64 * 1024 // (2 * tile), 2), 4)
        return stages * 2 * tile
    if kernel == "mamba":
        # the tile ring: 3 stages of 16 steps of x and dt (128/lanes
        # channels) and of B and C (lanes x states a lane)
        n = _dims(shape, "n")[0]
        lanes, per_lane = scan_geometry(n, config["lanes"])
        return 3 * (2 * 16 * (WG // lanes) + 2 * 16 * lanes * per_lane) * 4
    raise KernelConfigError(f"{kernel!r} has no CUDA kernel")


def xla_flash_bytes(shape: dict, config: dict) -> int:
    """The reference's working set of a chunked-attention call: the fp32
    scores of one chunk pair."""
    b, h, _ = _dims(shape, "B", "H", "Sq")
    return 4 * b * h * config["q_chunk"] * config["kv_chunk"]


def _axes(kernel: str, shape: dict) -> dict[str, int]:
    """A ``"torch"`` space's param name -> the sequence dim it divides."""
    if kernel == "mamba":
        return {"chunk": _dims(shape, "s")[0]}
    if kernel == "xla_flash":
        sq, skv = _dims(shape, "Sq", "Skv")
        return {"q_chunk": sq, "kv_chunk": skv}
    raise KernelConfigError(f"no 'torch' space for kernel {kernel!r}")


def resolve_config(kernel: str, shape: dict, config: dict,
                   backend: str | None = None,
                   dtype: str = "float32") -> dict:
    """The *effective* config the path would run: chunks through
    :func:`resolve_block` against their dims; each flash tile to the
    largest value its knob takes at or below the request (at least the
    knob's smallest, at most the dim it tiles rounded up to 64); a KV
    split count to the key tiles (0: the kernel's ``choose_splits``);
    lanes 0 to the scan's ``geometry``.  What an untuned dispatch
    executes, so also the honest tuning baseline."""
    backend = backend or default_backend(kernel)
    out = dict(config)
    if backend == "torch":
        for name, dim in _axes(kernel, shape).items():
            if name in out:
                out[name] = resolve_block(name, dim, out[name])
        return out
    if kernel in ("flash_fwd", "flash_bwd"):
        for name, values in _tiles(kernel, dtype).items():
            if name in out:
                _positive_int(name, out[name])
                top = min(out[name], _round64(_dims(shape, _TILE_DIM[name])[0]))
                out[name] = max([v for v in values if v <= top] or [values[0]])
    elif kernel == "decode" and "splits" in out:
        B, S, H, K = _dims(shape, "B", "S", "H", "K")
        s = out["splits"]
        if isinstance(s, bool) or not isinstance(s, int) or s < 0:
            raise KernelConfigError(f"splits must be an int >= 0, got {s!r}")
        out["splits"] = (choose_splits(B, H, K, S) if s == 0
                         else min(s, max(1, S // DECODE_TILE)))
    elif kernel == "mamba" and "lanes" in out:
        lanes = out["lanes"]
        if isinstance(lanes, bool) or not isinstance(lanes, int) or lanes < 0:
            raise KernelConfigError(f"lanes must be an int >= 0, got {lanes!r}")
        if lanes == 0:
            out["lanes"] = scan_geometry(_dims(shape, "n")[0])[0]
    return out


def _check_ints(kernel: str, config: dict, names) -> None:
    for name in names:
        if name not in config:
            raise KernelConfigError(f"{kernel} config missing {name!r}")
        v = config[name]
        if isinstance(v, bool) or not isinstance(v, int) or v <= 0:
            raise KernelConfigError(
                f"{kernel}.{name} must be a positive int, got {v!r}")


def _registers_said(kernel: str, shape: dict, config: dict, dtype: str) -> str:
    """What a refused flash instantiation's registers are, in words."""
    H, K, D = _dims(shape, "H", "K", "D")
    dv = int(shape.get("Dv", D))
    if kernel == "flash_fwd" and dtype != "float32":
        heads = flash_heads_a_block(H, K)
        need, cap = flash_registers(heads, config["block_q"], config["block_k"], dv)
        return f"{heads} q-heads a block: {need} registers a thread needed, {cap} available"
    if kernel == "flash_fwd":
        need, cap = fp32_flash_registers(config["block_q"], config["block_k"], dv)
        return f"{need} registers a thread needed, {cap} available"
    return "; ".join(f"{p}: {n} registers a thread needed, {c} available"
                     for p in ("dq", "dkv")
                     for n, c in [bwd_registers(p, dtype, shape, config)])


def validate_config(kernel: str, shape: dict, config: dict,
                    backend: str | None = None,
                    dtype: str = "float32") -> None:
    """Raise :class:`KernelConfigError` unless ``config`` is exactly
    runnable on ``shape``: on ``"torch"``, every chunk a positive int that
    divides its dim (and chunked attention's working set under the
    reference's cap); on ``"cuda"``, the kernel's own tile rules, its
    registers and its shared memory."""
    backend = backend or default_backend(kernel)
    if backend == "torch":
        axes = _axes(kernel, shape)
        _check_ints(kernel, config, axes)
        for name, dim in axes.items():
            v = config[name]
            if v > dim or dim % v:
                raise KernelConfigError(
                    f"{kernel}.{name}={v} does not tile dim {dim}")
        if kernel == "xla_flash" and xla_flash_bytes(shape, config) > XLA_FLASH_BYTES:
            raise KernelConfigError(
                f"{kernel} config {config} working set {xla_flash_bytes(shape, config)} "
                f"B exceeds budget {XLA_FLASH_BYTES} B")
        return
    if backend != "cuda":
        raise KernelConfigError(f"unknown backend {backend!r}")
    if kernel in ("flash_fwd", "flash_bwd"):
        tiles = _tiles(kernel, dtype)
        _check_ints(kernel, config, tiles)
        for name, values in tiles.items():
            v, dim = config[name], _dims(shape, _TILE_DIM[name])[0]
            if v not in values or v > _round64(dim):
                raise KernelConfigError(
                    f"{kernel}.{name}={v} in {dtype}: one of {values}, at most "
                    f"{_round64(dim)} at {_TILE_DIM[name]}={dim}")
        D = _dims(shape, "D")[0]
        dv = int(shape.get("Dv", D))
        if (D, dv) not in HEAD_PAIRS:
            raise KernelConfigError(f"{kernel} has no kernel at (D, Dv) = ({D}, {dv})")
        bytes_ = smem_bytes(kernel, shape, config, dtype)
        if bytes_ > SMEM_BYTES:
            raise KernelConfigError(
                f"{kernel} config {config}: {bytes_} B of shared memory a block, "
                f"beyond {SMEM_BYTES} B")
        if not instantiated(kernel, shape, config, dtype):
            raise KernelConfigError(
                f"{kernel} config {config} in {dtype} at (D, Dv) = ({D}, {dv}): "
                + _registers_said(kernel, shape, config, dtype) + " (not built)")
        return
    elif kernel == "decode":
        _check_ints(kernel, config, ("splits",))
        s, S = config["splits"], _dims(shape, "S")[0]
        if s > MAX_SPLITS or s > max(1, S // DECODE_TILE):
            raise KernelConfigError(
                f"decode.splits={s}: a cluster of at most {MAX_SPLITS} blocks, "
                f"no split shorter than a {DECODE_TILE}-key tile of S={S}")
    elif kernel == "mamba":
        _check_ints(kernel, config, ("lanes",))
        n = _dims(shape, "n")[0]
        allowed = _LANES_N16 if n <= 16 else _LANES_N32 if n <= MAX_STATE else ()
        if config["lanes"] not in allowed:
            raise KernelConfigError(
                f"mamba.lanes={config['lanes']} at n={n}: the kernel takes "
                f"{allowed or 'no state size above 32'}")
    else:
        raise KernelConfigError(f"{kernel!r} has no CUDA kernel")
    bytes_ = smem_bytes(kernel, shape, config, dtype)
    if bytes_ > SMEM_BYTES:
        raise KernelConfigError(
            f"{kernel} config {config}: {bytes_} B of shared memory a block, "
            f"beyond {SMEM_BYTES} B")


def _grids(kernel: str, shape: dict, backend: str,
           dtype: str) -> dict[str, tuple]:
    if backend == "torch":
        # clamp each axis grid to its dim and always include the dim
        # itself, so small shapes still have a non-empty space
        values = _CHUNKS if kernel == "xla_flash" else _BLOCKS
        return {name: tuple(sorted({v for v in values if v <= dim} | {dim}))
                for name, dim in _axes(kernel, shape).items()}
    if kernel in ("flash_fwd", "flash_bwd"):
        return dict(_tiles(kernel, dtype))
    if kernel == "decode":
        return {"splits": _SPLITS}
    if kernel == "mamba":
        n = _dims(shape, "n")[0]
        return {"lanes": _LANES_N16 if n <= 16 else _LANES_N32}
    raise KernelConfigError(f"{kernel!r} has no CUDA kernel")


def search_space(kernel: str, shape: dict, dtype: str = "float32",
                 backend: str | None = None) -> tuple[list[dict], int]:
    """All statically-valid candidates for ``kernel`` on ``shape``, in a
    deterministic canonical order, plus the number pruned.

    Every returned candidate passes :func:`validate_config`: the pruning
    invariant the tests fuzz."""
    backend = backend or default_backend(kernel)
    grids = _grids(kernel, shape, backend, dtype)
    names = sorted(grids)
    kept, pruned = [], 0
    for combo in itertools.product(*(grids[n] for n in names)):
        cand = dict(zip(names, combo))
        try:
            validate_config(kernel, shape, cand, backend, dtype)
        except KernelConfigError:
            pruned += 1
            continue
        kept.append(cand)
    kept.sort(key=lambda c: tuple(c[n] for n in names))
    return kept, pruned
