"""One tuning task = time one candidate config on a service.

:func:`measure_candidate` is the farm *program body* (a ``host=True``
:class:`~repro_torch.core.skeletons.Program`): the payload is a plain
dict (wire-friendly) naming the kernel, shape, dtype, backend, candidate
config and rep count; the result is a dict with the measured microseconds.

Two measurement modes:

* **real**: build seeded inputs (numpy, an independent stream per
  tensor) on the payload's device (the card unless it names the CPU),
  call the port's entry point at the candidate's explicit config, warm
  up, then take the best of ``reps`` timings.  On the card each timing is
  a pair of CUDA events around one call, recorded while the card still
  spins on a sleep kernel long enough to cover the call's host time, so
  that the events read the card's time for the call and not the wrapper's
  host microseconds.  Used on ``inproc://`` farms whose service owns the
  card: candidates timed at once on one card time each other, so a real
  sweep runs on one service.
* **scripted** (``payload["cost_model"] == "scripted"``): a smooth
  analytic cost (work term + per-tile overhead + imbalance penalties)
  plus hash-seeded noise, a pure function of (kernel, shape, config,
  seed).  This is what makes tuning **deterministic under** ``sim://``:
  the number a candidate reports does not depend on which virtual
  service ran it, when, or how many times the lease bounced, so same-seed
  sweeps pick byte-identical winners.

A candidate that fails validation or crashes in its build or run returns
``{"ok": False, "us": inf}``: the *task* fails, ranked last; the worker
lives on to time the next candidate.
"""

from __future__ import annotations

import hashlib
import math
import threading
import time

import numpy as np

from .space import (SMS, KernelConfigError, choose_splits, default_backend,
                    default_config, scan_geometry, validate_config)

_INF = float("inf")
#: SM clock cycles a second the sleep kernel is reckoned at (an H100's
#: boost clock is 1.98 GHz; a slower clock only sleeps longer)
_SLEEP_HZ = 2.0e9


# --------------------------------------------------------------------- #
# scripted cost model (sim:// determinism)
# --------------------------------------------------------------------- #
def _hash_noise(seed: int, kernel: str, config: dict, scale: float) -> float:
    """Deterministic multiplicative noise in [1-scale, 1+scale]."""
    blob = f"{seed}|{kernel}|{sorted(config.items())}".encode()
    h = int.from_bytes(hashlib.blake2b(blob, digest_size=8).digest(), "big")
    return 1.0 + scale * (2.0 * (h / 2**64) - 1.0)


def scripted_cost_us(kernel: str, shape: dict, config: dict,
                     seed: int = 0, noise: float = 0.03) -> float:
    """Analytic candidate cost in µs: total work spread over tiles, plus
    a fixed overhead per tile dispatch and a penalty for tiles far from
    the 128 sweet spot.  Smooth with a unique interior optimum, so
    successive halving has a meaningful gradient to follow and same-seed
    runs converge on one winner.

    On the reference's knobs (``block_q``/``block_k``, ``q_chunk``/
    ``kv_chunk``, decode's ``block_k``, the scan's ``chunk`` and
    ``block_d``) it is the reference's model, value for value.  The
    port's own knobs add:

    * decode's ``splits`` (0: ``choose_splits``'s): the work
      ``B H S D 1e-5`` over the share of two waves of blocks on 132 SMs
      that ``B K ceil(G / heads a block) splits`` blocks fill (at most 1),
      plus 2 µs a split for the cluster's merge;
    * the scan's ``lanes`` (0: the kernel's ``geometry``): the work
      ``b s d n 2e-5`` over the share of one wave on 132 SMs that
      ``b ceil(d lanes / 128)`` blocks fill (at most 1), times
      ``1 + 0.1 (lanes - 1)`` for the shuffles that sum y across lanes;
    * the backward pair's four tiles: the reference's model of one pass
      for each kernel, the dq kernel's on (``dq_block_q``,
      ``dq_block_k``) with 1.2 of the reference's 3.0 work weight and the
      dk/dv kernel's on (``dkv_block_q``, ``dkv_block_k``) with 1.8, each
      with its own tile overhead (the fp32 forward's ``block_q``,
      ``block_k`` are the reference's knobs).
    """
    def tile_pen(b: int) -> float:
        # quadratic-in-log distance from 128
        return 1.0 + 0.08 * (math.log2(b / 128.0)) ** 2

    if kernel in ("flash_fwd", "flash_bwd", "xla_flash"):
        sq = int(shape["Sq"]); skv = int(shape["Skv"])
        d = int(shape.get("D", 64)); h = int(shape.get("H", 8))
        b = int(shape.get("B", 1))
        work = b * h * sq * skv * d * 1e-5
        if "dq_block_q" in config:  # the port's pair
            us = 0.0
            for share, bq, bk in ((1.2, config["dq_block_q"], config["dq_block_k"]),
                                  (1.8, config["dkv_block_q"], config["dkv_block_k"])):
                us += (work * share * tile_pen(bq) * tile_pen(bk)
                       + -(-sq // bq) * -(-skv // bk) * 2.0)
        else:
            if kernel == "xla_flash":
                bq, bk = config["q_chunk"], config["kv_chunk"]
            else:
                bq, bk = config["block_q"], config["block_k"]
            ntiles = -(-sq // bq) * -(-skv // bk)
            us = (work * (3.0 if kernel == "flash_bwd" else 1.0) * tile_pen(bq)
                  * tile_pen(bk) + ntiles * 2.0)
    elif kernel == "decode":
        s = int(shape["S"]); d = int(shape.get("D", 64))
        h = int(shape.get("H", 8)); b = int(shape.get("B", 1))
        if "splits" in config:
            kv = int(shape.get("K", h))
            splits = config["splits"] or choose_splits(b, h, kv, s)
            g = h // kv
            heads = 1 if g <= 1 else 2 if g <= 2 else 4 if g <= 4 else 8
            fill = min(1.0, b * kv * -(-g // heads) * splits / (2 * SMS))
            us = b * h * s * d * 1e-5 / fill + splits * 2.0
        else:
            bk = config["block_k"]
            us = b * h * s * d * 1e-5 * tile_pen(bk) + (s // bk) * 2.0
    elif kernel == "mamba":
        s = int(shape["s"]); d = int(shape["d"]); n = int(shape["n"])
        b = int(shape.get("b", 1))
        if "lanes" in config:
            lanes = scan_geometry(n, config["lanes"])[0]
            fill = min(1.0, b * -(-d * lanes // 128) / SMS)
            us = b * s * d * n * 2e-5 / fill * (1.0 + 0.1 * (lanes - 1))
        else:
            c = config["chunk"]; bd = config.get("block_d", 256)
            us = (b * s * d * n * 2e-5 * tile_pen(bd)
                  + (s // c) * 3.0 + c * 0.05)
    else:
        raise KernelConfigError(f"unknown kernel {kernel!r}")
    return us * _hash_noise(seed, kernel, config, noise)


# --------------------------------------------------------------------- #
# real measurement
# --------------------------------------------------------------------- #
def make_inputs(kernel: str, shape: dict, dtype: str, seed: int, device="cuda"):
    """Seeded inputs with an independent stream per tensor (correlated
    q == k == v inflates attention scores and skews timings), drawn in
    fp32 with numpy as the reference draws them and cast to ``dtype`` on
    ``device``.  The scan's inputs stay fp32, as its kernel computes.  The
    backward's are (q, k, v, out, lse, g): the forward's out and lse made
    once here, at the untuned tiles, and g drawn, so that a candidate's
    timing holds the backward alone."""
    import torch

    rng = np.random.default_rng(seed)
    tdtype = getattr(torch, dtype)

    def draw(*dims):
        return torch.from_numpy(rng.standard_normal(dims).astype("float32")).to(
            device=device, dtype=tdtype)

    if kernel in ("flash_fwd", "flash_bwd", "xla_flash"):
        b, sq, skv = int(shape["B"]), int(shape["Sq"]), int(shape["Skv"])
        h, k = int(shape["H"]), int(shape["K"])
        d = int(shape["D"]); dv = int(shape.get("Dv", d))
        qkv = (draw(b, sq, h, d), draw(b, skv, k, d), draw(b, skv, k, dv))
        if kernel != "flash_bwd":
            return qkv
        from repro_torch.kernels.flash_attention.flash_attention import \
            flash_attention_fwd

        out, lse = flash_attention_fwd(*qkv, causal=True, **default_config(
            "flash_fwd", "cuda", dtype))
        return qkv + (out, lse, draw(b, sq, h, dv))
    if kernel == "decode":
        b, s = int(shape["B"]), int(shape["S"])
        h, k, d = int(shape["H"]), int(shape["K"]), int(shape["D"])
        dv = int(shape.get("Dv", d))
        q = draw(b, 1, h, d)
        return (q, draw(b, s, k, d), draw(b, s, k, dv), s - 1)
    if kernel == "mamba":
        b, s, d, n = (int(shape["b"]), int(shape["s"]), int(shape["d"]),
                      int(shape["n"]))

        def f32(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

        x = rng.standard_normal((b, s, d)).astype("float32")
        dt = np.logaddexp(0.0, rng.standard_normal((b, s, d))).astype("float32")
        a = -np.exp(rng.standard_normal((d, n)) * 0.5).astype("float32")
        return (f32(x), f32(dt), f32(a), f32(rng.standard_normal((b, s, n))),
                f32(rng.standard_normal((b, s, n))))
    raise KernelConfigError(f"unknown kernel {kernel!r}")


# The inputs of the last (kernel, shape, dtype, seed, device) a worker
# measured: a round times every candidate on the same inputs, and drawing
# falcon-mamba's scan inputs with numpy takes about a second.
_LAST_INPUTS: list = [None, None]
_LAST_LOCK = threading.Lock()


def _inputs(kernel: str, shape: dict, dtype: str, seed: int, device):
    key = (kernel, tuple(sorted(shape.items())), dtype, seed, str(device))
    with _LAST_LOCK:
        if _LAST_INPUTS[0] != key:
            _LAST_INPUTS[:] = [None, None]  # free the last inputs first
            _LAST_INPUTS[:] = [key, make_inputs(kernel, shape, dtype, seed, device)]
        return _LAST_INPUTS[1]


def build_fn(kernel: str, config: dict, backend: str | None = None):
    """The callable for one candidate: the port's entry point at the
    candidate's explicit config (imports deferred: workers only pay for
    the kernel family they measure).  ``mamba`` on ``"torch"`` times the
    forward and backward of ``mamba_scan_plain``: the backward is the only
    place the card runs the plain scan."""
    import torch

    backend = backend or default_backend(kernel)
    if kernel == "xla_flash":
        from repro_torch.models.attention import chunked_attention

        qc, kc = config["q_chunk"], config["kv_chunk"]
        return lambda q, k, v: chunked_attention(q, k, v, causal=True, q_chunk=qc,
                                                 kv_chunk=kc)
    if kernel == "flash_fwd":
        from repro_torch.kernels.flash_attention.flash_attention import \
            flash_attention_fwd

        bq, bk = config["block_q"], config["block_k"]
        return lambda q, k, v: flash_attention_fwd(q, k, v, causal=True, block_q=bq,
                                                   block_k=bk)
    if kernel == "flash_bwd":
        from repro_torch.kernels.flash_attention.flash_attention import \
            flash_attention_bwd

        tiles = {n: config[n] for n in ("dq_block_q", "dq_block_k", "dkv_block_k",
                                        "dkv_block_q")}
        return lambda q, k, v, out, lse, g: flash_attention_bwd(q, k, v, out, lse, g,
                                                                causal=True, **tiles)
    if kernel == "decode":
        from repro_torch.kernels.decode_attention.decode_attention import \
            decode_attention_fwd

        splits = config["splits"]
        return lambda q, kc_, vc_, ci: decode_attention_fwd(q, kc_, vc_, cache_index=ci,
                                                            splits=splits)
    if kernel == "mamba" and backend == "cuda":
        from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan_fwd

        lanes = config["lanes"]
        return lambda x, dt, a, b_, c_: mamba_scan_fwd(x, dt, a, b_, c_, lanes=lanes)
    if kernel == "mamba":
        from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan_plain

        c = config["chunk"]

        def fwd_bwd(*inputs):
            leaves = [t.detach().requires_grad_() for t in inputs]
            y, h = mamba_scan_plain(*leaves, chunk=c)
            return torch.autograd.grad(y.sum() + h.sum(), leaves)
        return fwd_bwd
    raise KernelConfigError(f"unknown kernel {kernel!r}")


def _on_card(args) -> bool:
    return any(getattr(a, "is_cuda", False) for a in args)


def time_fn(fn, args, *, reps: int, warmup: int = 1) -> float:
    """Best of ``reps`` timings of ``fn(*args)`` in µs, after ``warmup``
    calls (the first builds the kernel).  On the card: CUDA events around
    one call, behind a sleep kernel that outlasts the call's host time (so
    the events time the card); on the CPU: the host clock."""
    import torch

    card = _on_card(args)
    for _ in range(max(1, warmup)):
        fn(*args)
    if not card:
        best = _INF
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
        return best * 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)  # the host's time to enqueue one call
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = _INF
    for _ in range(max(1, reps)):
        torch.cuda._sleep(int(2 * host_s * _SLEEP_HZ) + 10_000)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3)
    return best


def measure_candidate(payload: dict) -> dict:
    """The farm task body.  Payload keys: ``kernel``, ``shape``,
    ``dtype``, ``config``, ``reps``, ``seed``, optional ``backend``,
    ``cost_model`` ("scripted") and ``device`` (default the card).  Never
    raises for a bad candidate: returns ``ok=False`` with infinite cost
    instead."""
    config = payload.get("config")
    try:
        kernel = payload["kernel"]
        shape = payload["shape"]
        dtype = payload.get("dtype", "float32")
        backend = payload.get("backend") or default_backend(kernel)
        seed = int(payload.get("seed", 0))
        validate_config(kernel, shape, config, backend, dtype)
        if payload.get("cost_model") == "scripted":
            us = scripted_cost_us(kernel, shape, config, seed=seed)
        else:
            fn = build_fn(kernel, config, backend)
            args = _inputs(kernel, shape, dtype, seed, payload.get("device", "cuda"))
            us = time_fn(fn, args, reps=int(payload.get("reps", 3)))
        return {"ok": True, "us": float(us), "config": config}
    except Exception as e:  # a bad candidate fails the TASK, not the worker
        return {"ok": False, "us": _INF, "config": config,
                "error": f"{type(e).__name__}: {e}"}
