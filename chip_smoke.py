#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path — serving as a task farm — on ``cuda:0`` and
holds every hand-written kernel of that path against its plain PyTorch
version.  Phases, in order; any failure raises and exits non-zero:

1. build the CUDA kernels from this checkout's sources (one ``nvcc`` per
   source, all started together) and print the card's name and power limit;
2. each kernel against its plain version on the card, at the serve shapes
   (B=4, H=16, K=8, D=128, Sq = Skv = 512, a 576-slot cache: many query
   and key tiles) and at a ragged size (Sq = Skv = 13, a 24-slot cache
   with ``cache_index`` mid-cache), each in bf16 and fp32, then the
   kernel, its plain version and one PyTorch library call, timed at the
   serve shapes in bf16;
3. serve full-width qwen3-1.7B (bf16, weights from a seeded generator on
   the card) through ``BasicClient`` on 2 in-process services: 16 requests,
   prompt 512, 64 new tokens, 4 requests per task.  The kernels' launch
   counts are zeroed just before and read just after;
4. one prefill and one decode step at full width through the kernels and
   through the plain versions, with the same weights, on several prompt
   batches.

The line before the last is a JSON object with each kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.  Times are CUDA-event
times on this card, averaged over repeated launches without flushing the
50 MB L2 cache (the serve path finds its inputs freshly written).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ARCH = "qwen3_1p7b"
SERVICES, REQUESTS, PROMPT, NEW, PER_TASK = 2, 16, 512, 64, 4
SEED = 0
TIMED_ROUNDS = 3
# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel vs plain version on the same inputs, element by element:
# |got - ref| <= ATOL + rtol * |ref|.  Both compute every product, the
# softmax and the sums in fp32 and differ only in summation order, so
# fp32 outputs (and lse, always fp32) agree to ATOL; a bf16 output may
# round the other way, by one bf16 ulp, <= 2^-7 |ref|.  A flip just above
# a power of two reads close to 1 on the printed scale; two ulps fail.
ATOL = 2e-5
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
# Full-width logits, kernels vs plain versions (phase 4): the one-ulp
# differences above pass through 28 layers of bf16 matmuls.  Limits on
# the largest and on the mean |difference| of each batch's logits, from
# this script's readings on an H100 over 8 batches, prefill and decode:
# largest 5.6e-2 to 6.8e-2, mean 9.8e-3 to 1.03e-2 (see PERF.md).
FULL_WIDTH_BATCHES = 8
FULL_WIDTH_MAX_ERR = 0.09
FULL_WIDTH_MEAN_ERR = 0.0125


def say(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def check(name, got, ref, rtol) -> float:
    """Holds ``got`` to ``ref`` element by element; returns the largest
    absolute difference."""
    diff = (got.float() - ref.float()).abs()
    lim = ATOL + rtol * ref.float().abs()
    err = diff.max().item()
    worst = (diff / lim).max().item()
    say(f"  {name}: max_abs_err {err:.3e}, largest |err| / ({ATOL:g} + "
        f"{rtol:g} |ref|) {worst:.3f} (limit 1)")
    if not worst <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def say_registers(log):
    """One line per kernel instantiation from ``ptxas -v``: registers and
    spills, under a short name such as ``flash_fwd_kernel<bf16, 128>``."""
    name, spill = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function .*?([a-z_]+_kernel)I"
                      r"(13__nv_bfloat16|f)Li(\d+)E", line)
        if m:
            dtype = "bf16" if m.group(2) != "f" else "f32"
            name = f"{m.group(1)}<{dtype}, {m.group(3)}>"
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            say(f"  {name}: {regs} registers; {spill}")
            name = None


def bound(flops, nbytes, dtype):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for the inputs' type."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_phase(flash, decode):
    """Phase 2: kernels vs plain versions; times at the serve shapes."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    errs = {"flash": 0.0, "decode": 0.0}
    B, H, K, D = PER_TASK, 16, 8, 128
    S = PROMPT + NEW
    cases = [(label, dt, sq, s_cache, ci)
             for label, sq, s_cache, ci in (("serve", PROMPT, S, PROMPT + 31),
                                            ("ragged", 13, 24, 11))
             for dt in (torch.bfloat16, torch.float32)]
    for label, dt, sq, s_cache, ci in cases:
        q = randn((B, sq, H, D), dt, 1)
        k = randn((B, sq, K, D), dt, 2)
        v = randn((B, sq, K, D), dt, 3)
        out, lse = flash.flash_attention_fwd(q, k, v, causal=True)
        ref, ref_lse = flash.flash_attention_plain(q, k, v, causal=True)
        tag = f"flash {label} {str(dt)[6:]} Sq=Skv={sq}"
        errs["flash"] = max(errs["flash"], check(tag + " out", out, ref, RTOL[dt]),
                            check(tag + " lse", lse, ref_lse, 0.0))
        qd = randn((B, 1, H, D), dt, 4)
        kc = randn((B, s_cache, K, D), dt, 5)
        vc = randn((B, s_cache, K, D), dt, 6)
        got = decode.decode_attention_fwd(qd, kc, vc, cache_index=ci)
        ref = decode.decode_attention_plain(qd, kc, vc, cache_index=ci)
        errs["decode"] = max(errs["decode"], check(
            f"decode {label} {str(dt)[6:]} S={s_cache} cache_index={ci}",
            got, ref, RTOL[dt]))
        if (label, dt) == ("serve", torch.bfloat16):
            serve_inputs = (q, k, v, qd, kc, vc, ci)
    torch.cuda.synchronize()

    q, k, v, qd, kc, vc, ci = serve_inputs
    qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))
    causal_pairs = B * H * sum(min(i + 1, k.shape[1]) for i in range(q.shape[1]))
    out = torch.empty_like(q)
    lse = torch.empty((B, H, q.shape[1]), device="cuda")
    fl = dict(
        ms=cuda_ms(lambda: flash.flash_attention_fwd(q, k, v, causal=True)),
        plain_ms=cuda_ms(lambda: flash.flash_attention_plain(q, k, v, causal=True)),
        library_ms=cuda_ms(lambda: sdpa(qT, kT, vT, is_causal=True, enable_gqa=True)))
    fl["bound_ms"], fl["bound_by"] = bound(4 * D * causal_pairs,
                                           nbytes(q, k, v, out, lse), q.dtype)
    n = ci + 1
    mask = (torch.arange(kc.shape[1], device="cuda") <= ci).view(1, 1, 1, -1)
    qdT, kcT, vcT = (t.transpose(1, 2) for t in (qd, kc, vc))
    de = dict(
        ms=cuda_ms(lambda: decode.decode_attention_fwd(qd, kc, vc, cache_index=ci)),
        plain_ms=cuda_ms(lambda: decode.decode_attention_plain(qd, kc, vc, cache_index=ci)),
        library_ms=cuda_ms(lambda: sdpa(qdT, kcT, vcT, attn_mask=mask, enable_gqa=True)))
    kv_read = 2 * B * n * K * D * kc.element_size()
    de["bound_ms"], de["bound_by"] = bound(4 * D * B * H * n,
                                           kv_read + 2 * nbytes(qd), qd.dtype)
    for name, r in (("flash", fl), ("decode", de)):
        say(f"  {name} at serve shapes: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return errs, fl, de


def profile_window(label, fn, reps):
    """Where the time goes in ``reps`` calls of ``fn``: kernels launched,
    device busy time and the device's idle share (torch.profiler, CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        say(f"  profile {label}: the profiler recorded no device activity: not measured")
        return
    by_name: dict = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3 / reps
    busy_ms = sum(by_name.values())
    say(f"  profile {label} (profiler on): wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
        f"{len(kern) / reps:.0f} kernels")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        say(f"    {ms:.4f} ms  {name[:100]}")


def profile_task(api, params, tokens):
    """Profile one prefill and one decode step of one task alone."""
    budget = PROMPT + NEW
    profile_window("prefill of one task", lambda i: api.prefill(
        params, {"tokens": tokens}, seq_budget=budget), 2)
    _, caches = api.prefill(params, {"tokens": tokens}, seq_budget=budget)
    nxt = tokens[:, -1:].to(torch.int32)
    profile_window("decode step of one task", lambda i: api.decode(
        params, {"tokens": nxt, "cache_index": PROMPT + i}, caches), 4)


def full_width_phase(api, params, cfg, dev, plain_ops):
    """Phase 4: one prefill and one decode step of each of
    ``FULL_WIDTH_BATCHES`` prompt batches, through the kernels (the
    serving dispatch) and through the plain versions."""
    budget = PROMPT + NEW
    for i in range(FULL_WIDTH_BATCHES):
        tokens = torch.as_tensor(np.random.default_rng(SEED + 1 + i).integers(
            0, cfg.vocab_size, (PER_TASK, PROMPT))).to(dev)
        lg_k, c_k = api.prefill(params, {"tokens": tokens}, seq_budget=budget)
        nxt = torch.argmax(lg_k, -1).to(torch.int32)[:, None]
        step = {"tokens": nxt, "cache_index": PROMPT}
        lg_k2, _ = api.decode(params, step, c_k)
        lg_p, c_p = api.prefill(params, {"tokens": tokens}, seq_budget=budget,
                                ops=plain_ops)
        lg_p2, _ = api.decode(params, step, c_p, ops=plain_ops)
        for name, a, b in (("prefill", lg_k, lg_p), ("decode", lg_k2, lg_p2)):
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError(f"batch {i} {name}: non-finite logits")
            diff = (a - b).abs()
            err, mean = diff.max().item(), diff.mean().item()
            agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
            say(f"  batch {i} {name} logits: max |diff| {err:.3e} (limit "
                f"{FULL_WIDTH_MAX_ERR:g}), mean |diff| {mean:.3e} (limit "
                f"{FULL_WIDTH_MEAN_ERR:g}), max |logit| "
                f"{b.abs().max().item():.3f}, greedy tokens agree on "
                f"{agree:.2f} of rows")
            if not (err <= FULL_WIDTH_MAX_ERR and mean <= FULL_WIDTH_MEAN_ERR):
                raise AssertionError(f"batch {i} {name}: full-width logits "
                                     "through the kernels disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch.configs as cfgs
    from repro_torch import kernels
    from repro_torch.core import LookupService, Service
    from repro_torch.kernels import decode_attention as decode
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels.build import build_all
    from repro_torch.models import build
    from repro_torch.runtime.serve_loop import ServeConfig, serve_requests

    dev = torch.device("cuda", 0)
    say("phase 1: build")
    t0 = time.perf_counter()
    logs = build_all(kernels.KERNELS)
    say(f"  kernels built in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(sorted(logs)) or 'already built'})")
    for log in logs.values():
        say_registers(log)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    say(smi)

    say("phase 2: kernels vs plain versions")
    errs, fl, de = kernel_phase(flash, decode)

    say("phase 3: serve")
    cfg = cfgs.get(ARCH)
    api = build(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    say(f"  {cfg.name}: {sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
        f"params in {cfg.param_dtype} on {dev}, initialised in "
        f"{time.perf_counter() - t0:.2f} s; fp32 unembedding copy "
        f"{params.head().table_f32().numel() * 4 / 1e9:.3f} GB")
    lookup = LookupService()
    services = [Service(lookup, device=dev) for _ in range(SERVICES)]
    for s in services:
        s.start()
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                   (REQUESTS, PROMPT))
    sc = ServeConfig(max_new_tokens=NEW, prompt_len=PROMPT,
                     batch_per_task=PER_TASK)
    # warm-up (cuBLAS handles, allocator), not counted
    serve_requests(api, params, prompts[:PER_TASK],
                   ServeConfig(max_new_tokens=2, prompt_len=PROMPT,
                               batch_per_task=PER_TASK), lookup=lookup)
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    gen, stats = serve_requests(api, params, prompts, sc, lookup=lookup)
    wall = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    n_tasks = REQUESTS // PER_TASK
    say(f"  served {tuple(gen.shape)} tokens in {wall:.3f} s: "
        f"{gen.numel() / wall:.1f} tok/s across {SERVICES} services; "
        f"{stats['done']} tasks, {stats['reschedules']} reschedules; peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    say(f"  launches on the main path: {launches}")
    if tuple(gen.shape) != (REQUESTS, NEW):
        raise AssertionError(f"generated shape {tuple(gen.shape)}")
    if not (int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size):
        raise AssertionError("generated token ids out of range")
    if launches["flash_attention"] < n_tasks * cfg.n_layers:
        raise AssertionError("flash kernel launched fewer times than prefill needs")
    if launches["decode_attention"] < n_tasks * cfg.n_layers * NEW:
        raise AssertionError("decode kernel launched fewer times than decode needs")

    tokens = torch.as_tensor(prompts[:PER_TASK]).to(dev)
    # the path is host-bound, and the host is shared: one round can read
    # several times the others, so report the median of TIMED_ROUNDS
    times = []
    for r in range(TIMED_ROUNDS + 1):  # round 0 warms up, untimed
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        logits, caches = api.prefill(params, {"tokens": tokens},
                                     seq_budget=PROMPT + NEW)
        ev[1].record()
        for i in range(NEW):
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
            logits, caches = api.decode(
                params, {"tokens": nxt, "cache_index": PROMPT + i}, caches)
        ev[2].record()
        torch.cuda.synchronize()
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        if r:
            times.append((ev[0].elapsed_time(ev[1]),
                          ev[1].elapsed_time(ev[2]) / NEW))
    prefill_ms = [t[0] for t in times]
    decode_ms = [t[1] for t in times]
    say(f"  one task alone on the card, median of {TIMED_ROUNDS} rounds: "
        f"prefill {np.median(prefill_ms):.3f} ms (B={PER_TASK}, {PROMPT} "
        f"tokens; rounds {', '.join(f'{t:.3f}' for t in prefill_ms)}), decode "
        f"{np.median(decode_ms):.3f} ms per step (rounds "
        f"{', '.join(f'{t:.3f}' for t in decode_ms)})")
    profile_task(api, params, tokens)

    say("phase 4: full width, kernels vs plain versions")
    full_width_phase(api, params, cfg, dev, kernels.PLAIN)

    rows = []
    for name, kern, r, err, replaces in (
            ("flash_attention_fwd", flash.KERNEL, fl, errs["flash"],
             "src/repro/kernels/flash_attention/flash_attention.py:127"),
            ("decode_attention_fwd", decode.KERNEL, de, errs["decode"],
             "src/repro/kernels/decode_attention/decode_attention.py:116")):
        rows.append({"name": name, "route": "cuda",
                     "source": str(kern.source.relative_to(ROOT)),
                     "replaces": replaces, "launches": launches[kern.name],
                     "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
