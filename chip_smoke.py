#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths on ``cuda:0`` — serving as a task farm, and
training in sync and in farm mode, of qwen3-1.7B; serving and sync
training of falcon-mamba-7b — and holds every hand-written kernel of
those paths against its plain PyTorch version.  Phases, in order; any
failure raises and exits non-zero:

1. build the CUDA kernels from this checkout's sources (one ``nvcc`` per
   source, all started together), print each kernel's registers, spills
   and static shared memory, count the tensor-core (``HGMMA``) and TMA
   (``UTMALDG``) instructions in the SASS of the six Hopper attention
   libraries (flash forward, backward dq and dk/dv, each in bf16 and in
   fp32; failing if either is 0) and the asynchronous-copy (``LDGSTS``)
   instructions in the decode and scan libraries (failing if 0), print the
   fp32 backward pair's, decode's and the scan's dynamic shared memory a
   block, and print the card's name and power limit;
2. each kernel against its plain version on the card, at the serve shapes
   (B=4, H=16, K=8, D=128, Sq = Skv = 512, a 576-slot cache: many query
   and key tiles) and at a ragged size (Sq = Skv = 13, a 24-slot cache
   with ``cache_index`` mid-cache), each in bf16 and fp32 (flash goes to
   the Hopper kernel of its dtype: fp32 products as three tf32 products
   each), then each
   kernel, its plain version and PyTorch's SDPA timed at the serve shapes
   (flash in bf16 and in fp32, decode in bf16, and again at B=1 with the
   number of KV splits it launched); SDPA runs with K and V
   expanded to H heads outside the timed region, under each of its flash,
   memory-efficient and cuDNN backends that takes the inputs, and the
   fastest is kept with its backend's name.  The host cost of the bf16
   kernel's three TMA descriptors is timed too;
3. serve full-width qwen3-1.7B (bf16, weights from a seeded generator on
   the card) through ``BasicClient`` on 2 in-process services: 16 requests,
   prompt 512, 64 new tokens, 4 requests per task.  The kernels' launch
   counts are zeroed just before and read just after: every prefill layer
   goes through the bf16 flash kernel, none through the fp32 one;
4. one prefill and one decode step at full width through the kernels and
   through the plain versions, with the same weights, on several prompt
   batches;
5. the flash-backward kernels (dq, then dk/dv) against the plain
   backward at the training shapes (B=4, H=16, K=8, D=128, S=512) and at
   a ragged S=13, in bf16 (the Hopper bf16 pair) and fp32 (the Hopper
   fp32 pair: three tf32 products for each product); a second launch
   bit-identical; each kernel, the whole backward
   (dq + dk/dv in one call), the plain backward and PyTorch's SDPA
   backward timed at the training shapes in each dtype: SDPA's backward
   alone (one forward with grad-enabled inputs, then ``autograd.grad``
   timed), K and V expanded, each backend as in phase 2;
6. sync training of full-width, full-depth qwen3-1.7B (``Trainer``, 4
   AdamW steps on MarkovDataset batches of 4 x 512, fp32 moments), the
   launch counts zeroed just before and read just after (the bf16
   forward, dq and dk/dv kernels each at least once per layer per step,
   the fp32 ones never), one profiled step, and a checkpoint saved and
   restored into a fresh state;
7. one full-width training step's loss and gradients through the
   kernels and through the plain versions, same weights, same batch, in
   bf16 (the trained weights) and in fp32 (fresh fp32 weights; the launch
   counts zeroed just before and read just after: this is the fp32
   forward, dq and dk/dv kernels' path, once per layer, and no bf16
   kernel's);
8. farm-mode training (``LocalSGDTrainer``) at full width with depth cut
   to 8 layers on the 2 services: one round of 4 tasks, then one more with
   a service failing after one task (the bf16 kernels launched, the fp32
   ones not);
9. (qwen3's state freed) the selective-scan kernel against the plain
   chunked scan in fp32 at the serve shape (b=4, s=512, d_inner=8192,
   n=16), at a ragged (2, 13, 96, 16), with h0 (two halves chained
   against one whole scan) and with strided x, B and C; kernel (graph-timed
   and back to back) and plain timed at the serve shape beside the bound's bytes,
   exponential and flop terms;
10. serve full-width, full-depth falcon-mamba-7b (64 layers, bf16, seeded
    weights) through ``BasicClient`` on the 2 services: 8 requests, prompt
    512, 32 new tokens, 4 requests per task, asserting exactly one scan
    launch per layer per task; one task timed alone and profiled;
11. falcon-mamba-7b prefill and decode logits through the kernels and
    through the plain versions, same weights, on several prompt batches;
12. sync training of falcon-mamba-7b at full width, depth cut to 8
    layers (4 AdamW steps on batches of 2 x 512), asserting one scan launch
    per layer per step, and one profiled step;
13. (everything freed) serve phase 3's load — the same 16 prompts, 64 new
    tokens, 4 requests a task — through ``BasicClient`` on a ``NowPool``
    of 2 ``proc://`` worker processes on ``cuda:0``, each a fresh
    interpreter with its own CUDA context.  The program ships by
    reference (``chip_smoke.WorkerGenerate``: arch, seed, ``ServeConfig``)
    and builds the weights at its first call on each worker from phase 3's
    seeded generator.  Round 1 is cold (worker start-up, weight builds),
    round 2 warm, with each worker's launch counts zeroed just before and
    read just after by a second shipped program (``WorkerLaunches``):
    summed over the workers, 28 bf16 flash launches and 1,792 decode
    launches a task, no other kernel's.  In round 3 worker 0 is SIGKILLed
    (``NowPool.kill``) after its first task and the survivor finishes;
    the repository must show a rescheduled task.  Then 8 requests on a
    fresh pool of 2 ``shm://`` workers.  Every round's tokens must equal
    phase 3's bit for bit; start-up to first result, each round's wall
    time and tok/s are printed beside phase 3's.

The line before the last is a JSON object with each kernel's numbers, one
row each: the bf16 flash forward (``flash_attention_fwd``), the fp32 one
(``flash_attention_fwd_fp32``), decode, dq and dk/dv in bf16 and in fp32
(``..._fp32``), and the scan; the last
line is ``{"ok": true, "device": {...}}``.  Times are CUDA-event times on
this card without flushing the 50 MB L2 cache (the serve and training
paths find their inputs freshly written): for every kernel, its library
call (SDPA) and the plain attention versions, of CUDA-graph replays of
repeated calls (device time: a wrapper's host time exceeds the faster
kernels' own); for the plain scan, of back-to-back calls.
"""

from __future__ import annotations

import ctypes
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import warnings
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
PEAK_TF32_FLOP_S = 495e12
# An fp32 attention product passes the fp32 element check (ATOL below) on
# the tensor cores only as three tf32 products, hi hi + hi lo + lo hi
# (tests/test_torch_flash_fp32_sm90.py counts what fewer terms miss): the
# least time the card can take for it is three times its flops at the TF32
# peak, less than its flops at the CUDA cores' 67 TFLOP/s.  The scan's fp32
# work is no matrix product and keeps the CUDA cores' rate.
TF32_TERMS = 3
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
# Backward kernels vs the plain backward, element by element:
# |got - ref| <= BWD_ATOL + rtol * |ref|, rtol as above.  Each gradient
# element is an fp32 sum of up to S * G = 1024 products whose terms reach
# ~10 (dp = dO.V over D=128 unit-variance pairs), summed in another order
# than the plain version's einsums: a random walk of 1024 roundings of
# 2^-24 * 10 is ~2e-5, so fp32 outputs agree to BWD_ATOL = 1e-4; a bf16
# output may round the other way, one ulp, as for the forward.  The bf16
# pair multiplies bf16 operands on the tensor cores with fp32 sums and
# splits P and dS into two bf16 terms, which a CPU model of its
# arithmetic keeps within this check (tests/test_torch_flash_bwd_sm90.py;
# rounding either once does not).  The fp32 pair issues each product as
# three tf32 products, which a CPU model of its arithmetic keeps within
# BWD_ATOL and within 1.3e-6 of the plain gradients' norm
# (tests/test_torch_flash_bwd_fp32_sm90.py; two terms in any product do
# not).
BWD_ATOL = 1e-4
# Training path (phases 6-8)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 4
# the attention kernels a training step launches in bf16 and in fp32 (the
# Hopper kernels of each): forward, dq, dk/dv
BF16_TRAIN_KERNELS = ("flash_attention_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90")
FP32_TRAIN_KERNELS = ("flash_attention_sm90_fp32", "flash_bwd_dq_sm90_fp32",
                      "flash_bwd_dkv_sm90_fp32")
FARM_LAYERS, FARM_SHARDS, FARM_INNER, FARM_BATCH = 8, 4, 2, 2
# Full-width training step, kernels vs plain versions (phase 7): |dloss|
# and, per parameter group, ||g_kernels - g_plain|| / ||g_plain||, in
# bf16 (the trained config) and in fp32 (the same config with fp32
# weights and activations, where only summation order differs).  bf16:
# from the first reading on an H100, |dloss| 5.4e-4 and a largest
# relative difference of 2.0e-2 (one-ulp flips of bf16 activations and
# gradients through 28 layers; see PERF.md).  fp32, from the first
# reading: |dloss| 0 and at most 5.3e-6, which shows the bf16 gap is
# rounding, not the kernels.
TRAIN_LIMITS = {torch.bfloat16: (1e-3, 3e-2), torch.float32: (1e-5, 1e-5)}
# Mamba path (phases 9-12): falcon-mamba-7b at full width and depth.
MAMBA_ARCH = "falcon_mamba_7b"
MAMBA_REQUESTS, MAMBA_NEW = 8, 32
MAMBA_TRAIN_LAYERS, MAMBA_TRAIN_BATCH = 8, 2
# Farm over worker processes (phase 13): 2 workers; the kill round's
# victim is worker 0, the shm round serves the first SHM_REQUESTS prompts
WORKERS, SHM_REQUESTS = 2, 8
# Scan kernel vs plain chunked scan, element by element (phase 9):
# |got - ref| <= SCAN_TOL + SCAN_TOL |ref|, the reference suite's own scan
# tolerance (tests/test_kernels_mamba.py).  Both sides compute in fp32; the
# kernel steps through time, the plain version scans log-depth inside
# chunks of 256, so they differ in rounding only.
SCAN_TOL = 1e-4
# Full-width falcon-mamba logits, kernels vs plain versions (phase 11),
# limits on the largest and the mean |difference| of each batch's logits,
# from this script's readings on an H100 (see PERF.md).  bf16 (the served
# weights): largest 0.289 to 0.358, mean 0.0512 to 0.0551 over 4 batches,
# prefill and decode, in three runs.  The scan's fp32 outputs differ from the
# plain version's by ~1e-5, which flips the bf16 rounding of a few elements
# of each layer's output, and 64 layers of random weights amplify the flips
# (on the CPU, a deep bf16 model whose plain scan only changes summation
# order moves its logits far more at 64 layers than at 8).  fp32 (fresh
# fp32 weights, same config), where only summation order differs: largest
# 7.5e-5 to 9.9e-5, mean 1.3e-5 to 1.6e-5, which shows the bf16 gap is
# rounding, not the kernel.
MAMBA_FULL_WIDTH_BATCHES = 4
MAMBA_FULL_WIDTH_LIMITS = {torch.bfloat16: (0.45, 0.07), torch.float32: (2e-4, 3e-5)}
# the scan's exponentials run on the multi-function unit: 16 a clock per SM
# (NVIDIA's CUDA C++ programming guide, arithmetic instruction throughput,
# compute capability 9.0); the card has 132 SMs
MUFU_PER_CLOCK_SM, SMS = 16, 132
SCAN_FLOP_PER_ELEMENT = 6  # dt*A, h*dA, dx*B, +, C*h, + per (b, s, d, n)


def say(*a):
    print(*a, flush=True)


def free(services):
    """Release a finished phase's device memory: the services' cached
    programs (their closures hold weights), then whatever the collector
    finds (a trainer and its programs hold each other), then the
    allocator's cache."""
    for svc in services:
        svc.drop_programs()
    gc.collect()
    torch.cuda.empty_cache()


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


def graph_ms(fn, iters=10, reps=5, stream=None) -> float:
    """Device ms of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph on ``stream`` (a new one by default), replayed ``reps`` times
    between CUDA events.  What each call costs the host (Python, checks,
    allocation, the launch) is left out: the kernels' wrappers take ~30 us
    of host time a call, so back-to-back calls of a faster kernel would
    time the host, not the card."""
    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def check(name, got, ref, rtol, atol=ATOL) -> float:
    """Holds ``got`` to ``ref`` element by element; returns the largest
    absolute difference."""
    diff = (got.float() - ref.float()).abs()
    lim = atol + rtol * ref.float().abs()
    err = diff.max().item()
    worst = (diff / lim).max().item()
    say(f"  {name}: max_abs_err {err:.3e}, largest |err| / ({atol:g} + "
        f"{rtol:g} |ref|) {worst:.3f} (limit 1)")
    if not worst <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def say_registers(log):
    """One line per kernel instantiation from ``ptxas -v``: registers,
    spills and static shared memory, under a short name such as
    ``decode_sm90_kernel<bf16, 128, 2>`` (dtype, then the integer template
    arguments) or ``scan_sm90_kernel<1, 16>``."""
    name, spill = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function .*?([a-z][a-z_]*(?:_sm90)?_kernel)I"
                      r"(13__nv_bfloat16|f)((?:Li\d+E)+)", line)
        d = re.search(r"Compiling entry function .*?([a-z_]+(?:_sm90)?(?:_fp32)?_kernel)"
                      r"I((?:Li\d+E)+)", line)
        if m:
            dtype = "bf16" if m.group(2) != "f" else "f32"
            name = f"{m.group(1)}<{', '.join([dtype] + re.findall(r'Li(\d+)E', m.group(3)))}>"
        elif d:
            name = f"{d.group(1)}<{', '.join(re.findall(r'Li(\d+)E', d.group(2)))}>"
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            smem = f"; {smem.group(1)} bytes static shared memory" if smem else ""
            say(f"  {name}: {regs} registers; {spill}{smem}")
            name = None


def say_sass(kern, ops=("HGMMA", "UTMALDG")):
    """Counts ``ops`` in the SASS of ``kern``'s library (``cuobjdump``,
    shipped with the toolkit beside ``nvcc``); fails if any is absent."""
    from repro_torch.kernels.build import find_nvcc

    cuobjdump = Path(find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(kern.library_path())],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}
    say(f"  {kern.source.name} SASS: " + ", ".join(f"{n} {op}" for op, n in counts.items()))
    if not all(counts.values()):
        raise AssertionError(f"{kern.source.name}: no {' or '.join(ops)} in its SASS")


def kernel_entry(kern, suffix, nargs):
    """A plain-int entry ``<symbol><suffix>`` of ``kern``'s library."""
    fn = getattr(ctypes.CDLL(str(kern.library_path())), kern.symbol + suffix)
    fn.argtypes, fn.restype = [ctypes.c_int] * nargs, ctypes.c_int
    return fn


def say_async_smem(decode, scan):
    """The dynamic shared memory a block of the decode kernel (its K/V
    ring, by head dim and dtype) and of the scan (its tile ring, by state
    size) takes."""
    ring = kernel_entry(decode.KERNEL, "_smem", 2)
    say(f"  {decode.KERNEL.source.name} K/V ring a block: " + ", ".join(
        f"D={d} {name} {ring(d, code):,} B" for d in (32, 64, 128)
        for name, code in (("f32", 0), ("bf16", 1))))
    tiles = kernel_entry(scan.KERNEL, "_smem", 1)
    say(f"  {scan.KERNEL.source.name} tile ring a block: " + ", ".join(
        f"n={n} {tiles(n):,} B" for n in (4, 8, 16, 32)))


def say_smem(kern):
    """The dynamic shared memory a block of ``kern`` takes at each head dim
    (its library's ``<symbol>_smem`` entry), beside the 227 KB a block may
    have."""
    fn = kernel_entry(kern, "_smem", 1)
    say(f"  {kern.source.name} shared memory a block: " + ", ".join(
        f"D={d} {fn(d):,} B" for d in (32, 64, 128)) + " (at most 232,448 B)")


def fmt_ms(ms) -> str:
    return "none ran" if ms is None else f"{ms:.4f} ms"


def sdpa_backends():
    from torch.nn.attention import SDPBackend

    return (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
            SDPBackend.CUDNN_ATTENTION)


def sdpa_heads(q, k, v):
    """(B,S,heads,D) -> SDPA's (B,H,S,D) views, K and V expanded to q's H
    heads (copied here, outside any timed region)."""
    G = q.shape[2] // k.shape[2]
    return tuple(t.transpose(1, 2) for t in (q, k.repeat_interleave(G, 2),
                                              v.repeat_interleave(G, 2)))


def sdpa_library_ms(q, k, v, **kw):
    """One SDPA forward on (B,S,heads,D) inputs, graph-timed under each
    backend that takes them: (fastest ms, its backend's name), or (None,
    None)."""
    from torch.nn.attention import sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    qT, kT, vT = sdpa_heads(q, k, v)
    best = (None, None)
    for backend in sdpa_backends():
        with warnings.catch_warnings(), sdpa_kernel(backend):
            warnings.simplefilter("ignore")
            try:
                sdpa(qT, kT, vT, **kw)
            except (RuntimeError, ValueError):  # the backend does not take these inputs
                continue
            ms = graph_ms(lambda: sdpa(qT, kT, vT, **kw))
        say(f"    SDPA {backend.name} {str(q.dtype)[6:]}: {ms:.4f} ms")
        if best[0] is None or ms < best[0]:
            best = (ms, backend.name)
    return best


def sdpa_backward_ms(q, k, v, g):
    """SDPA's backward alone, causal, on (B,S,heads,D) inputs: one forward
    with grad-enabled inputs under each backend that takes them, then
    ``autograd.grad`` graph-timed (the forward runs on the capture stream,
    where autograd puts its backward); (fastest ms, its backend's name)."""
    from torch.nn.attention import sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    leaves = tuple(t.detach().requires_grad_() for t in sdpa_heads(q, k, v))
    gT = g.transpose(1, 2)
    best = (None, None)
    for backend in sdpa_backends():
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with warnings.catch_warnings(), sdpa_kernel(backend):
            warnings.simplefilter("ignore")
            try:
                with torch.cuda.stream(stream):
                    o = sdpa(*leaves, is_causal=True)
            except (RuntimeError, ValueError):  # the backend does not take these inputs
                continue
            ms = graph_ms(lambda: torch.autograd.grad(o, leaves, gT, retain_graph=True),
                          stream=stream)
        say(f"    SDPA {backend.name} backward: {ms:.4f} ms")
        if best[0] is None or ms < best[0]:
            best = (ms, backend.name)
    return best


def describe_us(flash, q, k, v, reps=2000) -> float:
    """Host microseconds to make the bf16 flash kernel's three TMA
    descriptors for one call (the library's describe entry, no launch)."""
    lib = ctypes.CDLL(str(flash.SM90_KERNEL.library_path()))
    fn = lib.repro_flash_sm90_describe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
    fn.restype = ctypes.c_int
    B, Sq, H, D = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), B, Sq, k.shape[1], H,
            k.shape[2], D)
    t0 = time.perf_counter()
    err = fn(*args, reps)
    us = (time.perf_counter() - t0) / reps * 1e6
    if err:
        raise AssertionError(f"repro_flash_sm90_describe failed: CUDA error {err}")
    return us


def host_us(fn, calls=50) -> float:
    """Host microseconds per call of ``fn``, enqueued back to back (fewer
    than the launch queue holds), the card not waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def bound(flops, nbytes, dtype):
    """(bound_ms, bound_by) of an attention function whose matrix products
    are ``flops``: the larger of bytes over the memory rate and operations
    over the peak rate for the inputs' type, fp32 as TF32_TERMS tf32
    products at the TF32 peak."""
    if dtype == torch.float32:
        flops, flop_s = TF32_TERMS * flops, PEAK_TF32_FLOP_S
    else:
        flop_s = PEAK_FLOP_S[dtype]
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def causal_pairs(B, H, Sq, Skv) -> int:
    """Visible (q, k) pairs under the top-left causal mask."""
    return B * H * sum(min(i + 1, Skv) for i in range(Sq))


def kernel_phase(flash, decode):
    """Phase 2: kernels vs plain versions; times at the serve shapes."""
    errs = {"flash": 0.0, "flash_fp32": 0.0, "decode": 0.0}
    B, H, K, D = PER_TASK, 16, 8, 128
    S = PROMPT + NEW
    cases = [(label, dt, sq, s_cache, ci)
             for label, sq, s_cache, ci in (("serve", PROMPT, S, PROMPT + 31),
                                            ("ragged", 13, 24, 11))
             for dt in (torch.bfloat16, torch.float32)]
    flash_inputs = {}
    for label, dt, sq, s_cache, ci in cases:
        q = randn((B, sq, H, D), dt, 1)
        k = randn((B, sq, K, D), dt, 2)
        v = randn((B, sq, K, D), dt, 3)
        kern = flash.forward_kernel(dt)
        before = kern.launches
        out, lse = flash.flash_attention_fwd(q, k, v, causal=True)
        if kern.launches != before + 1:
            raise AssertionError(f"flash {str(dt)[6:]} did not launch {kern.name}")
        ref, ref_lse = flash.flash_attention_plain(q, k, v, causal=True)
        tag = f"flash ({kern.name}) {label} {str(dt)[6:]} Sq=Skv={sq}"
        key = "flash" if dt == torch.bfloat16 else "flash_fp32"
        errs[key] = max(errs[key], check(tag + " out", out, ref, RTOL[dt]),
                        check(tag + " lse", lse, ref_lse, 0.0))
        qd = randn((B, 1, H, D), dt, 4)
        kc = randn((B, s_cache, K, D), dt, 5)
        vc = randn((B, s_cache, K, D), dt, 6)
        got = decode.decode_attention_fwd(qd, kc, vc, cache_index=ci)
        ref = decode.decode_attention_plain(qd, kc, vc, cache_index=ci)
        errs["decode"] = max(errs["decode"], check(
            f"decode {label} {str(dt)[6:]} S={s_cache} cache_index={ci}",
            got, ref, RTOL[dt]))
        if label == "serve":
            flash_inputs[dt] = (q, k, v)
            if dt == torch.bfloat16:
                decode_inputs = (qd, kc, vc, ci)
    torch.cuda.synchronize()

    rows = {}
    for dt, key in ((torch.bfloat16, "flash"), (torch.float32, "flash_fp32")):
        q, k, v = flash_inputs[dt]
        out = torch.empty_like(q)
        lse = torch.empty((B, H, q.shape[1]), device="cuda")
        r = dict(ms=graph_ms(lambda: flash.flash_attention_fwd(q, k, v, causal=True)),
                 plain_ms=graph_ms(lambda: flash.flash_attention_plain(q, k, v, causal=True)),
                 call_ms=cuda_ms(lambda: flash.flash_attention_fwd(q, k, v, causal=True)))
        r["library_ms"], r["library"] = sdpa_library_ms(q, k, v, is_causal=True)
        r["bound_ms"], r["bound_by"] = bound(
            4 * D * causal_pairs(B, H, q.shape[1], k.shape[1]),
            nbytes(q, k, v, out, lse), q.dtype)
        r["host_us"] = host_us(lambda: flash.flash_attention_fwd(q, k, v, causal=True))
        rows[key] = r
    q, k, v = flash_inputs[torch.bfloat16]
    say(f"  bf16 flash kernel's three TMA descriptors: {describe_us(flash, q, k, v):.2f} "
        "us of host time a call")
    qd, kc, vc, ci = decode_inputs
    n = ci + 1
    mask = (torch.arange(kc.shape[1], device="cuda") <= ci).view(1, 1, 1, -1)
    splits = kernel_entry(decode.KERNEL, "_splits", 4)
    de = None
    for b in (B, 1):  # the serve batch, then one request alone
        q1, k1, v1 = qd[:b], kc[:b], vc[:b]
        got = decode.decode_attention_fwd(q1, k1, v1, cache_index=ci)
        if b != B:
            errs["decode"] = max(errs["decode"], check(
                f"decode serve bf16 B={b} cache_index={ci}", got,
                decode.decode_attention_plain(q1, k1, v1, cache_index=ci), RTOL[qd.dtype]))
        r = dict(
            ms=graph_ms(lambda: decode.decode_attention_fwd(q1, k1, v1, cache_index=ci)),
            plain_ms=graph_ms(lambda: decode.decode_attention_plain(q1, k1, v1,
                                                                    cache_index=ci)),
            call_ms=cuda_ms(lambda: decode.decode_attention_fwd(q1, k1, v1, cache_index=ci)))
        r["library_ms"], r["library"] = sdpa_library_ms(q1, k1, v1, attn_mask=mask)
        kv_read = 2 * b * n * K * D * kc.element_size()
        r["bound_ms"], r["bound_by"] = bound(4 * D * b * H * n,
                                             kv_read + 2 * nbytes(q1), qd.dtype)
        s = splits(b, H, K, ci)
        say(f"  decode B={b}: {s} KV splits a cluster, {s * b * K} blocks; kernel "
            f"{r['ms']:.4f} ms, library {fmt_ms(r['library_ms'])} (SDPA {r['library']}), "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        de = de or r
    for name, r in (("flash bf16", rows["flash"]), ("flash fp32", rows["flash_fp32"]),
                    ("decode", de)):
        host = f", host {r['host_us']:.1f} us a call" if "host_us" in r else ""
        say(f"  {name} at serve shapes (graph-timed): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {fmt_ms(r['library_ms'])} (SDPA "
            f"{r['library']}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            f"back-to-back calls of the wrapper {r['call_ms']:.4f} ms{host}")
    return errs, rows["flash"], rows["flash_fp32"], de


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


def profile_task(api, params, tokens, new):
    """Profile one prefill and one decode step of one task alone."""
    budget = PROMPT + new
    profile_window("prefill of one task", lambda i: api.prefill(
        params, {"tokens": tokens}, seq_budget=budget), 2)
    _, caches = api.prefill(params, {"tokens": tokens}, seq_budget=budget)
    nxt = tokens[:, -1:].to(torch.int32)
    profile_window("decode step of one task", lambda i: api.decode(
        params, {"tokens": nxt, "cache_index": PROMPT + i}, caches), 4)


def time_one_task(api, params, tokens, new):
    """Prefill ms and decode ms per step of one task alone on the card,
    CUDA events, median of TIMED_ROUNDS rounds after one untimed round
    (the path is host-bound and the host is shared: one round can read
    several times the others); then one profiled prefill and decode step."""
    times = []
    for r in range(TIMED_ROUNDS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        logits, caches = api.prefill(params, {"tokens": tokens},
                                     seq_budget=PROMPT + new)
        ev[1].record()
        for i in range(new):
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
            logits, caches = api.decode(
                params, {"tokens": nxt, "cache_index": PROMPT + i}, caches)
        ev[2].record()
        torch.cuda.synchronize()
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        if r:
            times.append((ev[0].elapsed_time(ev[1]),
                          ev[1].elapsed_time(ev[2]) / new))
    prefill_ms = [t[0] for t in times]
    decode_ms = [t[1] for t in times]
    say(f"  one task alone on the card, median of {TIMED_ROUNDS} rounds: "
        f"prefill {np.median(prefill_ms):.3f} ms (B={tokens.shape[0]}, "
        f"{tokens.shape[1]} tokens; rounds "
        f"{', '.join(f'{t:.3f}' for t in prefill_ms)}), decode "
        f"{np.median(decode_ms):.3f} ms per step (rounds "
        f"{', '.join(f'{t:.3f}' for t in decode_ms)})")
    profile_task(api, params, tokens, new)


def full_width_phase(api, params, cfg, dev, plain_ops, batches=FULL_WIDTH_BATCHES,
                     limits=(FULL_WIDTH_MAX_ERR, FULL_WIDTH_MEAN_ERR)):
    """Phases 4 and 11: one prefill and one decode step of each of
    ``batches`` prompt batches, through the kernels (the serving dispatch)
    and through the plain versions; |logits difference| held to
    ``limits`` (largest, mean)."""
    budget = PROMPT + NEW
    max_lim, mean_lim = limits
    for i in range(batches):
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
                f"{max_lim:g}), mean |diff| {mean:.3e} (limit "
                f"{mean_lim:g}), max |logit| "
                f"{b.abs().max().item():.3f}, greedy tokens agree on "
                f"{agree:.2f} of rows")
            if not (err <= max_lim and mean <= mean_lim):
                raise AssertionError(f"batch {i} {name}: full-width logits "
                                     "through the kernels disagree")


def backward_phase(flash):
    """Phase 5: the backward kernels vs the plain backward, each dtype's
    Hopper pair; times at the training shapes."""
    errs = {dt: {"dq": 0.0, "dkv": 0.0} for dt in (torch.bfloat16, torch.float32)}
    B, H, K, D = TRAIN_BATCH, 16, 8, 128
    inputs = {}
    for label, S in (("train", TRAIN_SEQ), ("ragged", 13)):
        for dt in (torch.bfloat16, torch.float32):
            q = randn((B, S, H, D), dt, 21)
            k = randn((B, S, K, D), dt, 22)
            v = randn((B, S, K, D), dt, 23)
            g = randn((B, S, H, D), dt, 24)
            out, lse = flash.flash_attention_fwd(q, k, v, causal=True)
            pair = flash.backward_kernels(dt)
            before = [kern.launches for kern in pair]
            got = flash.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
            if [kern.launches for kern in pair] != [n + 1 for n in before]:
                raise AssertionError(f"{str(dt)[6:]} backward did not launch "
                                     f"{pair[0].name} and {pair[1].name}")
            ref = flash.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=True)
            tag = f"{label} {str(dt)[6:]} S={S} ({pair[0].name}, {pair[1].name})"
            for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                key = "dq" if name == "dq" else "dkv"
                errs[dt][key] = max(errs[dt][key], check(f"{name} {tag}", a, b, RTOL[dt],
                                                         BWD_ATOL))
            again = flash.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            say(f"  dq, dk, dv {tag}: two launches bit-identical: {same}")
            if not same:
                raise AssertionError(f"{tag}: the backward is not deterministic")
            if label == "train":
                inputs[dt] = (q, k, v, out, lse, g)
    torch.cuda.synchronize()

    pairs = causal_pairs(B, H, TRAIN_SEQ, TRAIN_SEQ)
    rows = {}
    for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        q, k, v, out, lse, g = inputs[dt]
        dq, dvec = flash.bwd_dq_launch(q, k, v, out, lse, g, causal=True)
        dk, dv = flash.bwd_dkv_launch(q, k, v, g, lse, dvec, causal=True)
        plain_ms = graph_ms(lambda: flash.flash_attention_bwd_plain(
            q, k, v, out, lse, g, causal=True))
        both_ms = graph_ms(lambda: flash.flash_attention_bwd(q, k, v, out, lse, g, causal=True))
        library_ms, library = sdpa_backward_ms(q, k, v, g)
        lib = dict(plain_ms=plain_ms, library_ms=library_ms, library=library)
        rows["dq" + sfx] = dict(ms=graph_ms(lambda: flash.bwd_dq_launch(
            q, k, v, out, lse, g, causal=True)), **lib)
        rows["dkv" + sfx] = dict(ms=graph_ms(lambda: flash.bwd_dkv_launch(
            q, k, v, g, lse, dvec, causal=True)), **lib)
        rows["dq" + sfx]["bound_ms"], rows["dq" + sfx]["bound_by"] = bound(
            6 * D * pairs, nbytes(q, k, v, out, g, lse, dq, dvec), dt)
        rows["dkv" + sfx]["bound_ms"], rows["dkv" + sfx]["bound_by"] = bound(
            8 * D * pairs, nbytes(q, k, v, g, lse, dvec, dk, dv), dt)
        for name in ("dq" + sfx, "dkv" + sfx):
            r = rows[name]
            say(f"  {name} at training shapes (graph-timed): kernel {r['ms']:.4f} ms, plain "
                f"backward (dq, dk, dv) {r['plain_ms']:.4f} ms, library backward "
                f"(SDPA {r['library']}, dq, dk, dv together) {fmt_ms(r['library_ms'])}, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        ratio = "" if library_ms is None else f" ({both_ms / library_ms:.2f}x)"
        say(f"  {str(dt)[6:]} backward, dq + dk/dv in one call (graph-timed) {both_ms:.4f} ms "
            f"(the two kernels timed alone: {rows['dq' + sfx]['ms'] + rows['dkv' + sfx]['ms']:.4f}"
            f" ms) beside SDPA's whole backward (SDPA {library}) "
            f"{fmt_ms(library_ms)}{ratio}")
    return errs, rows


def group_of(name: str) -> str:
    """Parameter group: the name without its layer index."""
    parts = name.split(".")
    return ".".join(parts[2:]) if parts[0] == "blocks" else name


def sync_training_phase(api, params, dev, kernels):
    """Phase 6: full-width sync training; returns (launches, state)."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.data import MarkovDataset
    from repro_torch.runtime.train_loop import (TrainConfig, Trainer,
                                                make_train_state)

    cfg = api.cfg
    tc = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=100, seed=SEED)
    ds = MarkovDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    state = make_train_state(api, tc, params=params)
    trainer = Trainer(api, tc, ds, state=state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.KERNELS:
        kern.launches = 0
    logs = trainer.run(TRAIN_STEPS)
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = [m["step_time_s"] for m in logs]
    med = float(np.median(step_s))
    say(f"  {cfg.name}: {cfg.n_layers} layers, {TRAIN_STEPS} AdamW steps "
        f"({cfg.opt_state_dtype} moments) on batches of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens")
    losses = ", ".join(f"{m['loss']:.4f}" for m in logs)
    norms = ", ".join(f"{m['grad_norm']:.3f}" for m in logs)
    say(f"  losses {losses}; grad norms {norms}")
    steps = ", ".join(f"{t * 1e3:.1f}" for t in step_s)
    say(f"  step time median {med * 1e3:.1f} ms (steps {steps}; after the first "
        f"{np.median(step_s[1:]) * 1e3:.1f} ms), {TRAIN_BATCH * TRAIN_SEQ / med:.0f} "
        f"tok/s; peak memory {peak:.2f} GB")
    say(f"  launches on the training path: {launches}")
    if not all(np.isfinite(m["loss"]) for m in logs):
        raise AssertionError("non-finite training loss")
    for name in BF16_TRAIN_KERNELS:
        if launches[name] < cfg.n_layers * TRAIN_STEPS:
            raise AssertionError(f"{name}: {launches[name]} launches, fewer "
                                 "than training needs")
    for name in FP32_TRAIN_KERNELS:
        if launches[name]:
            raise AssertionError(f"the fp32 kernel {name} ran on the bf16 training path")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(99).items()}
    profile_window("training step", lambda i: trainer.train_step(state, batch), 1)

    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    save(str(ckpt), TRAIN_STEPS, state)
    t_save = time.perf_counter() - t0
    fresh = make_train_state(api, TrainConfig(seed=SEED + 1), device=dev)
    t0 = time.perf_counter()
    restore(str(ckpt), TRAIN_STEPS, fresh)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file()) / 1e9
    same = all(torch.equal(a, b) for a, b in zip(state["params"].parameters(),
                                                 fresh["params"].parameters()))
    same_opt = all(torch.equal(state["opt"][m][k], fresh["opt"][m][k])
                   for m in ("m", "v") for k in state["opt"][m])
    say(f"  checkpoint: {size:.2f} GB saved in {t_save:.1f} s, restored into a "
        f"fresh state in {t_restore:.1f} s; parameters bit-identical: {same}, "
        f"moments bit-identical: {same_opt}")
    shutil.rmtree(ckpt, ignore_errors=True)
    if not (same and same_opt):
        raise AssertionError("checkpoint restore is not bit-identical")
    del fresh
    return launches, state


def train_step_agreement(api, model, dev, plain_ops):
    """One training step's loss and gradients, kernels vs plain versions,
    held to ``TRAIN_LIMITS`` for the model's dtype."""
    from repro_torch.data import MarkovDataset
    from repro_torch.runtime.train_loop import loss_and_grads

    loss_lim, grad_lim = TRAIN_LIMITS[api.cfg.dtype]
    ds = MarkovDataset(api.cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED + 7)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(0).items()}
    loss_k, _, g_k = loss_and_grads(api, model, batch)
    loss_p, _, g_p = loss_and_grads(api, model, batch, ops=plain_ops)
    dloss = abs(loss_k.item() - loss_p.item())
    say(f"  {api.cfg.compute_dtype}: loss through the kernels "
        f"{loss_k.item():.6f}, through the plain versions {loss_p.item():.6f}: "
        f"|dloss| {dloss:.3e} (limit {loss_lim:g})")
    num: dict = {}
    den: dict = {}
    for name in g_k:
        grp = group_of(name)
        d = (g_k[name].float() - g_p[name].float()).square().sum()
        num[grp] = num.get(grp, 0.0) + d
        den[grp] = den.get(grp, 0.0) + g_p[name].float().square().sum()
    worst = 0.0
    for grp in num:
        rel = (num[grp].sqrt() / den[grp].sqrt().clamp_min(1e-30)).item()
        worst = max(worst, rel)
        say(f"    {grp}: ||g_kernels - g_plain|| / ||g_plain|| {rel:.3e}")
    say(f"  largest relative gradient difference {worst:.3e} (limit "
        f"{grad_lim:g})")
    if not (dloss <= loss_lim and worst <= grad_lim):
        raise AssertionError("training step through the kernels disagrees "
                             "with the plain versions")


def farm_phase(cfg, dev, lookup, services, kernels):
    """Phase 8: farm-mode training, depth cut to FARM_LAYERS."""
    from repro_torch.models import build
    from repro_torch.runtime.local_sgd import LocalSGDConfig, LocalSGDTrainer
    from repro_torch.runtime.train_loop import TrainConfig

    cut = cfg.replace(n_layers=FARM_LAYERS)
    say(f"  depth cut: {cfg.n_layers} -> {FARM_LAYERS} layers at full width "
        f"(at {cfg.n_layers} layers each in-flight task holds ~35 GB: a weight "
        "copy, its AdamW moments, grads, activations and an fp32 delta; two "
        "do not fit beside the client's weights, velocity and deltas)")
    api = build(cut)
    tc = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=100, seed=SEED)
    ls = LocalSGDConfig(inner_steps=FARM_INNER, n_shards=FARM_SHARDS,
                        batch_per_shard=FARM_BATCH, seq_len=TRAIN_SEQ)
    tr = LocalSGDTrainer(api, tc, ls, lookup=lookup, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.KERNELS:
        kern.launches = 0
    for r in range(2):
        if r == 1:
            services[0].fail_after(1)
        t0 = time.perf_counter()
        loss = tr.run_round(timeout=600.0)
        wall = time.perf_counter() - t0
        st = tr.farm_stats[-1]
        say(f"  round {r}{' (one service fails after one task)' if r else ''}: "
            f"loss {loss:.4f}, {st['done']} of {FARM_SHARDS} tasks done, "
            f"{st['reschedules']} reschedules, per service {st['per_service']}, "
            f"{wall:.2f} s")
        if not (np.isfinite(loss) and st["done"] == FARM_SHARDS):
            raise AssertionError(f"farm round {r} did not complete")
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    say(f"  launches in the farm rounds: {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for name in BF16_TRAIN_KERNELS:
        if launches[name] < 2 * FARM_SHARDS * FARM_INNER * FARM_LAYERS:
            raise AssertionError(f"farm training launched {name} fewer times "
                                 "than it needs")
    for name in FP32_TRAIN_KERNELS:
        if launches[name]:
            raise AssertionError(f"the fp32 kernel {name} ran on the bf16 farm path")


def sm_clock_hz() -> float:
    """The card's maximum SM clock, read from ``nvidia-smi``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def scan_inputs(b, s, d, n, seed):
    x = randn((b, s, d), torch.float32, seed)
    dt = torch.nn.functional.softplus(randn((b, s, d), torch.float32, seed + 1))
    A = -torch.exp(randn((d, n), torch.float32, seed + 2) * 0.5)
    B = randn((b, s, n), torch.float32, seed + 3)
    C = randn((b, s, n), torch.float32, seed + 4)
    return x, dt, A, B, C


def scan_phase(scan, b, s, d, n):
    """Phase 9: the scan kernel vs the plain chunked scan at the serve
    shape (b, s, d, n), a ragged one, with h0 (two halves chained against
    one whole scan) and with strided views; then kernel and plain timed at
    the serve shape beside the bound's three terms."""
    err = 0.0

    def both(tag, *args):
        nonlocal err
        got = scan.mamba_scan_fwd(*args)
        ref = scan.mamba_scan_plain(*args)
        for name, a, r in zip(("y", "h_final"), got, ref):
            err = max(err, check(f"{tag} {name}", a, r, SCAN_TOL, SCAN_TOL))
        return got

    serve = scan_inputs(b, s, d, n, 31)
    y, h = both(f"scan serve ({b}, {s}, {d}, {n})", *serve)
    both("scan ragged (2, 13, 96, 16)", *scan_inputs(2, 13, 96, 16, 41))
    x, dt, A, B, C = serve
    half = s // 2
    y1, h1 = both("scan first half", x[:, :half], dt[:, :half], A, B[:, :half],
                  C[:, :half])
    y2, h2 = both("scan second half from h0", x[:, half:], dt[:, half:], A,
                  B[:, half:], C[:, half:], h1)
    err = max(err, check("scan halves chained vs whole: y", torch.cat([y1, y2], 1),
                         y, SCAN_TOL, SCAN_TOL),
              check("scan halves chained vs whole: h_final", h2, h, SCAN_TOL,
                    SCAN_TOL))
    xz = torch.cat([x, torch.zeros_like(x)], -1)
    proj = torch.cat([B.new_zeros(b, s, 3), B, C], -1)
    xv, Bv, Cv = xz[..., :d], proj[..., 3:3 + n], proj[..., 3 + n:]
    assert not (xv.is_contiguous() or Bv.is_contiguous() or Cv.is_contiguous())
    both("scan strided x, B, C", xv, dt, A, Bv, Cv)
    torch.cuda.synchronize()

    row = dict(ms=graph_ms(lambda: scan.mamba_scan_fwd(*serve)),
               call_ms=cuda_ms(lambda: scan.mamba_scan_fwd(*serve)),
               plain_ms=cuda_ms(lambda: scan.mamba_scan_plain(*serve), iters=5),
               library_ms=None)
    elements = b * s * d * n
    t_bytes = nbytes(*serve, y, h) / PEAK_BYTES_S * 1e3
    t_exp = elements / (MUFU_PER_CLOCK_SM * SMS * sm_clock_hz()) * 1e3
    t_flop = SCAN_FLOP_PER_ELEMENT * elements / PEAK_FLOP_S[torch.float32] * 1e3
    row["bound_ms"] = max(t_bytes, t_exp, t_flop)
    row["bound_by"] = "bytes" if t_bytes >= max(t_exp, t_flop) else "operations"
    say(f"  scan at the serve shape ({b}, {s}, {d}, {n}): kernel {row['ms']:.4f} ms "
        f"graph-timed ({row['call_ms']:.4f} ms back to back), plain "
        f"{row['plain_ms']:.4f} ms, no library call; bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}): bytes "
        f"{nbytes(*serve, y, h) / 1e6:.1f} MB in {t_bytes:.4f} ms, "
        f"{elements / 1e6:.1f} M exponentials in {t_exp:.4f} ms, "
        f"{SCAN_FLOP_PER_ELEMENT * elements / 1e9:.2f} GFLOP fp32 in {t_flop:.4f} ms")
    return err, row


def mamba_serve_phase(cfg, dev, lookup, kernels):
    """Phase 10: serve full-width, full-depth falcon-mamba-7b; returns
    (api, params, launches)."""
    from repro_torch.kernels.mamba_scan import KERNEL as SCAN
    from repro_torch.models import build
    from repro_torch.runtime.serve_loop import ServeConfig, serve_requests

    api = build(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    say(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_inner "
        f"{cfg.d_inner}, {sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
        f"params in {cfg.param_dtype} on {dev}, initialised in "
        f"{time.perf_counter() - t0:.2f} s; fp32 unembedding copy "
        f"{params.head().table_f32().numel() * 4 / 1e9:.3f} GB")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                   (MAMBA_REQUESTS, PROMPT))
    sc = ServeConfig(max_new_tokens=MAMBA_NEW, prompt_len=PROMPT,
                     batch_per_task=PER_TASK)
    serve_requests(api, params, prompts[:PER_TASK],
                   ServeConfig(max_new_tokens=2, prompt_len=PROMPT,
                               batch_per_task=PER_TASK), lookup=lookup)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 1e9
    for kern in kernels.KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    gen, stats = serve_requests(api, params, prompts, sc, lookup=lookup)
    wall = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    n_tasks = MAMBA_REQUESTS // PER_TASK
    say(f"  allocated before the run: {resident:.2f} GB")
    say(f"  served {tuple(gen.shape)} tokens in {wall:.3f} s: "
        f"{gen.numel() / wall:.1f} tok/s across {SERVICES} services; "
        f"{stats['done']} tasks, {stats['reschedules']} reschedules; peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    say(f"  launches on the main path: {launches}")
    if tuple(gen.shape) != (MAMBA_REQUESTS, MAMBA_NEW):
        raise AssertionError(f"generated shape {tuple(gen.shape)}")
    if not (int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size):
        raise AssertionError("generated token ids out of range")
    # one scan per layer per task, in prefill; decode has no kernel
    if launches[SCAN.name] != n_tasks * cfg.n_layers:
        raise AssertionError(f"scan kernel launched {launches[SCAN.name]} "
                             f"times, not {n_tasks} tasks x {cfg.n_layers} layers")
    time_one_task(api, params, torch.as_tensor(prompts[:PER_TASK]).to(dev),
                  MAMBA_NEW)
    return api, params, launches


def mamba_train_phase(cfg, dev, kernels, full_params):
    """Phase 12: sync training of falcon-mamba-7b at full width, depth cut
    to MAMBA_TRAIN_LAYERS; ``full_params`` is the full-depth model's
    parameter count."""
    from repro_torch.data import MarkovDataset
    from repro_torch.kernels.mamba_scan import KERNEL as SCAN
    from repro_torch.models import build
    from repro_torch.runtime.train_loop import TrainConfig, Trainer

    cut = cfg.replace(n_layers=MAMBA_TRAIN_LAYERS)
    say(f"  depth cut: {cfg.n_layers} -> {MAMBA_TRAIN_LAYERS} layers at full "
        f"width (at {cfg.n_layers} layers the fp32 AdamW moments alone take "
        f"{8 * full_params / 1e9:.1f} GB beside {2 * full_params / 1e9:.1f} GB "
        f"of bf16 weights and as much again of gradients)")
    api = build(cut)
    tc = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=100, seed=SEED)
    ds = MarkovDataset(cut.vocab_size, TRAIN_SEQ, MAMBA_TRAIN_BATCH, seed=SEED)
    trainer = Trainer(api, tc, ds, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.KERNELS:
        kern.launches = 0
    logs = trainer.run(TRAIN_STEPS)
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = [m["step_time_s"] for m in logs]
    med = float(np.median(step_s))
    say(f"  {cut.name}: {cut.n_layers} layers, "
        f"{sum(p.numel() for p in trainer.state['params'].parameters()) / 1e9:.3f} B "
        f"params, {TRAIN_STEPS} AdamW steps ({cut.opt_state_dtype} moments) on "
        f"batches of {MAMBA_TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    losses = ", ".join(f"{m['loss']:.4f}" for m in logs)
    norms = ", ".join(f"{m['grad_norm']:.3f}" for m in logs)
    steps = ", ".join(f"{t * 1e3:.1f}" for t in step_s)
    say(f"  losses {losses}; grad norms {norms}")
    say(f"  step time median {med * 1e3:.1f} ms (steps {steps}; after the first "
        f"{np.median(step_s[1:]) * 1e3:.1f} ms), {MAMBA_TRAIN_BATCH * TRAIN_SEQ / med:.0f} "
        f"tok/s; peak memory {peak:.2f} GB")
    say(f"  launches on the training path: {launches}")
    if not all(np.isfinite(m["loss"]) for m in logs):
        raise AssertionError("non-finite training loss")
    # one scan per layer per step, in the forward; the backward recomputes
    # through the plain chunked scan and launches no kernel
    if launches[SCAN.name] != TRAIN_STEPS * MAMBA_TRAIN_LAYERS:
        raise AssertionError(f"scan kernel launched {launches[SCAN.name]} "
                             f"times in training, not {TRAIN_STEPS} steps x "
                             f"{MAMBA_TRAIN_LAYERS} layers")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(99).items()}
    profile_window("training step", lambda i: trainer.train_step(
        trainer.state, batch), 1)


# --------------------------------------------------------------------- #
# phase 13: the farm over worker processes
# --------------------------------------------------------------------- #
# Weights cannot ride a program to a worker: qwen3-1.7B's bf16 weights are
# 3.2 GiB, over the wire's 1 GiB frame cap.  So the serve program a worker
# gets carries only (arch, seed, ServeConfig); its first call builds the
# weights on the worker's device from phase 3's seeded generator, and the
# worker process keeps them for its later tasks and connections (a worker
# unpickles a shipped program once per connection, and every round's
# client opens new connections).
_WORKER_MODELS: dict = {}


class WorkerGenerate:
    """Phase 3's serve program, shipped to a worker by reference (as
    ``chip_smoke.WorkerGenerate``: workers import this file)."""

    def __init__(self, arch, seed, sc):
        self.arch, self.seed, self.sc = arch, seed, sc

    def __call__(self, payload):
        dev = payload["tokens"].device  # the worker's service device
        key = (self.arch, self.seed, self.sc, str(dev))
        generate = _WORKER_MODELS.get(key)
        if generate is None:
            import repro_torch.configs as cfgs
            from repro_torch.models import build
            from repro_torch.runtime.serve_loop import make_generate_program

            api = build(cfgs.get(self.arch))
            params = api.init(torch.Generator(device=dev).manual_seed(self.seed))
            generate = make_generate_program(api, self.sc, params).fn
            _WORKER_MODELS[key] = generate
        return generate(payload)


class WorkerLaunches:
    """A worker's kernel launch counts by kernel name (launch counters are
    per process); with ``reset`` every count is set to 0 first."""

    def __init__(self, reset: bool):
        self.reset = reset

    def __call__(self, payload):
        from repro_torch import kernels

        if self.reset:
            for kern in kernels.KERNELS:
                kern.launches = 0
        return {kern.name: kern.launches for kern in kernels.KERNELS}


def worker_round(label, program, prompts, lookup, ref, on_client=None):
    """One farm round over the pool registered in ``lookup``; its tokens
    must equal ``ref`` (phase 3's for the same prompts) bit for bit.
    Returns (wall s, client stats, perf_counter of the first result)."""
    from repro_torch.core import BasicClient

    tasks = [{"tokens": torch.as_tensor(prompts[i:i + PER_TASK])}
             for i in range(0, len(prompts), PER_TASK)]
    out: list = []
    client = BasicClient(program, None, tasks, out, lookup=lookup,
                         speculation=False)
    first: dict = {}

    def watch_first():
        if client.repository.wait_until(lambda s: s["done"] >= 1, timeout=900):
            first["t"] = time.perf_counter()

    threading.Thread(target=watch_first, daemon=True).start()
    if on_client is not None:
        on_client(client)
    t0 = time.perf_counter()
    client.compute(timeout=900)
    wall = time.perf_counter() - t0
    stats = client.stats()
    gen = torch.cat([o["generated"] for o in out], dim=0)
    same = tuple(gen.shape) == tuple(ref.shape) and torch.equal(gen, ref)
    say(f"  {label}: {tuple(gen.shape)} tokens in {wall:.3f} s, "
        f"{gen.numel() / wall:.1f} tok/s; {stats['done']} tasks, "
        f"{stats['reschedules']} reschedules, per worker {stats['per_service']}; "
        f"tokens equal phase 3's: {same}")
    if not same:
        differ = (gen != ref).any(dim=1).nonzero().flatten().tolist() \
            if gen.shape == ref.shape else "shape"
        raise AssertionError(f"{label}: tokens differ from phase 3's "
                             f"(rows {differ})")
    return wall, stats, first.get("t")


def worker_phase(prompts, ref_gen, inproc, smi, kernels):
    """Phase 13: phase 3's load on 2 proc:// workers (cold, warm with the
    workers' launch counts, one worker SIGKILLed), then on 2 shm://
    workers.  ``inproc`` is phase 3's (wall s, tok/s)."""
    import chip_smoke  # run as __main__: ship the programs by module name
    import repro_torch.configs as cfgs
    from repro_torch.core import LookupService, Program, resolve_handle
    from repro_torch.kernels import decode_attention as decode
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.now import NowPool
    from repro_torch.runtime.serve_loop import ServeConfig

    # workers import chip_smoke: the repo root goes on their PYTHONPATH
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    sc = ServeConfig(max_new_tokens=NEW, prompt_len=PROMPT,
                     batch_per_task=PER_TASK)
    program = Program(chip_smoke.WorkerGenerate(ARCH, SEED, sc),
                      name=f"generate[{ARCH}]")
    reset = Program(chip_smoke.WorkerLaunches(True), name="launches-reset",
                    host=True)
    read = Program(chip_smoke.WorkerLaunches(False), name="launches", host=True)
    n_tasks = REQUESTS // PER_TASK
    lookup = LookupService()
    t_start = time.perf_counter()
    with NowPool(WORKERS, lookup, service_prefix="gpu-proc") as pool:
        cold, _, t_first = worker_round(
            f"round 1 (cold) on {WORKERS} proc:// workers", program, prompts,
            lookup, ref_gen)
        startup = t_first - t_start
        say(f"  worker start-up to first result: {startup:.3f} s (pool "
            f"start, torch import, CUDA context, weight build, first task)")
        handles = [resolve_handle(w.descriptor) for w in pool.workers]
        try:
            for h in handles:
                h.execute(reset, None)
            warm, _, _ = worker_round(f"round 2 (warm) on {WORKERS} proc:// "
                                      "workers", program, prompts, lookup, ref_gen)
            counts = [h.execute(read, None) for h in handles]
        finally:
            for h in handles:
                h.close()
        summed = {k.name: sum(c[k.name] for c in counts) for k in kernels.KERNELS}
        say(f"  launches in the workers (round 2, {n_tasks} tasks): per worker "
            f"{counts}")
        want = {k.name: 0 for k in kernels.KERNELS}
        layers = cfgs.get(ARCH).n_layers
        want[flash.SM90_KERNEL.name] = n_tasks * layers
        want[decode.KERNEL.name] = n_tasks * layers * NEW
        if summed != want:
            raise AssertionError(f"worker launches {summed}, expected {want}")

        victim = pool.workers[0].service_id
        killed = threading.Event()

        def arm_killer(client):
            def killer():
                # after the victim's first task, once it holds another lease
                if client.repository.wait_until(
                        lambda s: s["per_service"].get(victim, 0) >= 1
                        and (s["leased"] >= 2 or s["pending"] == 0),
                        timeout=900):
                    pool.kill(0)  # SIGKILL: no goodbye
                    killed.set()
            threading.Thread(target=killer, daemon=True).start()

        kill_wall, kill_stats, _ = worker_round(
            "round 3, worker 0 SIGKILLed after its first task", program,
            prompts, lookup, ref_gen, on_client=arm_killer)
        if not killed.is_set() or pool.workers[0].alive:
            raise AssertionError("worker 0 was not killed during round 3")
        if kill_stats["reschedules"] < 1:
            raise AssertionError("no task was rescheduled after the kill")
    lookup = LookupService()
    with NowPool(WORKERS, lookup, service_prefix="gpu-shm",
                 transport="shm") as pool:
        shm_wall, _, _ = worker_round(
            f"round 4 (cold) on {WORKERS} shm:// workers, {SHM_REQUESTS} "
            "requests", program, prompts[:SHM_REQUESTS], lookup,
            ref_gen[:SHM_REQUESTS])
    from repro_torch.core.transport.shm import detach_all
    detach_all()
    tok = REQUESTS * NEW
    say(f"  {smi}: in-process (phase 3, {SERVICES} services) {inproc[0]:.3f} s, "
        f"{inproc[1]:.1f} tok/s; proc:// cold {cold:.3f} s ({tok / cold:.1f} "
        f"tok/s, start-up to first result {startup:.3f} s), warm {warm:.3f} s "
        f"({tok / warm:.1f} tok/s), with a kill {kill_wall:.3f} s "
        f"({tok / kill_wall:.1f} tok/s); shm:// cold {shm_wall:.3f} s "
        f"({SHM_REQUESTS * NEW / shm_wall:.1f} tok/s)")


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
    from repro_torch.kernels import mamba_scan as scan
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
    for kern in (flash.SM90_KERNEL, flash.SM90_FP32_KERNEL, flash.DQ_SM90_KERNEL,
                 flash.DKV_SM90_KERNEL, flash.DQ_SM90_FP32_KERNEL,
                 flash.DKV_SM90_FP32_KERNEL):
        say_sass(kern)
    for kern in (decode.KERNEL, scan.KERNEL):
        say_sass(kern, ("LDGSTS",))
    for kern in (flash.DQ_SM90_FP32_KERNEL, flash.DKV_SM90_FP32_KERNEL):
        say_smem(kern)
    say_async_smem(decode, scan)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    say(smi)

    say("phase 2: kernels vs plain versions")
    errs, fl, fl32, de = kernel_phase(flash, decode)

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
    if launches["flash_attention_sm90"] < n_tasks * cfg.n_layers:
        raise AssertionError("flash kernel launched fewer times than prefill needs")
    if launches["flash_attention_sm90_fp32"]:
        raise AssertionError("the fp32 flash kernel ran on the bf16 serve path")
    if launches[decode.KERNEL.name] < n_tasks * cfg.n_layers * NEW:
        raise AssertionError("decode kernel launched fewer times than decode needs")

    time_one_task(api, params, torch.as_tensor(prompts[:PER_TASK]).to(dev), NEW)

    say("phase 4: full width, kernels vs plain versions")
    full_width_phase(api, params, cfg, dev, kernels.PLAIN)

    say("phase 5: backward kernels vs the plain backward")
    bwd_errs, bwd = backward_phase(flash)

    say("phase 6: sync training at full width")
    train_launches, state = sync_training_phase(api, params, dev, kernels)

    say("phase 7: full-width training step, kernels vs plain versions")
    train_step_agreement(api, state["params"], dev, kernels.PLAIN)
    del state, params
    torch.cuda.empty_cache()
    api32 = build(cfg.replace(param_dtype="float32", compute_dtype="float32"))
    model32 = api32.init(torch.Generator(device=dev).manual_seed(SEED))
    model32.requires_grad_(True)
    model32.head().drop_f32()
    for kern in kernels.KERNELS:
        kern.launches = 0
    train_step_agreement(api32, model32, dev, kernels.PLAIN)
    fp32_launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    say(f"  launches on the fp32 training step: {fp32_launches}")
    if (any(fp32_launches[name] != cfg.n_layers for name in FP32_TRAIN_KERNELS)
            or any(fp32_launches[name] for name in BF16_TRAIN_KERNELS)):
        raise AssertionError("the fp32 training step did not go through the fp32 "
                             "flash kernels (forward, dq, dk/dv) once per layer, "
                             "and only through them")
    del model32
    torch.cuda.empty_cache()

    say("phase 8: farm-mode training")
    farm_phase(cfg, dev, lookup, services, kernels)
    del api
    free(services)  # their cached programs hold qwen3's weights
    say(f"  qwen3 state freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "still allocated")

    say("phase 9: scan kernel vs plain")
    mcfg = cfgs.get(MAMBA_ARCH)
    scan_err, scan_row = scan_phase(scan, PER_TASK, PROMPT, mcfg.d_inner,
                                    mcfg.ssm.state_dim)

    say("phase 10: serve falcon-mamba-7b")
    for svc in services:  # phase 8 failed one on purpose
        svc.revive()
    mapi, mparams, mamba_launches = mamba_serve_phase(mcfg, dev, lookup, kernels)

    say("phase 11: falcon-mamba-7b full width, kernels vs plain versions")
    full_width_phase(mapi, mparams, mcfg, dev, kernels.PLAIN,
                     MAMBA_FULL_WIDTH_BATCHES,
                     MAMBA_FULL_WIDTH_LIMITS[torch.bfloat16])
    full_params = sum(p.numel() for p in mparams.parameters())
    del mapi, mparams
    free(services)
    say("  the same in fp32 (fresh fp32 weights)")
    cfg32 = mcfg.replace(param_dtype="float32", compute_dtype="float32")
    api32 = build(cfg32)
    model32 = api32.init(torch.Generator(device=dev).manual_seed(SEED))
    full_width_phase(api32, model32, cfg32, dev, kernels.PLAIN, 2,
                     MAMBA_FULL_WIDTH_LIMITS[torch.float32])
    del api32, model32
    free(services)

    say("phase 12: falcon-mamba-7b sync training, depth cut")
    mamba_train_phase(mcfg, dev, kernels, full_params)
    gc.collect()
    torch.cuda.empty_cache()

    say("phase 13: serve on worker processes (proc://, shm://)")
    worker_phase(prompts, gen, (wall, gen.numel() / wall), smi, kernels)

    rows = []
    flash_py = "src/repro/kernels/flash_attention/flash_attention.py"
    for name, kern, r, err, replaces, count in (
            ("flash_attention_fwd", flash.SM90_KERNEL, fl, errs["flash"],
             f"{flash_py}:127", launches),
            ("flash_attention_fwd_fp32", flash.SM90_FP32_KERNEL, fl32, errs["flash_fp32"],
             f"{flash_py}:127", fp32_launches),
            ("decode_attention_fwd", decode.KERNEL, de, errs["decode"],
             "src/repro/kernels/decode_attention/decode_attention.py:116",
             launches),
            ("flash_attention_bwd_dq", flash.DQ_SM90_KERNEL, bwd["dq"],
             bwd_errs[torch.bfloat16]["dq"], f"{flash_py}:280", train_launches),
            ("flash_attention_bwd_dkv", flash.DKV_SM90_KERNEL, bwd["dkv"],
             bwd_errs[torch.bfloat16]["dkv"], f"{flash_py}:307", train_launches),
            ("flash_attention_bwd_dq_fp32", flash.DQ_SM90_FP32_KERNEL, bwd["dq_fp32"],
             bwd_errs[torch.float32]["dq"], f"{flash_py}:280", fp32_launches),
            ("flash_attention_bwd_dkv_fp32", flash.DKV_SM90_FP32_KERNEL, bwd["dkv_fp32"],
             bwd_errs[torch.float32]["dkv"], f"{flash_py}:307", fp32_launches),
            ("mamba_scan_fwd", scan.KERNEL, scan_row, scan_err,
             "src/repro/kernels/mamba_scan/mamba_scan.py:83", mamba_launches)):
        rows.append({"name": name, "route": "cuda",
                     "source": str(kern.source.relative_to(ROOT)),
                     "replaces": replaces, "launches": count[kern.name],
                     "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "library": r.get("library")})
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
