#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths on ``cuda:0`` — serving as a task farm, and
training in sync and in farm mode, of qwen3-1.7B; serving and sync
training of falcon-mamba-7b; serving and sync training of minicpm3-4b,
phi-3-vision-4.2b and whisper-tiny; serving and sync training of the MoE
family, llama4-maverick and arctic; serving jamba-1.5-large-398b, the
hybrid of Mamba, attention and MoE, and one request of it at long
context; a training step and serving of minicpm3-4b and phi-3-vision-4.2b
in fp32 — and holds every hand-written kernel of those paths against its
plain PyTorch version.  Phases, in order; any
failure raises and exits non-zero:

1. build the CUDA kernels from this checkout's sources (one ``nvcc`` per
   source, all started together), print each kernel's registers, spills
   and static shared memory, count the tensor-core (``HGMMA``) and TMA
   (``UTMALDG``) instructions in the SASS of the six Hopper attention
   libraries (flash forward, backward dq and dk/dv, each in bf16 and in
   fp32; failing if either is 0) and the asynchronous-copy (``LDGSTS``)
   instructions in the decode and scan libraries (failing if 0), print the
   fp32 forward's and backward pair's dynamic shared memory a block at
   each (D, Dv) they take, decode's and the scan's, and print the card's
   name and power limit;
2. each attention kernel against its plain version on the card, on the
   same inputs, at every shape its paths give it (``FLASH_SHAPES``,
   ``DECODE_SHAPES``): qwen3's serve shapes (B=4, H=16, K=8, D=128, Sq =
   Skv = 512, a 576-slot cache) in bf16 and fp32 (flash goes to the Hopper
   kernel of its dtype: fp32 products as three tf32 products each); the
   flash forward at (D, Dv) = (96, 64) (minicpm3's MLA prefill: B=4,
   S=512, H=K=40) and (96, 96) (phi-3's, H=K=32, S=512 and 768) in bf16
   and fp32 (phase 20's), and the bf16 one at
   whisper's D=64, H=K=6: non-causal encoder (1500 x 1500) and
   cross-attention (64 x 1500), causal decoder self-attention (64 x 64);
   decode at D=96 on phi-3's 544-slot cache in bf16 and fp32 and at D=64 on
   whisper's 128-slot self-attention cache; the odd GQA groups of phase 17
   in bf16 at D=128: flash at B=4, S=512, H=40, K=8 (llama4, G=5) and H=56,
   K=8 (arctic, G=7), one q-head a block, and decode at both on a 544-slot
   cache (5 or 7 q-heads in a block of 8); phase 19's G = 8 (jamba: H=64,
   K=8): flash two q-heads a block, decode the block of 8 full.  Each runs
   again at a ragged
   size (Sq = 13; a 24-slot cache with ``cache_index`` mid-cache) and
   decode on one request alone.  Then each kernel, its plain version and
   PyTorch's SDPA are timed at each serve shape (decode in bf16, at B=4
   and at B=1 with the number of KV splits it launched) beside the bound;
   SDPA runs with K and V expanded to H heads outside the timed region,
   under each of its flash, memory-efficient and cuDNN backends that
   takes the inputs, and the fastest is kept with its backend's name.  The
   host cost of the bf16 kernel's three TMA descriptors is timed too;
3. serve full-width qwen3-1.7B (bf16, weights from a seeded generator on
   the card) through ``BasicClient`` on 2 in-process services: 16 requests,
   prompt 512, 64 new tokens, 4 requests per task.  The kernels' launch
   counts are zeroed just before and read just after: every prefill layer
   goes through the bf16 flash kernel, none through the fp32 one;
4. one prefill and one decode step at full width through the kernels and
   through the plain versions, with the same weights, on several prompt
   batches;
5. the flash-backward kernels (dq, then dk/dv) against the plain
   backward at every shape a training path gives them (``BWD_SHAPES``):
   qwen3's (B=4, H=16, K=8, D=128, S=512) in bf16 (the Hopper bf16 pair)
   and fp32 (the Hopper fp32 pair: three tf32 products for each
   product); minicpm3's MLA at (D, Dv) = (96, 64) (B=4, S=512, H=K=40)
   and phi-3's (96, 96) (H=K=32, S=512 and 768) in bf16 and fp32 (phase
   20's), in bf16 whisper's D=64,
   H=K=6: non-causal encoder (1500 x 1500) and cross-attention (448 x
   1500), causal decoder self-attention (448 x 448); the MoE family's odd
   GQA groups at D=128 (B=4, S=512, K=8: H=40, G=5, llama4; H=56, G=7,
   arctic; one q-head a dq block, an odd number of dk/dv steps at Sq = 13);
   each also at a ragged size (Sq = 13, and Skv = 13 where Skv = Sq); a
   second launch bit-identical.  Each kernel, the whole backward (dq + dk/dv in one
   call), the plain backward and PyTorch's SDPA backward timed at each
   training shape beside each kernel's bound: SDPA's backward alone (one
   forward with grad-enabled inputs, then ``autograd.grad`` timed), K and
   V expanded, each backend as in phase 2;
6. sync training of full-width qwen3-1.7B with its depth cut from 28 to
   ``TRAIN_LAYERS`` = 8 layers, fresh seeded weights (``Trainer``, 4
   AdamW steps on MarkovDataset batches of 4 x 512, fp32 moments), the
   launch counts zeroed just before and read just after (the bf16
   forward, dq and dk/dv kernels each at least once per layer per step,
   the fp32 ones never), one profiled step, and a checkpoint saved and
   restored into a fresh state;
7. one full-width training step's loss and gradients (phase 6's depth)
   through the kernels and through the plain versions, same weights,
   same batch, in
   bf16 (the trained weights) and in fp32 (fresh fp32 weights; the launch
   counts zeroed just before and read just after: this is the fp32
   forward, dq and dk/dv kernels' path, once per layer, and no bf16
   kernel's);
8. farm-mode training (``LocalSGDTrainer``) at full width with depth cut
   to 8 layers on the 2 services: one round of 4 tasks, then one more with
   a service failing after one task (the bf16 kernels launched, the fp32
   ones not);
9. (qwen3's state freed) the selective-scan kernel against the plain
   chunked scan in fp32 at the serve shapes (b=4, s=512, n=16, d_inner
   8192 for falcon-mamba, 16384 for jamba), at a ragged (2, 13, 96, 16),
   with h0 (two halves chained against one whole scan) and with strided
   x, B and C; kernel (graph-timed and back to back) and plain timed at
   each serve shape beside the bound's bytes, exponential and flop terms;
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
    time and tok/s are printed beside phase 3's;
14. serve phase 3's load again on a ``TcpPool`` of 2 ``tcp://`` workers
    on ``cuda:0`` bound to 127.0.0.1, which register themselves into a
    network ``LookupServer``; the client's lookup is a ``RemoteLookup``.
    Round 1 is cold; round 2 warm, with the workers' launch counts as in
    phase 13 (handles resolved from the client's lookup); round 3 runs
    after ``LookupServer.restart()`` (registry wiped, every connection
    dropped) once both workers have re-registered through their
    keepalive: both must serve tasks, each worker's ``RemoteLookup`` must
    show a reconnect and a replayed registration, and no worker may
    rebuild its weights (read by a shipped ``WorkerState``); in round 4
    worker 0 is SIGKILLed after its first task and a task must be
    rescheduled.  Every round's tokens must equal phase 3's bit for bit;
    each round's wall time and tok/s are printed beside phase 3's and
    phase 13's;
15. (everything freed) one family at a time, with weights from the seeded
    generator on the card, served through ``BasicClient`` on the 2
    in-process services with every launch count zeroed just before and
    read just after: full-width, full-depth minicpm3-4b (MLA; 8 requests,
    prompt 512, 32 new tokens: exactly 62 bf16 flash launches a task at
    (96, 64) and no decode launch, its decode being the absorbed form)
    and phi-3-vision-4.2b (text only, as ``serve_requests`` builds tasks:
    32 flash launches at (96, 96) and 1,024 decode launches at D=96 a
    task), then whisper-tiny (tasks of 4 prompts of 64 tokens with seeded
    1,500 x 384 stub encoder frames through ``make_generate_program``, 64
    new tokens: 12 flash and 256 decode launches a task); no other kernel
    launches.  minicpm3's task is timed alone and profiled.  Each
    family's prefill and decode logits (phi-3's prefill with 256 seeded
    patch embeddings before 512 tokens, then 4 decode steps at cache_index
    768 + i) through the kernels and through the plain versions, same
    weights, on 4 batches;
16. (everything freed) one family at a time, sync training at full width
    and full depth (``Trainer``, 4 AdamW steps, fp32 moments, seeded
    weights) on MarkovDataset batches of 4 sequences (``FamilyBatches``):
    minicpm3-4b on 512 tokens, phi-3-vision-4.2b on 256 seeded patch
    embeddings and 512 tokens, whisper-tiny on 448 tokens beside 1,500
    seeded encoder frames.  Every launch count is zeroed just before and
    read just after: exactly one bf16 flash forward, dq and dk/dv launch an
    attention layer a step (minicpm3 62 at (96, 64), phi-3 32 at (96, 96),
    whisper 12: 4 encoder, 4 self, 4 cross), nothing else.  Step time,
    tok/s, peak memory and one profiled step are printed; the losses must
    be finite and step 0's batch must score lower after training.  Then,
    the moments freed, one step's loss and gradients through the kernels
    and through the plain versions, same weights, same batch, held to
    ``FAMILY_TRAIN_LIMITS``;
17. (everything freed) the MoE family as phase 15 serves its families,
    one config at a time, at full width with the depth cut to whole
    repeats of the pattern that one card holds (``MOE_LAYERS``, printed as
    a ``reduced`` list beside the weights each cut takes):
    llama4-maverick-400b-a17b at 2 layers (a dense and an MoE block,
    128 experts, top-1, a dense residual; H=40, K=8) and arctic-480b at 2
    layers (two MoE blocks, 128 experts, top-2, a dense residual; H=56,
    K=8).  Exactly 2 flash and 64 decode launches a task, nothing else;
    one task timed alone and profiled; each config's prefill and 4 decode
    steps of logits through the kernels and through the plain versions on
    4 batches, with the share of (token, choice) routing decisions that
    differ between the two paths (a one-ulp bf16 difference in attention
    can flip a near-tied router choice);
18. (everything freed) the MoE family trained as phase 16 trains its
    families, one config at a time, at full width on phase 17's depth with
    the expert count cut from 128 to 32 (``MOE_TRAIN_EXPERTS``; the cuts
    printed as a ``reduced`` list with the training state each saves):
    ``Trainer``, 4 AdamW steps with the config's own moments (llama4 bf16,
    arctic int8) and its own ``remat=True`` (each pattern repeat
    checkpointed), seeded weights, batches of 4 x 512.  Exactly 4 bf16
    flash forwards (2 attention layers, each run again by the recompute),
    2 dq and 2 dk/dv launches a step, nothing else; losses finite, step
    0's batch scoring lower after training; step time, tok/s, peak memory
    (below 80 GB, beside the state's reckoning) and one profiled step.
    Then, the moments freed, one step's loss and gradients through the
    kernels and through the plain versions held to
    ``FAMILY_TRAIN_LIMITS``, with the (token, choice) routing decisions
    that differ between the two and a check that each recompute routed as
    its forward did; then the same step with remat off (one flash forward
    a layer), whose loss and gradients must equal remat's, bit for bit or
    within ``REMAT_GRAD_TOL``;
19. (everything freed) jamba-1.5-large-398b served as phase 17 serves the
    MoE family, at full width on one period of its pattern (8 of 72
    layers: attention at position 0, H=64, K=8, G=8; Mamba-1 at 1-7,
    d_inner 16384; MoE MLPs at the odd positions) with the experts cut
    from 16 to 8 (``JAMBA_EXPERTS``; both cuts printed as ``reduced``
    lists beside the weights they save): exactly 1 flash, 7 scan and 32
    decode launches a task, nothing else; one task timed alone and
    profiled; prefill and 4 decode steps of logits through the kernels
    and through the plain versions on 4 batches, held to jamba's
    ``FAMILY_LIMITS`` with the plain versions' top-k choices pinned to the
    kernels' (``RoutingPin``), the comparison with each path routing its
    own inputs printed beside it; the share of top-k choices the plain
    router makes otherwise held to ``ROUTING_LIMITS`` on both, and the
    differing decisions split into first flips and the drops that follow,
    by MoE layer.
    Then long context: ``long_context=True`` on one of those batches
    (inside the 2,048-token window) against the kernels, the same way; one
    request of 4,096 tokens through ``prefill(long_context=True)`` and 4
    decode steps, the counts zeroed just before and read just after (no
    flash or decode launch: the attention layer runs the plain windowed
    path; 7 scan launches), finite logits, the last logits away from those
    of the same plain attention without a window by more than ``BITES``
    times the largest kernels-vs-plain gap; and, the served model
    freed, each decode step within ``CONSISTENCY_TOL`` of a prefill of
    the longer prompt, in fp32 with 2 experts at a capacity that drops
    nothing (``JAMBA_FP32_EXPERTS``);
20. (everything freed) minicpm3-4b (MLA, (D, Dv) = (96, 64)) and
    phi-3-vision-4.2b ((96, 96)) in fp32 at full width, depth cut to
    ``TRAIN_LAYERS`` = 8 as phase 7 cuts qwen3, seeded weights, one family
    at a time: one training step's loss and gradients through the kernels
    and through the plain versions on a ``FamilyBatches`` batch (phi-3's
    256 seeded patches + 512 tokens), held to ``TRAIN_LIMITS[fp32]``;
    then a prefill and 4 decode steps of ``FP32_FAMILY_BATCHES`` batches,
    the same greedy token fed to both, logits held to ``CONSISTENCY_TOL``.
    The counts are zeroed just before each and read just after: one fp32
    flash forward, dq and dk/dv launch a layer in the step; one fp32 flash
    forward a layer a prefill and, for phi-3, one decode launch a layer a
    step; no bf16 kernel.  Peak memory is printed.

The line before the last is a JSON object with each kernel's numbers, one
row each: the bf16 flash forward (``flash_attention_fwd``), the fp32 one
(``flash_attention_fwd_fp32``), decode, the scan, phase 15's shapes of
the bf16 flash forward (``flash_attention_fwd_d96_dv64``,
``flash_attention_fwd_d96``) and of decode (``decode_attention_fwd_d96``),
dq and dk/dv in bf16 and in fp32 (``..._fp32``), and phase 16's shapes of
the bf16 pair (``flash_attention_bwd_{dq,dkv}_d96_dv64``, ``..._d96`` at
S = 768, ``..._whisper`` on the encoder), and phase 17's odd GQA groups of
the bf16 flash forward and decode (``flash_attention_fwd_g5``, ``..._g7``,
``decode_attention_fwd_g5``, ``..._g7``), and phase 18's of the bf16 pair
(``flash_attention_bwd_{dq,dkv}_{g5,g7}``), and phase 19's G = 8 of the
flash forward and decode (``flash_attention_fwd_g8``,
``decode_attention_fwd_g8``) and d_inner = 16384 of the scan
(``mamba_scan_d16384``), and phase 20's fp32 forward
(``flash_attention_fwd_fp32_d96_dv64``, ``..._fp32_d96`` at S = 768) and
pair (``flash_attention_bwd_{dq,dkv}_fp32_{d96_dv64,d96}``), their launches
those of phase 20's runs (the forward's: training step and serving
summed); the last
line is ``{"ok": true, "device": {...}}``.  Times are CUDA-event times on
this card without flushing the 50 MB L2 cache (the serve and training
paths find their inputs freshly written): for every kernel, its library
call (SDPA) and the plain attention versions, of CUDA-graph replays of
repeated calls (device time: a wrapper's host time exceeds the faster
kernels' own); for the plain scan, of back-to-back calls.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
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
# Training path (phases 6-8).  Phases 6 and 7 train qwen3 at full width
# cut to TRAIN_LAYERS layers (at the full 28, the checkpoint alone is
# 17.2 GB and takes ~60 s to save and restore), so that the script stays
# within the time its earlier versions took as it grows.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LAYERS = 4, 512, 4, 8
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
# gradients through 28 layers, the depth phase 7 ran then; see PERF.md).  fp32, from the first
# reading: |dloss| 0 and at most 5.3e-6, which shows the bf16 gap is
# rounding, not the kernels.
TRAIN_LIMITS = {torch.bfloat16: (1e-3, 3e-2), torch.float32: (1e-5, 1e-5)}
# Mamba path (phases 9-12): falcon-mamba-7b at full width and depth.
MAMBA_ARCH = "falcon_mamba_7b"
MAMBA_REQUESTS, MAMBA_NEW = 8, 32
MAMBA_TRAIN_LAYERS, MAMBA_TRAIN_BATCH = 8, 2
# Phase 15: the dense families beyond GQA at full width, one at a time.
# minicpm3-4b (MLA: flash at D=96, Dv=64 in prefill, an absorbed decode
# with no kernel) and phi-3-vision-4.2b (MHA at D=96, served text-only, as
# serve_requests builds tasks) serve FAMILY_REQUESTS prompts of PROMPT
# tokens, FAMILY_NEW new tokens; whisper-tiny serves as many prompts of
# WHISPER_PROMPT tokens, each task carrying seeded stub encoder frames
# (1,500 x 384), WHISPER_NEW new tokens.
FAMILIES = ("minicpm3_4b", "phi3_vision_4p2b", "whisper_tiny")
FAMILY_REQUESTS, FAMILY_NEW = 8, 32
WHISPER_PROMPT, WHISPER_NEW = 64, 64
PATCHES = 256  # phi-3's patch embeddings in its kernels-vs-plain prefill
FAMILY_BATCHES = 4
# Full-width logits of each family, kernels vs plain versions (phase 15):
# limits on the largest and the mean |difference| of each prefill's and
# decode step's logits, as phase 4's, from this script's first readings on
# an H100 over 4 batches (see PERF.md): minicpm3 (62 layers, prefill and
# one decode step) largest 8.30e-2 to 9.62e-2, mean 1.490e-2 to 1.529e-2;
# phi-3 (32 layers, prefill of 256 patches + 512 tokens and 4 decode
# steps) largest 8.52e-2 to 1.000e-1, mean 1.573e-2 to 1.693e-2; whisper
# (4 + 4 layers, prefill and one decode step) largest 1.022e-2 to
# 1.318e-2, mean 1.874e-3 to 2.147e-3.  Phase 17's MoE configs (2 layers,
# prefill and 4 decode steps): llama4 largest 3.04e-2 to 2.512e-1, mean
# 5.16e-3 to 1.522e-2; arctic largest 5.41e-2 to 7.84e-2, mean 8.47e-3 to
# 1.091e-2.  There a one-ulp bf16 flip in attention can flip a near-tied
# router choice (47 of 8,256 and 255 of 33,024 (token, choice) decisions
# differed), and llama4's largest gap, 2.512e-1, is a decode step where 1
# of its 4 decisions flipped.  The element checks of phase 2, not these
# limits, decide whether a kernel is right.
# Phase 19's jamba (8 layers: 1 attention, 7 Mamba, 4 MoE of 8 experts,
# top-2; prefill and 4 decode steps): limits set before its first run on
# the card from falcon-mamba's bf16 readings at 64 layers (largest 0.358,
# mean 0.055) and llama4's routing-flip spike (0.251), not fitted to a
# reading (see PERF.md).  The first run broke them with the routing free:
# 4.4-6.1% of a prefill's (token, choice) decisions differed between the
# paths and a decode step's largest gap read 1.265.  A flipped top-k
# choice changes that token's output by an expert's share; the Mamba
# layers carry it to every later token and MoE layer, where more choices
# flip.  The reference shows the same between its XLA and Pallas-interpret
# paths on the reduced jamba in bf16: 4.9-5.2% first flips, from 0.5-1.5%
# at the first MoE layer to 7-10% at the last, none in fp32
# (tests/test_torch_hybrid_routing.py).  So for the configs in PINNED the
# plain versions' top-k choices are pinned to the kernels' (RoutingPin;
# each path computes its own gates, and its own drops from the shared
# choices) and their logits are held to these limits there, while the
# share of (token, choice) pairs whose top-k choice the plain router makes
# otherwise is held to ROUTING_LIMITS over each batch's prefill and decode
# steps: "pinned", on the pinned path's inputs, where no flip compounds;
# "free", on the inputs of the plain path routing itself.  Both set before
# the run that first held them, "free" above the reference witness's 5.2%
# and the card's first 4.4-6.1% (which counted drops too); "pinned" three
# times the largest share llama4's or arctic's shallow stacks gave (1.03%),
# as jamba's pinned logits differ 3-4x more than theirs (largest 0.18-0.27
# against 0.04-0.07).
FAMILY_LIMITS = {"minicpm3_4b": (0.13, 0.019), "phi3_vision_4p2b": (0.14, 0.021),
                 "whisper_tiny": (0.018, 0.0027),
                 "llama4_maverick_400b_a17b": (0.34, 0.021), "arctic_480b": (0.11, 0.015),
                 "jamba_1p5_large_398b": (0.6, 0.06)}
PINNED = ("jamba_1p5_large_398b",)
ROUTING_LIMITS = {"free": 0.10, "pinned": 0.03}
# Phase 17: the MoE family at full width, served as phase 15 serves its
# families (FAMILY_REQUESTS prompts of PROMPT tokens, FAMILY_NEW new
# tokens), its depth cut to the whole pattern repeats one card holds:
# llama4-maverick one dense and one MoE block (128 experts of 3 x 5120 x
# 8192 bf16 weights, 32.2 GB a MoE layer), arctic two MoE blocks (26.8 GB
# each; a third would make 83.5 GB).  The reference's MoE is a dense
# one-hot dispatch: every expert is read on every call.
MOE_FAMILIES = ("llama4_maverick_400b_a17b", "arctic_480b")
MOE_LAYERS = {"llama4_maverick_400b_a17b": 2, "arctic_480b": 2}
# Phase 19: jamba-1.5-large-398b (hybrid) served as phase 17 serves the MoE
# family, at full width on one period of its pattern (8 of 72 layers:
# attention at position 0, Mamba at 1-7, MoE MLPs at the odd positions)
# with the expert count cut from 16 to JAMBA_EXPERTS: 25.91 B params,
# 51.8 GB in bf16 (16 experts: 45.24 B, 90.5 GB).  Every other field as
# published (top-2, capacity 1.25, routing groups of 256, the window).
JAMBA = "jamba_1p5_large_398b"
JAMBA_LAYERS, JAMBA_EXPERTS = 8, 8
# Long context on the card: one request of JAMBA_LONG_PROMPT tokens (twice
# the 2,048-token window) through prefill(long_context=True), then
# JAMBA_LONG_STEPS decode steps with long_context=True: the attention layer
# runs the plain windowed path (no kernel takes a window) and the Mamba
# layers the scan kernel.  Decode against a prefill of the longer prompt is
# held to the reference's serve-consistency limit
# (tests/test_serve_consistency.py, 2e-3) in fp32, where only summation
# order differs: the same period at full width with fp32 weights and
# activations and JAMBA_FP32_EXPERTS experts (45.6 GB; 8 would take 103.6),
# their capacity n_experts / top_k = 1.0 so that no routing group drops a
# token, as the reference test raises its capacity for (a group of 256 in a
# prefill may drop where a decode step's group of 1 never does).  The
# served bf16 model's decode-vs-prefill gap is printed beside it.
JAMBA_LONG_PROMPT, JAMBA_LONG_STEPS = 4096, 4
# The window bites when the long-context logits move away from the same
# attention without a window by more than BITES times the largest gap
# between the kernels and the plain versions held above (rounding).
BITES = 10
JAMBA_FP32_EXPERTS = 2
CONSISTENCY_TOL = 2e-3
# Phase 20: the D = 96 families in fp32, the fp32 flash kernels' path at
# (96, 64) (minicpm3's MLA) and (96, 96) (phi-3), at full width with the
# depth cut to TRAIN_LAYERS as phase 7 cuts qwen3.  One training step's loss
# and gradients, kernels vs plain versions, held to TRAIN_LIMITS[fp32]; a
# prefill and 4 decode steps of each of FP32_FAMILY_BATCHES batches held to
# CONSISTENCY_TOL (the reference's decode-logit tolerance) on the largest
# and the mean |logits difference|: in fp32 only summation order differs.
FP32_FAMILIES = ("minicpm3_4b", "phi3_vision_4p2b")
FP32_FAMILY_BATCHES = 2
# Phase 2's shapes: each path's attention calls as its serve run makes them.
# Flash: label -> (B, Sq, Skv, H, K, D, Dv, causal, dtypes), each also at a
# ragged Sq = 13 (and Skv = 13 where Skv = Sq).  Decode: label -> (B, H, K,
# D, cache slots, cache_index, dtypes), each also on a ragged 24-slot cache
# at cache_index 11, and on one request alone.
FLASH_SHAPES = {
    "qwen3": (PER_TASK, PROMPT, PROMPT, 16, 8, 128, 128, True,
              (torch.bfloat16, torch.float32)),
    # bf16: phases 15-16; fp32: phase 20
    "minicpm3 MLA": (PER_TASK, PROMPT, PROMPT, 40, 40, 96, 64, True,
                     (torch.bfloat16, torch.float32)),
    "phi-3": (PER_TASK, PROMPT, PROMPT, 32, 32, 96, 96, True,
              (torch.bfloat16, torch.float32)),
    "phi-3 with patches": (PER_TASK, PROMPT + PATCHES, PROMPT + PATCHES, 32, 32, 96, 96,
                           True, (torch.bfloat16, torch.float32)),
    "whisper encoder": (PER_TASK, 1500, 1500, 6, 6, 64, 64, False, (torch.bfloat16,)),
    "whisper cross": (PER_TASK, WHISPER_PROMPT, 1500, 6, 6, 64, 64, False,
                      (torch.bfloat16,)),
    "whisper self": (PER_TASK, WHISPER_PROMPT, WHISPER_PROMPT, 6, 6, 64, 64, True,
                     (torch.bfloat16,)),
    # the odd GQA groups of phase 17: one q-head a block (H/K odd)
    "llama4 G=5": (PER_TASK, PROMPT, PROMPT, 40, 8, 128, 128, True, (torch.bfloat16,)),
    "arctic G=7": (PER_TASK, PROMPT, PROMPT, 56, 8, 128, 128, True, (torch.bfloat16,)),
    # phase 19's jamba: G = 8, two q-heads a block
    "jamba G=8": (PER_TASK, PROMPT, PROMPT, 64, 8, 128, 128, True, (torch.bfloat16,)),
}
DECODE_SHAPES = {
    "qwen3": (PER_TASK, 16, 8, 128, PROMPT + NEW, PROMPT + 31,
              (torch.bfloat16, torch.float32)),
    "phi-3": (PER_TASK, 32, 32, 96, PROMPT + FAMILY_NEW, PROMPT + FAMILY_NEW - 1,
              (torch.bfloat16, torch.float32)),
    "whisper self": (PER_TASK, 6, 6, 64, WHISPER_PROMPT + WHISPER_NEW,
                     WHISPER_PROMPT + WHISPER_NEW - 1, (torch.bfloat16,)),
    # a kv-head's 5 or 7 q-heads in one block of 8, the rest masked
    "llama4 G=5": (PER_TASK, 40, 8, 128, PROMPT + FAMILY_NEW, PROMPT + FAMILY_NEW - 1,
                   (torch.bfloat16,)),
    "arctic G=7": (PER_TASK, 56, 8, 128, PROMPT + FAMILY_NEW, PROMPT + FAMILY_NEW - 1,
                   (torch.bfloat16,)),
    # jamba's 8 q-heads a kv-head fill the block of 8
    "jamba G=8": (PER_TASK, 64, 8, 128, PROMPT + FAMILY_NEW, PROMPT + FAMILY_NEW - 1,
                  (torch.bfloat16,)),
}
# the kernels line's phase-2 rows: (kind, label, dtypes), timed in the first
# dtype, the largest |error| over all of them
JSON_ROWS = {
    "flash": ("flash", "qwen3", (torch.bfloat16,)),
    "flash_fp32": ("flash", "qwen3", (torch.float32,)),
    "decode": ("decode", "qwen3", (torch.bfloat16, torch.float32)),
    "d96_dv64": ("flash", "minicpm3 MLA", (torch.bfloat16,)),
    "d96": ("flash", "phi-3", (torch.bfloat16,)),
    "decode_d96": ("decode", "phi-3", (torch.bfloat16, torch.float32)),
    "g5": ("flash", "llama4 G=5", (torch.bfloat16,)),
    "g7": ("flash", "arctic G=7", (torch.bfloat16,)),
    "decode_g5": ("decode", "llama4 G=5", (torch.bfloat16,)),
    "decode_g7": ("decode", "arctic G=7", (torch.bfloat16,)),
    "g8": ("flash", "jamba G=8", (torch.bfloat16,)),
    "decode_g8": ("decode", "jamba G=8", (torch.bfloat16,)),
    # phase 20's fp32 forward: minicpm3's prefill, phi-3's with patches
    "fp32_d96_dv64": ("flash", "minicpm3 MLA", (torch.float32,)),
    "fp32_d96": ("flash", "phi-3 with patches", (torch.float32,)),
}
# Phase 16: sync training of phase 15's families at full width, one at a
# time, FAMILY_TRAIN_BATCH sequences of TRAIN_SEQ tokens (phi-3: after
# PATCHES seeded patch embeddings; whisper: WHISPER_TRAIN_SEQ tokens, its
# published decoder context, beside 1,500 seeded encoder frames).
FAMILY_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 4, 448
# One training step of each family, kernels vs plain versions (phase 16):
# limits on |dloss| and on the largest per-group relative gradient
# difference, as TRAIN_LIMITS for qwen3, from this script's first readings
# on an H100 (see PERF.md): minicpm3 |dloss| 7.25e-5, largest 1.112e-2
# (attn.wq_a); phi-3 5.34e-5, 1.581e-2 (embed.table); whisper 9.5e-7 (an
# fp32 ulp of the loss), 3.081e-2 (decoder.cross_attn.wk, whose gradient
# is small).  One-ulp flips of bf16 activations and gradients, as phase
# 7's; the element checks of phase 5 decide whether a kernel is right.
# Phase 18's MoE configs (2 layers, 32 experts, remat), the same readings
# in two runs: llama4 |dloss| 1.140e-3, largest 1.103e-1 (moe.router; the
# expert stacks 8.1e-2), 6 of 2,048 (token, choice) routing decisions
# flipped; arctic 8.168e-4, 3.321e-2 (moe.experts.wg), 11 of 8,192.  A
# token routed to another expert moves that expert's gradient and the
# router's by far more than rounding, so these limits are looser than the
# dense families'.
FAMILY_TRAIN_LIMITS = {"minicpm3_4b": (2e-4, 2e-2), "phi3_vision_4p2b": (2e-4, 3e-2),
                       "whisper_tiny": (1e-5, 5e-2),
                       "llama4_maverick_400b_a17b": (3e-3, 0.25), "arctic_480b": (2e-3, 0.1)}
# Phase 18: the MoE family trained at full width on phase 17's depth with
# the expert count cut from 128 to MOE_TRAIN_EXPERTS: at 128 one MoE layer's
# weights, gradients and moments alone take 128.8 GB (llama4, bf16 moments)
# and 81.1 GB (arctic, int8 moments).  Every other MoE field is kept
# (top_k, capacity_factor, group_size 256, dense_residual), so a 512-token
# sequence is two routing groups with 10 (top-1) or 20 (top-2) slots an
# expert.  The configs' own remat=True and moment dtypes.  remat=False's
# gradients must equal remat=True's within REMAT_GRAD_TOL of each
# parameter's gradient norm, where they are not bit-identical.
MOE_TRAIN_EXPERTS = 32
REMAT_GRAD_TOL = 1e-6
# Phase 5's shapes: each training path's attention backward as its step
# makes it (phases 6, 16 and 18): label -> (B, Sq, Skv, H, K, D, Dv, causal,
# dtypes), each also at a ragged Sq = 13 (and Skv = 13 where Skv = Sq).
BWD_SHAPES = {
    "qwen3": (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 8, 128, 128, True,
              (torch.bfloat16, torch.float32)),
    # bf16: phase 16; fp32: phase 20
    "minicpm3 MLA": (FAMILY_TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 40, 40, 96, 64, True,
                     (torch.bfloat16, torch.float32)),
    "phi-3": (FAMILY_TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 32, 96, 96, True,
              (torch.bfloat16, torch.float32)),
    "phi-3 with patches": (FAMILY_TRAIN_BATCH, TRAIN_SEQ + PATCHES, TRAIN_SEQ + PATCHES, 32,
                           32, 96, 96, True, (torch.bfloat16, torch.float32)),
    "whisper encoder": (FAMILY_TRAIN_BATCH, 1500, 1500, 6, 6, 64, 64, False,
                        (torch.bfloat16,)),
    "whisper cross": (FAMILY_TRAIN_BATCH, WHISPER_TRAIN_SEQ, 1500, 6, 6, 64, 64, False,
                      (torch.bfloat16,)),
    "whisper self": (FAMILY_TRAIN_BATCH, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_SEQ, 6, 6, 64, 64,
                     True, (torch.bfloat16,)),
    # phase 18's odd GQA groups: one q-head a dq block; at the ragged Sq =
    # 13 an odd number of dk/dv steps (1 query tile x 5 or 7 q-heads)
    "llama4 G=5": (FAMILY_TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 40, 8, 128, 128, True,
                   (torch.bfloat16,)),
    "arctic G=7": (FAMILY_TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 56, 8, 128, 128, True,
                   (torch.bfloat16,)),
}
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


START = time.perf_counter()


def phase(title):
    """A phase's title line, with the seconds since the script started."""
    say(f"{title} [{time.perf_counter() - START:.1f} s into the run]")


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
        f"D={d} {name} {ring(d, code):,} B" for d in (32, 64, 96, 128)
        for name, code in (("f32", 0), ("bf16", 1))))
    tiles = kernel_entry(scan.KERNEL, "_smem", 1)
    say(f"  {scan.KERNEL.source.name} tile ring a block: " + ", ".join(
        f"n={n} {tiles(n):,} B" for n in (4, 8, 16, 32)))


def say_smem(kern):
    """The dynamic shared memory a block of ``kern`` takes at each pair of
    head dims it takes (its library's ``<symbol>_smem`` entry, (D, Dv)),
    beside the 227 KB a block may have."""
    fn = kernel_entry(kern, "_smem", 2)
    say(f"  {kern.source.name} shared memory a block: " + ", ".join(
        f"({d}, {dv}) {fn(d, dv):,} B" for d, dv in
        ((32, 32), (64, 64), (96, 96), (96, 64), (128, 128))) + " (at most 232,448 B)")


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


def sdpa_backward_ms(q, k, v, g, causal=True):
    """SDPA's backward alone on (B,S,heads,D) inputs: one forward with
    grad-enabled inputs under each backend that takes them, then
    ``autograd.grad`` graph-timed (the forward runs on the capture stream,
    where autograd puts its backward); (fastest ms, its backend's name), or
    (None, None)."""
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
                    o = sdpa(*leaves, is_causal=causal)
                    torch.autograd.grad(o, leaves, gT, retain_graph=True)
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
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
    fn.restype = ctypes.c_int
    B, Sq, H, D = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), B, Sq, k.shape[1], H,
            k.shape[2], D, v.shape[3])
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
    """Phase 2: each kernel against its plain version on the same inputs at
    every shape of FLASH_SHAPES and DECODE_SHAPES (serve and ragged), then
    each timed at its serve shape, graph-replayed, beside its bound and
    SDPA's fastest backend.  Returns {row of JSON_ROWS: its times, bound,
    library time and largest |error| ("err")}."""
    errs, timed = {}, {}
    for label, (B, sq, skv, H, K, D, Dv, causal, dtypes) in FLASH_SHAPES.items():
        for dt in dtypes:
            kern = flash.forward_kernel(dt)
            for size, q_len, kv_len in (("serve", sq, skv),
                                        ("ragged", 13, 13 if skv == sq else skv)):
                q = randn((B, q_len, H, D), dt, 1)
                k = randn((B, kv_len, K, D), dt, 2)
                v = randn((B, kv_len, K, Dv), dt, 3)
                before = kern.launches
                out, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
                if kern.launches != before + 1:
                    raise AssertionError(f"flash {label} {str(dt)[6:]} did not launch "
                                         f"{kern.name}")
                ref, ref_lse = flash.flash_attention_plain(q, k, v, causal=causal)
                tag = f"flash ({kern.name}) {label} {size} {str(dt)[6:]} Sq={q_len} Skv={kv_len}"
                key = ("flash", label, dt)
                errs[key] = max(errs.get(key, 0.0), check(tag + " out", out, ref, RTOL[dt]),
                                check(tag + " lse", lse, ref_lse, 0.0))
                if size == "serve":
                    timed[key] = (q, k, v, causal)
    for label, (B, H, K, D, slots, ci, dtypes) in DECODE_SHAPES.items():
        for dt in dtypes:
            for size, s_cache, c in (("serve", slots, ci), ("ragged", 24, 11)):
                qd = randn((B, 1, H, D), dt, 4)
                kc = randn((B, s_cache, K, D), dt, 5)
                vc = randn((B, s_cache, K, D), dt, 6)
                key = ("decode", label, dt)
                for b in (B, 1) if size == "serve" else (B,):
                    before = decode.KERNEL.launches
                    got = decode.decode_attention_fwd(qd[:b], kc[:b], vc[:b], cache_index=c)
                    if decode.KERNEL.launches != before + 1:
                        raise AssertionError(f"decode {label} did not launch its kernel")
                    ref = decode.decode_attention_plain(qd[:b], kc[:b], vc[:b], cache_index=c)
                    errs[key] = max(errs.get(key, 0.0), check(
                        f"decode {label} {size} {str(dt)[6:]} B={b} H={H} K={K} D={D} "
                        f"S={s_cache} cache_index={c}", got, ref, RTOL[dt]))
                if size == "serve" and dt == torch.bfloat16:
                    timed[key] = (qd, kc, vc, ci)
    torch.cuda.synchronize()

    rows = {}
    for (kind, label, dt), inputs in timed.items():
        if kind == "flash":
            rows[(kind, label, dt)] = flash_times(flash, label, *inputs)
        else:
            rows[(kind, label, dt)] = decode_times(decode, label, *inputs)
    q, k, v, _ = timed[("flash", "qwen3", torch.bfloat16)]
    say(f"  bf16 flash kernel's three TMA descriptors: {describe_us(flash, q, k, v):.2f} "
        "us of host time a call (qwen3's serve shape)")
    out = {}
    for row, (kind, label, dtypes) in JSON_ROWS.items():
        out[row] = dict(rows[(kind, label, dtypes[0])],
                        err=max(errs[(kind, label, dt)] for dt in dtypes))
    return out


def flash_times(flash, label, q, k, v, causal):
    """The flash forward at one serve shape: kernel, plain and SDPA times
    (graph-replayed), back-to-back calls of the wrapper, its host time a
    call, and its bound."""
    B, Sq, H, D = q.shape
    Skv, Dv = k.shape[1], v.shape[3]
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device="cuda")
    lse = torch.empty((B, H, Sq), device="cuda")
    pairs = causal_pairs(B, H, Sq, Skv) if causal else B * H * Sq * Skv
    call = lambda: flash.flash_attention_fwd(q, k, v, causal=causal)  # noqa: E731
    r = dict(ms=graph_ms(call),
             plain_ms=graph_ms(lambda: flash.flash_attention_plain(q, k, v, causal=causal)),
             call_ms=cuda_ms(call), host_us=host_us(call))
    r["library_ms"], r["library"] = sdpa_library_ms(q, k, v, is_causal=causal)
    # QK^T and PV, 2 D + 2 Dv flops a visible pair (the bf16 kernel splits P
    # in two bf16 terms and issues 2 D + 4 Dv; the fp32 one 3 x tf32)
    flops, moved = (2 * D + 2 * Dv) * pairs, nbytes(q, k, v, out, lse)
    r["bound_ms"], r["bound_by"] = bound(flops, moved, q.dtype)
    split = (f", {(2 * D + 4 * Dv) * pairs / 1e9:.2f} issued with P split"
             if q.dtype == torch.bfloat16 else "")
    say(f"  flash {label} {str(q.dtype)[6:]} (B={B}, Sq={Sq}, Skv={Skv}, H={H}, K={k.shape[2]}, "
        f"D={D}, Dv={Dv}, {'causal' if causal else 'non-causal'}; graph-timed): kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {fmt_ms(r['library_ms'])} "
        f"(SDPA {r['library']}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
        f"{moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP{split}); back-to-back calls of "
        f"the wrapper {r['call_ms']:.4f} ms, host {r['host_us']:.1f} us a call")
    return r


def decode_times(decode, label, qd, kc, vc, ci):
    """Decode at one serve shape, on the serve batch and on one request
    alone: kernel, plain and SDPA times (graph-replayed), back-to-back
    calls of the wrapper, the KV splits it launches and its bound.  Returns
    the serve batch's."""
    B, _, H, D = qd.shape
    K, n = kc.shape[2], ci + 1
    mask = (torch.arange(kc.shape[1], device="cuda") <= ci).view(1, 1, 1, -1)
    splits = kernel_entry(decode.KERNEL, "_splits", 4)
    first = None
    for b in (B, 1):
        q1, k1, v1 = qd[:b], kc[:b], vc[:b]
        call = lambda: decode.decode_attention_fwd(q1, k1, v1, cache_index=ci)  # noqa: E731
        r = dict(ms=graph_ms(call),
                 plain_ms=graph_ms(lambda: decode.decode_attention_plain(q1, k1, v1,
                                                                         cache_index=ci)),
                 call_ms=cuda_ms(call))
        r["library_ms"], r["library"] = sdpa_library_ms(q1, k1, v1, attn_mask=mask)
        moved = 2 * b * n * K * D * kc.element_size() + 2 * nbytes(q1)
        r["bound_ms"], r["bound_by"] = bound(4 * D * b * H * n, moved, qd.dtype)
        s = splits(b, H, K, ci)
        say(f"  decode {label} {str(qd.dtype)[6:]} (B={b}, H={H}, K={K}, D={D}, "
            f"{kc.shape[1]} slots, cache_index {ci}; graph-timed): {s} KV splits a "
            f"cluster, {s * b * K} blocks; kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {fmt_ms(r['library_ms'])} (SDPA "
            f"{r['library']}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
            f"{moved / 1e6:.2f} MB); back-to-back calls of the wrapper {r['call_ms']:.4f} ms")
        first = first or r
    return first


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


class RoutingTap:
    """Records the routing decisions of a model's MoE layers as it runs:
    for each (token, choice), the chosen expert and whether it found a
    slot.  A forward pre-hook routes each layer's input (``MoE.route``)
    with its own router, never pinned (``pin``): it sees remat's
    recompute too, which stops once the backward has what it needs,
    before a layer's forward returns.  ``calls`` returns what was
    recorded since its last call, one (choices, kept) a layer call;
    ``take`` the same as one decision a (token, choice), the expert or -1
    where the capacity dropped it; ``forward_and_recompute`` the
    decisions split into each layer's first run and its second (the
    recompute); ``close`` removes the hooks."""

    def __init__(self, model, pin=None):
        self.seen, self.pin = [], pin
        self.hooks = [blk.moe.register_forward_pre_hook(self._record)
                      for blk in model.blocks if blk.spec.mlp == "moe"]

    @torch.no_grad()
    def _record(self, layer, args):
        with contextlib.nullcontext() if self.pin is None else self.pin(None):
            _, _, onehot, keep, _, _ = layer.route(args[0])
        self.seen.append((layer, onehot.argmax(-1).flatten(), keep.sum(-1).flatten() > 0))

    @staticmethod
    def decisions(calls) -> torch.Tensor:
        return torch.cat([torch.where(kept, choice, -1) for choice, kept in calls])

    def calls(self):
        seen, self.seen = [(c, k) for _, c, k in self.seen], []
        return seen

    def take(self) -> torch.Tensor:
        return self.decisions(self.calls())

    def forward_and_recompute(self):
        """(each layer's first decisions, its second or None when no layer
        ran twice), layers in the order of their first run."""
        runs: dict = {}
        for layer, c, k in self.seen:
            runs.setdefault(layer, []).append((c, k))
        self.seen = []
        first = self.decisions([r[0] for r in runs.values()])
        if all(len(r) == 1 for r in runs.values()):
            return first, None
        return first, self.decisions([r[1] for r in runs.values()])

    def close(self):
        for hook in self.hooks:
            hook.remove()


def routing_split(a, b):
    """Two runs' routing (RoutingTap.calls), one MoE layer call each:
    [(first flips: (token, choice) pairs whose top-k choice differs,
    drops: pairs with the same choice that one run kept and the other
    dropped, pairs)]."""
    out = []
    for (ca, ka), (cb, kb) in zip(a, b, strict=True):
        flip = ca != cb
        out.append((flip.sum().item(), (~flip & (ka != kb)).sum().item(), ca.numel()))
    return out


class RoutingPin:
    """Pins the top-k choices of a model's MoE layers to another run's.
    ``repro_torch.models.moe.top_k`` is replaced while the pin lives:
    called with "record", each routing keeps its choices in call order;
    with "replay", each routing takes the recorded choices of the same
    order in place of its own top k, and gathers its gates from its own
    router's probabilities at them.  So each path computes its own gates
    and, from the shared choices, its own capacity drops.  Phase 19 holds
    the plain versions to the kernels' logits with the choices pinned, so
    that the two differ by the arithmetic, not by a near-tied choice one
    ulp flipped and what it moves downstream; the first flips each router
    makes on its own are counted and held beside it (ROUTING_LIMITS)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.top_k = moe, moe.top_k
        self.kept, self.mode = [], None
        moe.top_k = self._top_k

    def _top_k(self, probs, k):
        if self.mode == "replay":
            idx = self.kept.pop(0)
            if idx.shape != probs.shape[:-1] + (k,):
                raise AssertionError("a pinned routing replayed at another shape")
            return probs.gather(-1, idx), idx
        gate, idx = self.top_k(probs, k)
        if self.mode == "record":
            self.kept.append(idx)
        return gate, idx

    @contextlib.contextmanager
    def __call__(self, mode):
        before, self.mode = self.mode, mode
        try:
            yield
        finally:
            self.mode = before

    def close(self):
        self.moe.top_k = self.top_k


def say_routing(label, split, limit=None, by_layer=False):
    """One line of routing_split's sums (and with ``by_layer`` each layer
    call's share of first flips): the shares of first flips and of the
    drops that follow; with ``limit``, the first flips' share is held to
    it."""
    flips, drops, n = (sum(col) for col in zip(*split))
    layers = ("; first flips by layer " + ", ".join(f"{f / m:.4f}" for f, _, m in split)
              if by_layer else "")
    say(f"    {label}: top-k choices differ on {flips} of {n} (token, choice) pairs "
        f"({flips / n:.4f}{'' if limit is None else f', limit {limit:g}'}), the same "
        f"choice kept in one and dropped in the other on {drops} ({drops / n:.4f}){layers}")
    if limit is not None and not flips / n <= limit:
        raise AssertionError(f"{label}: {flips / n:.4f} of the routers' choices flipped")


def kernels_vs_plain(api, params, plain_ops, batches, budget, steps, limits, tap=None,
                     other=None, pin=None):
    """The full-width logits check of phases 4, 11, 15, 17 and 19: for each
    (batch, first decode position) of ``batches``, a prefill and ``steps``
    decode steps through the kernels and through ``plain_ops``, the same
    greedy token fed to both; the largest and mean |logits difference| of
    each held to ``limits``.  With a RoutingTap, the routing decisions
    that differ between the two paths are printed beside each, split into
    first flips and the drops that follow.  ``other``: the second path's
    keywords in place of ``ops=plain_ops`` (phase 19:
    ``long_context=True``).  With a RoutingPin, the second path runs
    twice: routing its own inputs (logits printed, not held; its first
    flips over the batch held to ROUTING_LIMITS["free"]) and with its
    top-k choices pinned to the kernels' (logits held; the choices its
    own router would have made there held to ROUTING_LIMITS["pinned"]).
    Returns the largest held |logits difference|."""
    max_lim, mean_lim = limits
    other = {"ops": plain_ops} if other is None else other
    worst = 0.0

    def calls():
        return [] if tap is None else tap.calls()

    def pinned(mode):
        return contextlib.nullcontext() if pin is None else pin(mode)

    def report(i, pairs, held):
        nonlocal worst
        for name, a, b, r_a, r_b in pairs:
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError(f"batch {i} {name}: non-finite logits")
            diff = (a - b).abs()
            err, mean = diff.max().item(), diff.mean().item()
            agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
            tag = ("" if pin is None else
                   " (top-k choices pinned to the kernels')" if held else
                   " (own routing; not held)")
            say(f"  batch {i} {name} logits{tag}: max |diff| {err:.3e} (limit {max_lim:g}), "
                f"mean |diff| {mean:.3e} (limit {mean_lim:g}), max |logit| "
                f"{b.abs().max().item():.3f}, greedy tokens agree on {agree:.2f} of rows")
            if r_a and (pin is None or name == "prefill"):
                say_routing("routing vs the kernels'", routing_split(r_a, r_b),
                            by_layer=name == "prefill")
            if held:
                worst = max(worst, err)
                if not (err <= max_lim and mean <= mean_lim):
                    raise AssertionError(f"batch {i} {name}: full-width logits through the "
                                         "kernels disagree")

    for i, (batch, start) in enumerate(batches):
        with pinned("record"):
            lg_k, c_k = api.prefill(params, batch, seq_budget=budget)
        r_k = calls()
        lg_p, c_p = api.prefill(params, batch, seq_budget=budget, **other)
        pairs = [("prefill", lg_k, lg_p, r_k, calls())]
        if pin is not None:
            with pin("replay"):
                lg_q, c_q = api.prefill(params, batch, seq_budget=budget, **other)
            held = [("prefill", lg_k, lg_q, r_k, calls())]
        for j in range(steps):
            step = {"tokens": torch.argmax(lg_k, -1).to(torch.int32)[:, None],
                    "cache_index": start + j}
            with pinned("record"):
                lg_k, c_k = api.decode(params, step, c_k)
            r_k = calls()
            lg_p, c_p = api.decode(params, step, c_p, **other)
            pairs.append((f"decode at {start + j}", lg_k, lg_p, r_k, calls()))
            if pin is not None:
                with pin("replay"):
                    lg_q, c_q = api.decode(params, step, c_q, **other)
                held.append((f"decode at {start + j}", lg_k, lg_q, r_k, calls()))
        report(i, pairs, pin is None)
        if pin is not None:
            report(i, held, True)
            if pin.kept:
                raise AssertionError("a recorded routing was not replayed")
            for label, runs, limit in (("free", pairs, ROUTING_LIMITS["free"]),
                                       ("pinned", held, ROUTING_LIMITS["pinned"])):
                say_routing(f"batch {i}, prefill and {steps} decode steps, {label}",
                            [s for *_, r_a, r_b in runs for s in routing_split(r_a, r_b)],
                            limit)
            del c_q
        del c_k, c_p
    return worst


def full_width_phase(api, params, cfg, dev, plain_ops, batches=FULL_WIDTH_BATCHES,
                     limits=(FULL_WIDTH_MAX_ERR, FULL_WIDTH_MEAN_ERR)):
    """Phases 4 and 11: one prefill and one decode step of each of
    ``batches`` prompt batches, through the kernels (the serving dispatch)
    and through the plain versions; |logits difference| held to
    ``limits`` (largest, mean)."""
    prompts = [{"tokens": torch.as_tensor(np.random.default_rng(SEED + 1 + i).integers(
        0, cfg.vocab_size, (PER_TASK, PROMPT))).to(dev)} for i in range(batches)]
    kernels_vs_plain(api, params, plain_ops, [(b, PROMPT) for b in prompts],
                     PROMPT + NEW, 1, limits)


def backward_phase(flash):
    """Phase 5: the backward kernels vs the plain backward at every shape
    of BWD_SHAPES (training and ragged), each dtype's Hopper pair, a second
    launch bit-identical; then each timed at its training shape.  Returns
    {(label, dtype): {"dq": row, "dkv": row}}, each row with its times,
    bound, library time and largest |error| ("err")."""
    errs, timed = {}, {}
    for label, (B, sq, skv, H, K, D, Dv, causal, dtypes) in BWD_SHAPES.items():
        for dt in dtypes:
            pair = flash.backward_kernels(dt)
            key = (label, dt)
            errs[key] = {"dq": 0.0, "dkv": 0.0}
            for size, q_len, kv_len in (("train", sq, skv),
                                        ("ragged", 13, 13 if skv == sq else skv)):
                q = randn((B, q_len, H, D), dt, 21)
                k = randn((B, kv_len, K, D), dt, 22)
                v = randn((B, kv_len, K, Dv), dt, 23)
                g = randn((B, q_len, H, Dv), dt, 24)
                out, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
                before = [kern.launches for kern in pair]
                got = flash.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
                if [kern.launches for kern in pair] != [n + 1 for n in before]:
                    raise AssertionError(f"{label} {str(dt)[6:]} backward did not launch "
                                         f"{pair[0].name} and {pair[1].name}")
                ref = flash.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
                tag = (f"{label} {size} {str(dt)[6:]} Sq={q_len} Skv={kv_len} "
                       f"({pair[0].name}, {pair[1].name})")
                for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                    part = "dq" if name == "dq" else "dkv"
                    errs[key][part] = max(errs[key][part], check(
                        f"{name} {tag}", a, b, RTOL[dt], BWD_ATOL))
                again = flash.flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                say(f"  dq, dk, dv {tag}: two launches bit-identical: {same}")
                if not same:
                    raise AssertionError(f"{tag}: the backward is not deterministic")
                if size == "train":
                    timed[key] = (q, k, v, out, lse, g, causal)
    torch.cuda.synchronize()
    rows = {}
    for (label, dt), inputs in timed.items():
        rows[(label, dt)] = backward_times(flash, label, *inputs)
        for part in ("dq", "dkv"):
            rows[(label, dt)][part]["err"] = errs[(label, dt)][part]
    return rows


def backward_times(flash, label, q, k, v, out, lse, g, causal):
    """The backward pair at one training shape, graph-replayed: dq, dk/dv,
    both in one call, the plain backward and SDPA's whole backward, beside
    each kernel's bound.  Returns {"dq": row, "dkv": row}."""
    B, Sq, H, D = q.shape
    Skv, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    dt = q.dtype
    pairs = causal_pairs(B, H, Sq, Skv) if causal else B * H * Sq * Skv
    dq, dvec = flash.bwd_dq_launch(q, k, v, out, lse, g, causal=causal)
    dk, dv = flash.bwd_dkv_launch(q, k, v, g, lse, dvec, causal=causal)
    plain_ms = graph_ms(lambda: flash.flash_attention_bwd_plain(
        q, k, v, out, lse, g, causal=causal))
    both_ms = graph_ms(lambda: flash.flash_attention_bwd(q, k, v, out, lse, g, causal=causal))
    library_ms, library = sdpa_backward_ms(q, k, v, g, causal)
    lib = dict(plain_ms=plain_ms, library_ms=library_ms, library=library)
    rows = {"dq": dict(ms=graph_ms(lambda: flash.bwd_dq_launch(
                q, k, v, out, lse, g, causal=causal)), **lib),
            "dkv": dict(ms=graph_ms(lambda: flash.bwd_dkv_launch(
                q, k, v, g, lse, dvec, causal=causal)), **lib)}
    # the function's products a visible pair: dq S, dP and dS K (4 D + 2 Dv),
    # dk/dv S, dP, P^T dO and dS^T Q (4 D + 4 Dv)
    rows["dq"]["bound_ms"], rows["dq"]["bound_by"] = bound(
        (4 * D + 2 * Dv) * pairs, nbytes(q, k, v, out, g, lse, dq, dvec), dt)
    rows["dkv"]["bound_ms"], rows["dkv"]["bound_by"] = bound(
        (4 * D + 4 * Dv) * pairs, nbytes(q, k, v, g, lse, dvec, dk, dv), dt)
    shape = (f"B={B}, Sq={Sq}, Skv={Skv}, H={H}, K={K}, D={D}, Dv={Dv}, "
             f"{'causal' if causal else 'non-causal'}")
    for name, r in rows.items():
        say(f"  {name} {label} {str(dt)[6:]} ({shape}; graph-timed): kernel {r['ms']:.4f} ms, "
            f"plain backward (dq, dk, dv) {r['plain_ms']:.4f} ms, library backward (SDPA "
            f"{r['library']}, dq, dk, dv together) {fmt_ms(r['library_ms'])}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    ratio = "" if library_ms is None else f" ({both_ms / library_ms:.2f}x)"
    say(f"  {label} {str(dt)[6:]} backward, dq + dk/dv in one call (graph-timed) "
        f"{both_ms:.4f} ms (the two kernels timed alone: "
        f"{rows['dq']['ms'] + rows['dkv']['ms']:.4f} ms) beside SDPA's whole backward (SDPA "
        f"{library}) {fmt_ms(library_ms)}{ratio}")
    return rows


def group_of(name: str) -> str:
    """Parameter group: the name without its layer index (whisper's
    encoder and decoder layers keep their stack's name)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return ".".join(parts[2:])
    if parts[0] in ("encoder", "decoder"):
        return ".".join(parts[:1] + parts[2:])
    return name


def sync_training_phase(api, params, dev, kernels):
    """Phase 6: full-width sync training (depth cut to TRAIN_LAYERS);
    returns (launches, state)."""
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


def markov_batch(cfg, dev, seed=SEED + 7):
    """Phase 7's batch: TRAIN_BATCH x TRAIN_SEQ MarkovDataset tokens."""
    from repro_torch.data import MarkovDataset

    ds = MarkovDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
    return {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(0).items()}


def train_step_agreement(api, model, batch, plain_ops, limits, tap=None):
    """One training step's loss and gradients on ``batch``, kernels vs
    plain versions: |dloss| and the largest per-group relative gradient
    difference held to ``limits``.  With a RoutingTap, the routing
    decisions that differ between the two are printed, and each path's
    recompute (remat) must route as its forward did.  Returns the kernels'
    (loss, grads)."""
    from repro_torch.runtime.train_loop import loss_and_grads

    loss_lim, grad_lim = limits
    loss_k, _, g_k = loss_and_grads(api, model, batch)
    routes = [tap.forward_and_recompute()] if tap is not None else []
    loss_p, _, g_p = loss_and_grads(api, model, batch, ops=plain_ops)
    if tap is not None:
        routes.append(tap.forward_and_recompute())
        for name, (fwd, again) in zip(("kernels", "plain versions"), routes):
            if again is None:
                continue
            same = torch.equal(fwd, again)
            say(f"  routing through the {name}: the recompute's {again.numel()} (token, "
                f"choice) decisions equal the forward's: {same}")
            if not same:
                raise AssertionError(f"{name}: remat's recompute routed otherwise")
        (fwd_k, _), (fwd_p, _) = routes
        flips = (fwd_k != fwd_p).sum().item()
        say(f"  routing decisions differ between the kernels and the plain versions on "
            f"{flips} of {fwd_k.numel()} (token, choice) pairs ({flips / fwd_k.numel():.4f})")
    dloss = abs(loss_k.item() - loss_p.item())
    say(f"  {api.cfg.compute_dtype}: loss through the kernels "
        f"{loss_k.item():.6f}, through the plain versions {loss_p.item():.6f}: "
        f"|dloss| {dloss:.3e} (limit {loss_lim:g})")
    worst = compare_grads(g_k, g_p, "g_kernels - g_plain", "g_plain")
    say(f"  largest relative gradient difference {worst:.3e} (limit "
        f"{grad_lim:g})")
    if not (dloss <= loss_lim and worst <= grad_lim):
        raise AssertionError("training step through the kernels disagrees "
                             "with the plain versions")
    return loss_k, g_k


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


def family_phase(arch, dev, lookup, kernels, layers=None, experts=None, then=None):
    """Phase 15 (and 17, 19) for one family: serve it at full width, at
    full depth or cut to ``layers`` layers (and ``experts`` experts),
    through ``BasicClient`` on the services in ``lookup`` with every launch
    count zeroed just before and read just after (exact counts a task: one
    flash launch a prefill attention, one decode launch a self-attention
    layer and new token but none for MLA, one scan launch a Mamba layer,
    nothing else), then its logits through the kernels against the plain
    versions (with an MoE's routing flips), then ``then(api, params,
    batches, tap, pin, largest held |logits difference|)``.
    minicpm3's and the MoE families' task is timed alone and profiled.
    Returns the launch counts."""
    import repro_torch.configs as cfgs
    from repro_torch.core import BasicClient
    from repro_torch.kernels import decode_attention as decode
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import build
    from repro_torch.runtime.serve_loop import (ServeConfig, make_generate_program,
                                                serve_requests)

    from repro_torch.kernels import mamba_scan as scan

    full = cfgs.get(arch)
    cfg = full if layers is None else full.replace(n_layers=layers)
    if experts is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=experts))
    api = build(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    encdec = cfg.is_encoder_decoder
    depth = (f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers" if encdec
             else f"{cfg.n_layers} layers")
    say(f"  {cfg.name}: {depth}, d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} kv-heads, {sum(p.numel() for p in params.parameters()) / 1e9:.3f} "
        f"B params in {cfg.param_dtype}, initialised in {time.perf_counter() - t0:.2f} s")
    if layers is not None:
        say_depth_cut(full, cfg, params)
    if cfg.moe is not None and cfg.moe.n_experts != full.moe.n_experts:
        say_expert_cut(full, cfg, params)
    prompt, new = (WHISPER_PROMPT, WHISPER_NEW) if encdec else (PROMPT, FAMILY_NEW)
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (FAMILY_REQUESTS, prompt)))
    sc = ServeConfig(max_new_tokens=new, prompt_len=prompt, batch_per_task=PER_TASK)
    if encdec:  # tasks carry the frontend stub's frames beside the prompt
        frames = torch.randn((FAMILY_REQUESTS, cfg.encoder_seq_len, cfg.d_model),
                             generator=torch.Generator().manual_seed(SEED))
        tasks = [{"tokens": prompts[i:i + PER_TASK], "enc_frames": frames[i:i + PER_TASK]}
                 for i in range(0, FAMILY_REQUESTS, PER_TASK)]

        def serve(sc, tasks):
            out: list = []
            client = BasicClient(make_generate_program(api, sc, params), None, tasks, out,
                                 lookup=lookup)
            client.compute(timeout=600)
            return torch.cat([o["generated"].cpu() for o in out]), client.stats()
    else:
        tasks = prompts

        def serve(sc, tasks):
            return serve_requests(api, params, tasks, sc, lookup=lookup, timeout=600)
    # warm-up (cuBLAS handles, allocator), not counted
    serve(ServeConfig(max_new_tokens=2, prompt_len=prompt, batch_per_task=PER_TASK),
          tasks[:1] if encdec else tasks[:PER_TASK])
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    gen, stats = serve(sc, tasks)
    wall = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    n_tasks = FAMILY_REQUESTS // PER_TASK
    say(f"  served {tuple(gen.shape)} tokens in {wall:.3f} s: {gen.numel() / wall:.1f} tok/s "
        f"across {SERVICES} services; {stats['done']} tasks, {stats['reschedules']} "
        f"reschedules; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    say(f"  launches on the main path: {launches}")
    if tuple(gen.shape) != (FAMILY_REQUESTS, new):
        raise AssertionError(f"generated shape {tuple(gen.shape)}")
    if not (int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size):
        raise AssertionError("generated token ids out of range")
    want = {kern.name: 0 for kern in kernels.KERNELS}
    mixers = [cfg.pattern[i % len(cfg.pattern)].mixer for i in range(cfg.n_layers)]
    self_attn = mixers.count("attn")
    # whisper: the encoder's, the decoder's self- and cross-attention prefills
    prefills = cfg.n_encoder_layers + 2 * cfg.n_layers if encdec else self_attn
    want[flash.SM90_KERNEL.name] = n_tasks * prefills
    want[decode.KERNEL.name] = 0 if cfg.attention == "mla" else n_tasks * self_attn * new
    want[scan.KERNEL.name] = n_tasks * mixers.count("mamba")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if arch == "minicpm3_4b" or cfg.moe is not None:
        time_one_task(api, params, prompts[:PER_TASK].to(dev), new)

    say(f"  {cfg.name}: kernels vs plain versions at full width")
    batches = []
    for i in range(FAMILY_BATCHES):
        g = np.random.default_rng(SEED + 1 + i)
        batch = {"tokens": torch.as_tensor(g.integers(0, cfg.vocab_size,
                                                      (PER_TASK, prompt))).to(dev)}
        if encdec:
            batch["enc_frames"] = randn((PER_TASK, cfg.encoder_seq_len, cfg.d_model),
                                        torch.float32, SEED + 60 + i)
        if cfg.frontend == "vision":
            batch["patch_embeds"] = randn((PER_TASK, PATCHES, cfg.d_model), torch.float32,
                                          SEED + 70 + i)
        batches.append((batch, prompt + (PATCHES if cfg.frontend == "vision" else 0)))
    steps = 4 if cfg.frontend == "vision" or cfg.moe is not None else 1
    pin = RoutingPin() if arch in PINNED else None
    tap = RoutingTap(params, pin) if cfg.moe is not None else None
    gap = kernels_vs_plain(api, params, kernels.PLAIN, batches, batches[0][1] + new, steps,
                           FAMILY_LIMITS[arch], tap, pin=pin)
    if then is not None:
        then(api, params, batches, tap, pin, gap)
    for hooks in (tap, pin):
        if hooks is not None:
            hooks.close()
    return launches


def say_depth_cut(full, cfg, params):
    """Phase 17's cut, as a ``reduced`` list: the layers kept at full
    width, the weights they take, what the full depth and one more pattern
    repeat would take beside the embeddings and the fp32 unembedding copy,
    and the card's memory."""
    def gb(named):
        return sum(p.numel() * p.element_size() for _, p in named) / 1e9

    blocks = gb(params.blocks.named_parameters())
    rest = gb((n, p) for n, p in params.named_parameters() if not n.startswith("blocks."))
    f32 = params.head().table_f32().numel() * 4 / 1e9
    per_repeat = blocks / cfg.n_repeats
    card = torch.cuda.get_device_properties(0).total_memory / 1e9
    say("  reduced: " + json.dumps([
        f"n_layers {full.n_layers} -> {cfg.n_layers}: {cfg.n_repeats} of {full.n_repeats} "
        f"repeats of the pattern ({', '.join(s.mlp for s in cfg.pattern)} MLPs), widths "
        "as published"]))
    say(f"  weights: blocks {blocks:.2f} GB ({per_repeat:.2f} GB a repeat), embeddings "
        f"{rest:.2f} GB, fp32 unembedding copy {f32:.2f} GB: {blocks + rest + f32:.2f} GB; "
        f"one more repeat {blocks + per_repeat + rest + f32:.2f} GB, full depth "
        f"{per_repeat * full.n_repeats + rest + f32:.1f} GB; the card has {card:.1f} GB")


def say_expert_cut(full, cfg, params):
    """Phase 19's expert cut, as a ``reduced`` list beside what it saves:
    the expert stacks at the published count (their bytes scale with it)."""
    kept = sum(p.numel() * p.element_size() for n, p in params.named_parameters()
               if ".moe.experts." in n) / 1e9
    total = sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9
    f32 = params.head().table_f32().numel() * 4 / 1e9
    grown = kept * full.moe.n_experts / cfg.moe.n_experts
    say("  reduced: " + json.dumps([
        f"moe.n_experts {full.moe.n_experts} -> {cfg.moe.n_experts} in each of the "
        f"{sum(s.mlp == 'moe' for s in cfg.pattern) * cfg.n_repeats} MoE layers; top_k "
        f"{cfg.moe.top_k}, capacity {cfg.moe.capacity_factor}, groups of "
        f"{cfg.moe.group_size} as published"]))
    say(f"  experts: {kept:.2f} GB kept of {grown:.2f} GB; weights {total:.2f} GB and the "
        f"fp32 unembedding copy {f32:.2f} GB: {total + f32:.2f} GB, "
        f"{total - kept + grown + f32:.2f} GB with every expert (saves {grown - kept:.2f} GB)")


def long_context_tokens(cfg, dev):
    """Phase 19's long-context request: one prompt of JAMBA_LONG_PROMPT
    tokens and the JAMBA_LONG_STEPS tokens fed after it, from the seed."""
    return torch.as_tensor(np.random.default_rng(SEED + 90).integers(
        0, cfg.vocab_size, (1, JAMBA_LONG_PROMPT + JAMBA_LONG_STEPS))).to(dev)


def decode_vs_prefill(api, params, tokens):
    """The serve-consistency comparison at long context: prefill the first
    JAMBA_LONG_PROMPT tokens and decode the rest one at a time, each
    step's logits beside those of a prefill of the prompt that ends at
    the fed token, all with ``long_context=True``.  Returns [(decode
    logits, prefill logits)]."""
    S, n = JAMBA_LONG_PROMPT, JAMBA_LONG_STEPS
    _, caches = api.prefill(params, {"tokens": tokens[:, :S]}, seq_budget=S + n,
                            long_context=True)
    pairs = []
    for i in range(n):
        lg, caches = api.decode(params, {"tokens": tokens[:, S + i:S + i + 1],
                                         "cache_index": S + i}, caches, long_context=True)
        ref, _ = api.prefill(params, {"tokens": tokens[:, :S + i + 1]}, long_context=True)
        pairs.append((lg, ref))
    return pairs


def long_context_phase(api, params, batches, tap, pin, gap):
    """Phase 19's long context on the served model.  Within the window
    (PROMPT-token prompts), ``long_context=True`` (the plain windowed path)
    against the kernels' ``long_context=False`` logits, held to jamba's
    FAMILY_LIMITS.  Past it, one request of JAMBA_LONG_PROMPT tokens
    through ``prefill(long_context=True)`` and JAMBA_LONG_STEPS decode
    steps, the launch counts zeroed just before and read just after: no
    flash or decode launch, one scan launch a Mamba layer, finite logits.
    The window bites: the prompt's last logits differ from those of the
    same plain attention without a window (which computes the positions
    inside the window bit for bit alike) by more than BITES times ``gap``,
    the largest kernels-vs-plain gap held before; the kernels'
    ``long_context=False`` gap is printed beside it, and the served
    model's decode-vs-prefill gap."""
    from repro_torch import kernels
    from repro_torch.kernels import AttentionOps
    from repro_torch.kernels import mamba_scan as scan
    from repro_torch.models.attention import chunked_attention

    cfg = api.cfg
    W, S, n = cfg.long_context_window, JAMBA_LONG_PROMPT, JAMBA_LONG_STEPS
    say(f"  long_context=True within the window ({batches[0][1]}-token prompts, window {W}) "
        "against the kernels' long_context=False")
    gap = max(gap, kernels_vs_plain(api, params, None, batches[:1],
                                    batches[0][1] + FAMILY_NEW, 4, FAMILY_LIMITS[JAMBA],
                                    tap, other={"long_context": True}, pin=pin))
    tokens = long_context_tokens(cfg, params.device)
    for kern in kernels.KERNELS:
        kern.launches = 0
    lg, caches = api.prefill(params, {"tokens": tokens[:, :S]}, seq_budget=S + n,
                             long_context=True)
    steps = []
    for i in range(n):
        out, caches = api.decode(params, {"tokens": tokens[:, S + i:S + i + 1],
                                          "cache_index": S + i}, caches, long_context=True)
        steps.append(out)
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    want = {kern.name: 0 for kern in kernels.KERNELS}
    want[scan.KERNEL.name] = sum(s.mixer == "mamba" for s in cfg.pattern) * cfg.n_repeats
    say(f"  long context (B=1, prompt {S}, window {W}, {n} decode steps): launches {launches}")
    if launches != want:
        raise AssertionError(f"long-context launches {launches}, expected {want}")
    if not all(torch.isfinite(t).all() for t in [lg] + steps):
        raise AssertionError("non-finite long-context logits")
    del caches
    # the same plain attention without a window: bit-identical inside it
    unwindowed = AttentionOps(
        lambda q, k, v, *, causal=True, window=None: chunked_attention(q, k, v, causal=causal),
        kernels.DISPATCH.decode, None, kernels.DISPATCH.scan)
    for kern in kernels.KERNELS:
        kern.launches = 0
    lg_plain, _ = api.prefill(params, {"tokens": tokens[:, :S]}, ops=unwindowed)
    lg_kern, _ = api.prefill(params, {"tokens": tokens[:, :S]})
    bites = (lg - lg_plain).abs()
    say(f"  the window bites: last logits vs the same attention unwindowed max |diff| "
        f"{bites.max().item():.3e}, mean {bites.mean().item():.3e}; vs the kernels' "
        f"long_context=False max {(lg - lg_kern).abs().max().item():.3e}, mean "
        f"{(lg - lg_kern).abs().mean().item():.3e}; max |logit| {lg.abs().max().item():.3f}")
    say(f"  the window's largest gap is {bites.max().item() / gap:.1f} times the largest "
        f"kernels-vs-plain gap {gap:.3e} (limit: more than {BITES})")
    if not bites.max().item() > BITES * gap:
        raise AssertionError("long_context=True is within rounding of the unwindowed "
                             "logits: the window does not bite")
    gaps = [(a - b).abs().max().item() for a, b in decode_vs_prefill(api, params, tokens)]
    say(f"  served bf16 model, decode vs prefill of the longer prompt at long context: max "
        f"|diff| {', '.join(f'{g:.3e}' for g in gaps)} (bf16, capacity "
        f"{cfg.moe.capacity_factor}: not held; the fp32 check below is)")


def long_context_fp32_phase(dev):
    """Phase 19's serve-consistency check at long context, in fp32 (see
    JAMBA_FP32_EXPERTS): each decode step's logits within CONSISTENCY_TOL
    (absolute and relative) of a prefill of the longer prompt."""
    import repro_torch.configs as cfgs
    from repro_torch.models import build

    full = cfgs.get(JAMBA)
    cfg = full.replace(n_layers=JAMBA_LAYERS, param_dtype="float32", compute_dtype="float32",
                       moe=dataclasses.replace(full.moe, n_experts=JAMBA_FP32_EXPERTS,
                                               capacity_factor=JAMBA_FP32_EXPERTS
                                               / full.moe.top_k))
    api = build(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    say(f"  fp32: {cfg.n_layers} layers, {cfg.moe.n_experts} experts at capacity "
        f"{cfg.moe.capacity_factor}, {sum(p.numel() for p in params.parameters()) / 1e9:.3f} "
        f"B params, initialised in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i, (lg, ref) in enumerate(decode_vs_prefill(api, params, long_context_tokens(cfg, dev))):
        diff = (lg - ref).abs()
        excess = (diff / (CONSISTENCY_TOL + CONSISTENCY_TOL * ref.abs())).max().item()
        say(f"  decode at {JAMBA_LONG_PROMPT + i} vs prefill of {JAMBA_LONG_PROMPT + i + 1} "
            f"tokens: max |diff| {diff.max().item():.3e}, worst |diff| / limit {excess:.4f}, "
            f"max |logit| {ref.abs().max().item():.3f}")
        if not (torch.isfinite(lg).all() and excess <= 1):
            raise AssertionError("long-context decode disagrees with prefill")
    say(f"  fp32 consistency check in {time.perf_counter() - t0:.2f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


class FamilyBatches:
    """A family's training batches: MarkovDataset tokens and targets and,
    as the reference's own smoke batch carries them, the frontend stub's
    input made from the seed and the step: PATCHES patch embeddings before
    the text for the vision model, the encoder's frames for whisper."""

    def __init__(self, cfg, seq_len, batch, seed):
        from repro_torch.data import MarkovDataset

        self.cfg, self.batch, self.seed = cfg, batch, seed
        self.tokens = MarkovDataset(cfg.vocab_size, seq_len, batch, seed=seed)

    def batch_at(self, step: int) -> dict:
        cfg, out = self.cfg, self.tokens.batch_at(step)
        rng = np.random.default_rng((self.seed, step, 1))
        if cfg.is_encoder_decoder:
            out["enc_frames"] = rng.standard_normal(
                (self.batch, cfg.encoder_seq_len, cfg.d_model), np.float32)
        if cfg.frontend == "vision":
            out["patch_embeds"] = rng.standard_normal((self.batch, PATCHES, cfg.d_model),
                                                      np.float32)
        return out


def train_and_check(api, ds, seq, dev, kernels, want):
    """Phases 16 and 18: sync training of ``api``'s config on ``ds``
    (``Trainer``, TRAIN_STEPS AdamW steps, the config's moment dtype,
    weights from the seed) with every launch count zeroed just before and
    read just after and held equal to ``want``; the losses finite and step
    0's batch scoring lower after training; step time, tok/s, peak memory
    and one profiled step printed.  Returns (trainer, launches, peak GB,
    median step s)."""
    from repro_torch.runtime.train_loop import TrainConfig, Trainer

    cfg = api.cfg
    tc = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=100, seed=SEED)
    t0 = time.perf_counter()
    trainer = Trainer(api, tc, ds, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.state["params"].parameters())
    say(f"  {cfg.name}: {n_params / 1e9:.3f} B params in {cfg.param_dtype}, state made in "
        f"{time.perf_counter() - t0:.2f} s; {TRAIN_STEPS} AdamW steps "
        f"({cfg.opt_state_dtype} moments{', remat' if cfg.remat else ''}) on batches of "
        f"{ds.batch} x {seq} tokens")
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.KERNELS:
        kern.launches = 0
    logs = trainer.run(TRAIN_STEPS)
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = [m["step_time_s"] for m in logs]
    med = float(np.median(step_s))
    losses = [m["loss"] for m in logs]
    norms = ", ".join(f"{m['grad_norm']:.3f}" for m in logs)
    aux = ("" if cfg.moe is None else
           "; aux losses " + ", ".join(f"{m['aux_loss']:.4f}" for m in logs))
    steps = ", ".join(f"{t * 1e3:.1f}" for t in step_s)
    say(f"  losses {', '.join(f'{x:.4f}' for x in losses)}; grad norms {norms}{aux}")
    say(f"  step time median {med * 1e3:.1f} ms (steps {steps}; after the first "
        f"{np.median(step_s[1:]) * 1e3:.1f} ms), {ds.batch * seq / med:.0f} tok/s; "
        f"peak memory {peak:.2f} GB")
    say(f"  launches on the training path: {launches}")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite training loss")
    # falling: step 0's batch again, on the trained weights (the steps'
    # own losses are of different batches, and step 0's rate is 0)
    first = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(0).items()}
    with torch.no_grad():
        after = float(api.train_loss(trainer.state["params"], first)[0])
    say(f"  loss of step 0's batch: {losses[0]:.4f} before training, {after:.4f} after "
        f"{TRAIN_STEPS} steps")
    if not after < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses[0]} -> {after}")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(99).items()}
    profile_window("training step", lambda i: trainer.train_step(trainer.state, batch), 1)
    return trainer, launches, peak, med


def family_train_phase(arch, dev, kernels):
    """Phase 16 for one family: sync training at full width and full
    depth with fp32 moments on FamilyBatches (``train_and_check``: exactly
    one bf16 flash forward, dq and dk/dv launch an attention layer a step,
    nothing else); then, the moments freed, one step's loss and gradients
    through the kernels and through the plain versions, same weights, same
    batch, held to FAMILY_TRAIN_LIMITS.  Returns the launch counts."""
    import repro_torch.configs as cfgs
    from repro_torch.models import build

    cfg = cfgs.get(arch)
    encdec = cfg.is_encoder_decoder
    api = build(cfg)
    seq = WHISPER_TRAIN_SEQ if encdec else TRAIN_SEQ
    depth = (f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers" if encdec
             else f"{cfg.n_layers} layers")
    extra = (f" beside {cfg.encoder_seq_len} encoder frames" if encdec else
             f" after {PATCHES} patch embeddings" if cfg.frontend == "vision" else "")
    say(f"  {cfg.name}: {depth}, d_model {cfg.d_model}{extra}")
    attn_layers = cfg.n_encoder_layers + 2 * cfg.n_layers if encdec else cfg.n_layers
    want = {kern.name: 0 for kern in kernels.KERNELS}
    for name in BF16_TRAIN_KERNELS:
        want[name] = TRAIN_STEPS * attn_layers
    ds = FamilyBatches(cfg, seq, FAMILY_TRAIN_BATCH, SEED)
    trainer, launches, _, _ = train_and_check(api, ds, seq, dev, kernels, want)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(99).items()}

    say(f"  {cfg.name}: one training step, kernels vs plain versions (moments freed)")
    model = trainer.state["params"]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    train_step_agreement(api, model, batch, kernels.PLAIN, FAMILY_TRAIN_LIMITS[arch])
    return launches


def moe_train_cfg(arch):
    """Phase 18's config: phase 17's depth cut, MOE_TRAIN_EXPERTS experts,
    everything else as published (remat and the moment dtype included)."""
    import repro_torch.configs as cfgs

    full = cfgs.get(arch)
    return full, full.replace(n_layers=MOE_LAYERS[arch], moe=dataclasses.replace(
        full.moe, n_experts=MOE_TRAIN_EXPERTS))


def say_moe_cuts(full, cfg, model, opt):
    """Phase 18's cuts, as a ``reduced`` list with the training state
    (weights, gradients and moments) each saves, and the state kept beside
    the loss's fp32 unembedding table and its fp32 gradient."""
    named = dict(model.named_parameters())
    n = sum(p.numel() for p in named.values())
    wbytes = sum(p.numel() * p.element_size() for p in named.values())
    mbytes = sum(t.numel() * t.element_size() for mom in ("m", "v")
                 for x in opt[mom].values()
                 for t in (x.values() if isinstance(x, dict) else (x,)))
    per_param = (2 * wbytes + mbytes) / n  # weight, gradient and both moments
    experts = sum(p.numel() for k, p in named.items() if ".moe.experts." in k)
    blocks = sum(p.numel() for k, p in named.items() if k.startswith("blocks."))
    per_repeat = blocks / cfg.n_repeats
    e_full, e_cut = full.moe.n_experts, cfg.moe.n_experts
    saved_experts = experts / e_cut * (e_full - e_cut) * per_param / 1e9
    saved_depth = (per_repeat + experts / cfg.n_repeats / e_cut * (e_full - e_cut)) \
        * (full.n_repeats - cfg.n_repeats) * per_param / 1e9
    say("  reduced: " + json.dumps([
        f"n_experts {e_full} -> {e_cut} in each of the {sum(s.mlp == 'moe' for s in cfg.pattern) * cfg.n_repeats} "
        f"MoE layers kept: saves {saved_experts:.1f} GB of training state",
        f"n_layers {full.n_layers} -> {cfg.n_layers} ({cfg.n_repeats} of {full.n_repeats} "
        f"repeats of the pattern): saves {saved_depth:.1f} GB more at {e_full} experts",
        "widths, heads, top_k, capacity_factor, group_size and dense_residual as published"]))
    table = cfg.vocab_size * cfg.d_model * 4 * 2 / 1e9
    say(f"  training state: {n / 1e9:.3f} B params (experts {experts / 1e9:.3f} B), weights "
        f"{wbytes / 1e9:.2f} GB + gradients {wbytes / 1e9:.2f} GB + {cfg.opt_state_dtype} "
        f"moments {mbytes / 1e9:.2f} GB = {(2 * wbytes + mbytes) / 1e9:.2f} GB; the loss's "
        f"fp32 table and its fp32 gradient {table:.2f} GB")
    return (2 * wbytes + mbytes) / 1e9 + table


def moe_train_phase(arch, dev, kernels):
    """Phase 18 for one MoE config (``moe_train_cfg``): sync training
    (``train_and_check``: exactly 2 bf16 flash forwards an attention layer
    a step, the second the recompute of remat, one dq and one dk/dv,
    nothing else), the peak memory below the card's 80 GB; then, the
    moments freed, one step's loss and gradients through the kernels and
    through the plain versions, same weights, same batch, held to
    FAMILY_TRAIN_LIMITS, with the routing decisions that differ between
    the two and between each forward and its recompute; then the same step
    with remat off, whose gradients must equal remat's within
    REMAT_GRAD_TOL.  Returns the launch counts."""
    from repro_torch.models import build
    from repro_torch.runtime.train_loop import loss_and_grads

    full, cfg = moe_train_cfg(arch)
    if not cfg.remat:
        raise AssertionError(f"{cfg.name}: the config no longer carries remat")
    api = build(cfg)
    say(f"  {cfg.name}: {cfg.n_layers} layers ({', '.join(s.mlp for s in cfg.pattern)} "
        f"MLPs), d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} kv-heads, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}")
    want = {kern.name: 0 for kern in kernels.KERNELS}
    for name in BF16_TRAIN_KERNELS:  # the forward twice: the step's and remat's
        want[name] = TRAIN_STEPS * cfg.n_layers * (2 if name == "flash_attention_sm90" else 1)
    ds = FamilyBatches(cfg, TRAIN_SEQ, FAMILY_TRAIN_BATCH, SEED)
    trainer, launches, peak, med = train_and_check(api, ds, TRAIN_SEQ, dev, kernels, want)
    expected = say_moe_cuts(full, cfg, trainer.state["params"], trainer.state["opt"])
    say(f"  peak memory {peak:.2f} GB against {expected:.2f} GB of state and loss "
        f"temporaries reckoned; step {med * 1e3:.1f} ms")
    if not peak < 80:
        raise AssertionError(f"peak memory {peak:.2f} GB: over the card's 80 GB")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(99).items()}

    say(f"  {cfg.name}: one training step, kernels vs plain versions (moments freed)")
    model = trainer.state["params"]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    tap = RoutingTap(model)
    loss_k, g_k = train_step_agreement(api, model, batch, kernels.PLAIN,
                                       FAMILY_TRAIN_LIMITS[arch], tap)
    gc.collect()
    torch.cuda.empty_cache()
    tap.close()

    say(f"  {cfg.name}: the same step with remat off (same weights, same batch)")
    model.cfg = cfg.replace(remat=False)
    for kern in kernels.KERNELS:
        kern.launches = 0
    loss_n, _, g_n = loss_and_grads(api, model, batch)
    model.cfg = cfg
    off = {kern.name: kern.launches for kern in kernels.KERNELS}
    if off != {name: n // TRAIN_STEPS // (2 if name == "flash_attention_sm90" else 1)
               for name, n in want.items()}:
        raise AssertionError(f"remat off launched {off}: the forward ran again")
    same = torch.equal(loss_n, loss_k) and all(torch.equal(g_n[k], g_k[k]) for k in g_k)
    say(f"  remat off: loss {loss_n.item():.6f} (remat {loss_k.item():.6f}); loss and "
        f"gradients bit-identical to remat's: {same}")
    if not same:
        rel = compare_grads(g_n, g_k, "g_remat_off - g_remat", "g_remat", quiet=True)
        say(f"  largest relative difference of a parameter's gradient {rel:.3e} (limit "
            f"{REMAT_GRAD_TOL:g})")
        if not (rel <= REMAT_GRAD_TOL and abs(loss_n.item() - loss_k.item()) <= REMAT_GRAD_TOL
                * abs(loss_k.item())):
            raise AssertionError("remat's gradients differ from remat off's")
    return launches


def fp32_family_phase(arch, dev, kernels):
    """Phase 20 for one D = 96 family in fp32: full width, depth cut to
    TRAIN_LAYERS, seeded weights.  (a) one training step on a FamilyBatches
    batch through the kernels and through the plain versions
    (``train_step_agreement``, TRAIN_LIMITS[fp32]); (b) a prefill and 4
    decode steps of each of FP32_FAMILY_BATCHES batches (phi-3's with
    PATCHES seeded patch embeddings), the same greedy token fed to both
    paths, logits held to CONSISTENCY_TOL.  Every count is zeroed just
    before each and read just after: (a) one fp32 flash forward, dq and
    dk/dv launch a layer; (b) one fp32 flash forward a layer a prefill and,
    for phi-3, one decode launch a layer a step (minicpm3's decode is the
    absorbed form); no bf16 kernel.  Returns the launches of (a) and (b)
    summed."""
    import repro_torch.configs as cfgs
    from repro_torch.kernels import decode_attention as decode
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import build

    full = cfgs.get(arch)
    cfg = full.replace(n_layers=TRAIN_LAYERS, param_dtype="float32", compute_dtype="float32")
    dims = ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)
            if cfg.attention == "mla" else (cfg.head_dim, cfg.head_dim))
    vision = cfg.frontend == "vision"
    api = build(cfg)
    t0 = time.perf_counter()
    model = api.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    say(f"  {cfg.name} in float32: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, (D, Dv) = {dims}, {n / 1e9:.3f} B params ({4 * n / 1e9:.2f} GB), "
        f"initialised in {time.perf_counter() - t0:.2f} s")
    say("  reduced: " + json.dumps([f"n_layers {full.n_layers} -> {cfg.n_layers} (phase 7's "
                                    "depth), widths and head dims as published"]))

    def counted(fn):
        for kern in kernels.KERNELS:
            kern.launches = 0
        fn()
        torch.cuda.synchronize()
        return {kern.name: kern.launches for kern in kernels.KERNELS}

    def expect(label, launches, want):
        say(f"  launches on the fp32 {label}: {launches}")
        if launches != want:
            raise AssertionError(f"{cfg.name} fp32 {label}: launches {launches}, "
                                 f"expected {want}")

    model.requires_grad_(True)
    model.head().drop_f32()
    ds = FamilyBatches(cfg, TRAIN_SEQ, FAMILY_TRAIN_BATCH, SEED)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(0).items()}
    torch.cuda.reset_peak_memory_stats()
    train = counted(lambda: train_step_agreement(api, model, batch, kernels.PLAIN,
                                                 TRAIN_LIMITS[torch.float32]))
    want = {kern.name: 0 for kern in kernels.KERNELS}
    for name in FP32_TRAIN_KERNELS:
        want[name] = cfg.n_layers
    expect("training step", train, want)
    say(f"  training step peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"(batch {FAMILY_TRAIN_BATCH} x {batch['tokens'].shape[1]} tokens"
        f"{f' after {PATCHES} patches' if vision else ''})")
    model.requires_grad_(False)
    del batch
    gc.collect()
    torch.cuda.empty_cache()

    batches = []
    for i in range(FP32_FAMILY_BATCHES):
        g = np.random.default_rng(SEED + 1 + i)
        b = {"tokens": torch.as_tensor(g.integers(0, cfg.vocab_size, (PER_TASK, PROMPT))).to(dev)}
        if vision:
            b["patch_embeds"] = randn((PER_TASK, PATCHES, cfg.d_model), torch.float32,
                                      SEED + 70 + i)
        batches.append((b, PROMPT + (PATCHES if vision else 0)))
    steps = 4
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        serve = counted(lambda: kernels_vs_plain(
            api, model, kernels.PLAIN, batches, batches[0][1] + FAMILY_NEW, steps,
            (CONSISTENCY_TOL, CONSISTENCY_TOL)))
    want = {kern.name: 0 for kern in kernels.KERNELS}
    want[flash.SM90_FP32_KERNEL.name] = len(batches) * cfg.n_layers
    want[decode.KERNEL.name] = 0 if cfg.attention == "mla" else len(batches) * steps * cfg.n_layers
    expect("prefill and decode", serve, want)
    say(f"  serving peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return {name: train[name] + serve[name] for name in train}


def compare_grads(got, ref, num, den, quiet=False):
    """Per parameter group (``group_of``), ||num|| / ||den||; prints each
    unless ``quiet`` (then per parameter) and returns the largest."""
    acc: dict = {}
    for name in ref:
        grp = name if quiet else group_of(name)
        d = (got[name].float() - ref[name].float()).square().sum()
        r = ref[name].float().square().sum()
        a, b = acc.get(grp, (0.0, 0.0))
        acc[grp] = (a + d, b + r)
    worst = 0.0
    for grp, (d, r) in acc.items():
        rel = (d.sqrt() / r.sqrt().clamp_min(1e-30)).item()
        worst = max(worst, rel)
        if not quiet:
            say(f"    {grp}: ||{num}|| / ||{den}|| {rel:.3e}")
    return worst


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


class WorkerState:
    """A worker's weight builds (models it holds), and the reconnects and
    replayed registrations of the process's ``RemoteLookup`` (a ``tcp://``
    worker's entry point keeps its lookup to itself, so it is found among
    the process's objects)."""

    def __call__(self, payload):
        from repro_torch.core.transport.tcp import RemoteLookup

        lookups = [o for o in gc.get_objects() if type(o) is RemoteLookup]
        return {"builds": len(_WORKER_MODELS), "lookups": len(lookups),
                "reconnects": sum(lk.reconnects for lk in lookups),
                "replayed": sum(lk.replayed_registrations for lk in lookups)}


def worker_programs():
    """The programs phases 13 and 14 ship to workers by reference: serve,
    reset the launch counts, read them, read the worker's state."""
    import chip_smoke  # run as __main__: ship the programs by module name
    from repro_torch.core import Program
    from repro_torch.runtime.serve_loop import ServeConfig

    # workers import chip_smoke: the repo root goes on their PYTHONPATH
    paths = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    if str(ROOT) not in paths:
        os.environ["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + paths)
    sc = ServeConfig(max_new_tokens=NEW, prompt_len=PROMPT,
                     batch_per_task=PER_TASK)
    return (Program(chip_smoke.WorkerGenerate(ARCH, SEED, sc),
                    name=f"generate[{ARCH}]"),
            Program(chip_smoke.WorkerLaunches(True), name="launches-reset",
                    host=True),
            Program(chip_smoke.WorkerLaunches(False), name="launches",
                    host=True),
            Program(chip_smoke.WorkerState(), name="worker-state", host=True))


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


def counted_round(label, programs, prompts, lookup, ref, handles, kernels):
    """A warm round with each worker's launch counts zeroed just before and
    read just after (through ``handles``, one per worker): summed over the
    workers, one bf16 flash launch a layer and one decode launch a layer
    and new token, per task, and no other kernel's.  Returns wall s."""
    import repro_torch.configs as cfgs
    from repro_torch.kernels import decode_attention as decode
    from repro_torch.kernels import flash_attention as flash

    program, reset, read, _ = programs
    for h in handles:
        h.execute(reset, None)
    wall, _, _ = worker_round(label, program, prompts, lookup, ref)
    counts = [h.execute(read, None) for h in handles]
    n_tasks = len(prompts) // PER_TASK
    summed = {k.name: sum(c[k.name] for c in counts) for k in kernels.KERNELS}
    say(f"  launches in the workers ({n_tasks} tasks): per worker {counts}")
    want = {k.name: 0 for k in kernels.KERNELS}
    layers = cfgs.get(ARCH).n_layers
    want[flash.SM90_KERNEL.name] = n_tasks * layers
    want[decode.KERNEL.name] = n_tasks * layers * NEW
    if summed != want:
        raise AssertionError(f"worker launches {summed}, expected {want}")
    return wall


def kill_round(label, program, prompts, lookup, ref, pool):
    """A round in which the pool's worker 0 is SIGKILLed after its first
    task, once it holds another lease (or nothing is pending); at least
    one task must be rescheduled.  Returns wall s."""
    victim = pool.workers[0].service_id
    killed = threading.Event()

    def arm(client):
        def killer():
            if client.repository.wait_until(
                    lambda s: s["per_service"].get(victim, 0) >= 1
                    and (s["leased"] >= 2 or s["pending"] == 0),
                    timeout=900):
                pool.kill(0)  # SIGKILL: no goodbye
                killed.set()
        threading.Thread(target=killer, daemon=True).start()

    wall, stats, _ = worker_round(label, program, prompts, lookup, ref,
                                  on_client=arm)
    if not killed.is_set() or pool.workers[0].alive:
        raise AssertionError(f"worker 0 was not killed during {label}")
    if stats["reschedules"] < 1:
        raise AssertionError(f"no task was rescheduled after the kill ({label})")
    return wall


def worker_phase(prompts, ref_gen, kernels):
    """Phase 13: phase 3's load on 2 proc:// workers (cold, warm with the
    workers' launch counts, one worker SIGKILLed), then on 2 shm://
    workers.  Returns each round's wall s and the start-up to first
    result."""
    from repro_torch.core import LookupService, resolve_handle
    from repro_torch.launch.now import NowPool

    programs = worker_programs()
    program = programs[0]
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
            warm = counted_round(f"round 2 (warm) on {WORKERS} proc:// workers",
                                 programs, prompts, lookup, ref_gen, handles,
                                 kernels)
        finally:
            for h in handles:
                h.close()
        kill_wall = kill_round("round 3, worker 0 SIGKILLed after its first task",
                               program, prompts, lookup, ref_gen, pool)
    lookup = LookupService()
    with NowPool(WORKERS, lookup, service_prefix="gpu-shm",
                 transport="shm") as pool:
        shm_wall, _, _ = worker_round(
            f"round 4 (cold) on {WORKERS} shm:// workers, {SHM_REQUESTS} "
            "requests", program, prompts[:SHM_REQUESTS], lookup,
            ref_gen[:SHM_REQUESTS])
    from repro_torch.core.transport.shm import detach_all
    detach_all()
    return {"cold": cold, "startup": startup, "warm": warm, "kill": kill_wall,
            "shm": shm_wall}


def tcp_phase(prompts, ref_gen, kernels):
    """Phase 14: phase 3's load on a ``TcpPool`` of 2 tcp:// workers that
    register themselves into a network lookup server; the client's lookup
    is a ``RemoteLookup``.  Rounds: cold; warm with the workers' launch
    counts; after a lookup restart (registry wiped, every connection
    dropped) once both workers have re-registered; worker 0 SIGKILLed.
    Returns each round's wall s and the start-up to first result."""
    from repro_torch.core import resolve_handle
    from repro_torch.launch.tcp import TcpPool

    programs = worker_programs()
    program, state = programs[0], programs[3]
    ids = {f"gpu-tcp{i}" for i in range(WORKERS)}

    def registered():
        """Handles of both workers, resolved from the client's lookup."""
        if not pool.lookup.wait_for_services(WORKERS, timeout_s=60):
            raise AssertionError(f"only {len(pool.lookup)} of {WORKERS} tcp "
                                 "workers registered within 60 s")
        descs = pool.lookup.query()
        if {d.service_id for d in descs} != ids:
            raise AssertionError(f"registered {[d.service_id for d in descs]}")
        return [resolve_handle(d) for d in descs]

    t_start = time.perf_counter()
    with TcpPool(WORKERS, service_prefix="gpu-tcp") as pool:
        say(f"  lookup server {pool.lookup_address}; workers "
            f"{[w.address for w in pool.workers]}")
        cold, _, t_first = worker_round(
            f"round 1 (cold) on {WORKERS} tcp:// workers", program, prompts,
            pool.lookup, ref_gen)
        startup = t_first - t_start
        say(f"  worker start-up to first result: {startup:.3f} s (pool "
            "start, torch import, CUDA context, registration, weight build, "
            "first task)")
        handles = registered()
        try:
            warm = counted_round(f"round 2 (warm) on {WORKERS} tcp:// workers",
                                 programs, prompts, pool.lookup, ref_gen,
                                 handles, kernels)
            before = {h.service_id: h.execute(state, None) for h in handles}
        finally:
            for h in handles:
                h.close()

        t0 = time.perf_counter()
        pool.server.restart()  # registry wiped, every connection dropped
        for h in registered():
            h.close()
        say(f"  lookup restarted: both workers re-registered in "
            f"{time.perf_counter() - t0:.3f} s; client lookup reconnects "
            f"{pool.lookup.reconnects}")
        restart, stats, _ = worker_round(
            "round 3, after the lookup restart", program, prompts,
            pool.lookup, ref_gen)
        served = {sid: stats["per_service"].get(sid, 0) for sid in sorted(ids)}
        if min(served.values()) < 1:
            raise AssertionError(f"a re-registered worker served no task: {served}")
        handles = registered()
        try:
            after = {h.service_id: h.execute(state, None) for h in handles}
        finally:
            for h in handles:
                h.close()
        say(f"  workers' state before the restart {before}, after round 3 "
            f"{after}")
        for sid, s in after.items():
            if (s["builds"] != 1 or s["reconnects"] <= before[sid]["reconnects"]
                    or s["replayed"] <= before[sid]["replayed"]):
                raise AssertionError(f"{sid} rebuilt its weights, or did not "
                                     "reconnect and replay its registration")

        kill_wall = kill_round("round 4, worker 0 SIGKILLed after its first task",
                               program, prompts, pool.lookup, ref_gen, pool)
    return {"cold": cold, "startup": startup, "warm": warm, "restart": restart,
            "kill": kill_wall}


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
    phase("phase 1: build")
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
    for kern in (flash.SM90_FP32_KERNEL, flash.DQ_SM90_FP32_KERNEL,
                 flash.DKV_SM90_FP32_KERNEL):
        say_smem(kern)
    say_async_smem(decode, scan)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    say(smi)

    phase("phase 2: kernels vs plain versions")
    k_rows = kernel_phase(flash, decode)

    phase("phase 3: serve")
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

    phase("phase 4: full width, kernels vs plain versions")
    full_width_phase(api, params, cfg, dev, kernels.PLAIN)

    phase("phase 5: backward kernels vs the plain backward")
    bwd = backward_phase(flash)

    phase("phase 6: sync training at full width, depth cut")
    del params
    tcfg = cfg.replace(n_layers=TRAIN_LAYERS)
    tapi = build(tcfg)
    say("  reduced: " + json.dumps([f"n_layers {cfg.n_layers} -> {TRAIN_LAYERS} for "
                                    "phases 6-7, widths as published"]))
    train_launches, state = sync_training_phase(
        tapi, tapi.init(torch.Generator(device=dev).manual_seed(SEED)), dev, kernels)

    phase("phase 7: full-width training step, kernels vs plain versions")
    train_step_agreement(tapi, state["params"], markov_batch(tcfg, dev), kernels.PLAIN,
                         TRAIN_LIMITS[torch.bfloat16])
    del state
    torch.cuda.empty_cache()
    api32 = build(tcfg.replace(param_dtype="float32", compute_dtype="float32"))
    model32 = api32.init(torch.Generator(device=dev).manual_seed(SEED))
    model32.requires_grad_(True)
    model32.head().drop_f32()
    for kern in kernels.KERNELS:
        kern.launches = 0
    train_step_agreement(api32, model32, markov_batch(tcfg, dev), kernels.PLAIN,
                         TRAIN_LIMITS[torch.float32])
    fp32_launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    say(f"  launches on the fp32 training step: {fp32_launches}")
    if (any(fp32_launches[name] != tcfg.n_layers for name in FP32_TRAIN_KERNELS)
            or any(fp32_launches[name] for name in BF16_TRAIN_KERNELS)):
        raise AssertionError("the fp32 training step did not go through the fp32 "
                             "flash kernels (forward, dq, dk/dv) once per layer, "
                             "and only through them")
    del model32
    torch.cuda.empty_cache()

    phase("phase 8: farm-mode training")
    farm_phase(cfg, dev, lookup, services, kernels)
    del api
    free(services)  # their cached programs hold qwen3's weights
    say(f"  qwen3 state freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "still allocated")

    phase("phase 9: scan kernel vs plain")
    mcfg, jcfg = cfgs.get(MAMBA_ARCH), cfgs.get(JAMBA)
    scan_err, scan_row = scan_phase(scan, PER_TASK, PROMPT, mcfg.d_inner,
                                    mcfg.ssm.state_dim)
    jscan_err, jscan_row = scan_phase(scan, PER_TASK, PROMPT, jcfg.d_inner,
                                      jcfg.ssm.state_dim)

    phase("phase 10: serve falcon-mamba-7b")
    for svc in services:  # phase 8 failed one on purpose
        svc.revive()
    mapi, mparams, mamba_launches = mamba_serve_phase(mcfg, dev, lookup, kernels)

    phase("phase 11: falcon-mamba-7b full width, kernels vs plain versions")
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

    phase("phase 12: falcon-mamba-7b sync training, depth cut")
    mamba_train_phase(mcfg, dev, kernels, full_params)
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 13: serve on worker processes (proc://, shm://)")
    now = worker_phase(prompts, gen, kernels)
    tok = REQUESTS * NEW
    say(f"  {smi}: in-process (phase 3, {SERVICES} services) {wall:.3f} s, "
        f"{tok / wall:.1f} tok/s; proc:// cold {now['cold']:.3f} s "
        f"({tok / now['cold']:.1f} tok/s, start-up to first result "
        f"{now['startup']:.3f} s), warm {now['warm']:.3f} s "
        f"({tok / now['warm']:.1f} tok/s), with a kill {now['kill']:.3f} s "
        f"({tok / now['kill']:.1f} tok/s); shm:// cold {now['shm']:.3f} s "
        f"({SHM_REQUESTS * NEW / now['shm']:.1f} tok/s)")

    phase("phase 14: serve on tcp:// workers behind a network lookup")
    tcp = tcp_phase(prompts, gen, kernels)
    rounds = "; ".join(
        f"{name} {tcp[key]:.3f} s ({tok / tcp[key]:.1f} tok/s, proc:// "
        f"{now[key]:.3f} s)" if key in now else
        f"{name} {tcp[key]:.3f} s ({tok / tcp[key]:.1f} tok/s, "
        f"{tcp[key] / tcp['warm']:.2f}x warm)"
        for name, key in (("cold", "cold"), ("warm", "warm"),
                          ("after the lookup restart", "restart"),
                          ("with a kill", "kill")))
    say(f"  {smi}: in-process (phase 3) {wall:.3f} s, {tok / wall:.1f} tok/s; "
        f"tcp:// start-up to first result {tcp['startup']:.3f} s (proc:// "
        f"{now['startup']:.3f} s); {rounds}")

    phase("phase 15: serve minicpm3-4b (MLA), phi-3-vision-4.2b and whisper-tiny")
    gc.collect()
    torch.cuda.empty_cache()
    family_launches = {}
    for arch in FAMILIES:
        family_launches[arch] = family_phase(arch, dev, lookup, kernels)
        free(services)
        say(f"  {arch} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    phase("phase 16: train minicpm3-4b (MLA), phi-3-vision-4.2b and whisper-tiny")
    trained = {}
    for arch in FAMILIES:
        trained[arch] = family_train_phase(arch, dev, kernels)
        gc.collect()
        torch.cuda.empty_cache()
        say(f"  {arch} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    phase("phase 17: serve llama4-maverick-400b-a17b and arctic-480b (MoE), depth cut")
    for arch in MOE_FAMILIES:
        family_launches[arch] = family_phase(arch, dev, lookup, kernels, MOE_LAYERS[arch])
        free(services)
        say(f"  {arch} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    phase("phase 18: train llama4-maverick-400b-a17b and arctic-480b (MoE), depth and "
        "experts cut, remat")
    for arch in MOE_FAMILIES:
        trained[arch] = moe_train_phase(arch, dev, kernels)
        gc.collect()
        torch.cuda.empty_cache()
        say(f"  {arch} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    phase("phase 19: serve jamba-1.5-large-398b (hybrid), one period, experts cut; long "
        "context")
    family_launches[JAMBA] = family_phase(JAMBA, dev, lookup, kernels, JAMBA_LAYERS,
                                          JAMBA_EXPERTS, then=long_context_phase)
    free(services)
    say(f"  {JAMBA} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
    long_context_fp32_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 20: minicpm3-4b (MLA) and phi-3-vision-4.2b in fp32, depth cut: one "
          "training step and serving, kernels vs plain versions")
    fp32_launches_d96 = {}
    for arch in FP32_FAMILIES:
        fp32_launches_d96[arch] = fp32_family_phase(arch, dev, kernels)
        gc.collect()
        torch.cuda.empty_cache()
        say(f"  {arch} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    say(f"all phases in {time.perf_counter() - START:.1f} s")
    # the kernels line: (name, kernel, its times, its largest |error|, the
    # Pallas call it replaces, the launch counts of the path that reports it)
    flash_py = "src/repro/kernels/flash_attention/flash_attention.py"
    decode_py = "src/repro/kernels/decode_attention/decode_attention.py"
    table = [
        ("flash_attention_fwd", flash.SM90_KERNEL, k_rows["flash"],
         k_rows["flash"]["err"], f"{flash_py}:127", launches),
        ("flash_attention_fwd_fp32", flash.SM90_FP32_KERNEL, k_rows["flash_fp32"],
         k_rows["flash_fp32"]["err"], f"{flash_py}:127", fp32_launches),
        ("decode_attention_fwd", decode.KERNEL, k_rows["decode"], k_rows["decode"]["err"],
         f"{decode_py}:116", launches),
        ("mamba_scan_fwd", scan.KERNEL, scan_row, scan_err,
         "src/repro/kernels/mamba_scan/mamba_scan.py:83", mamba_launches),
        ("flash_attention_fwd_d96_dv64", flash.SM90_KERNEL, k_rows["d96_dv64"],
         k_rows["d96_dv64"]["err"], f"{flash_py}:127", family_launches["minicpm3_4b"]),
        ("flash_attention_fwd_d96", flash.SM90_KERNEL, k_rows["d96"],
         k_rows["d96"]["err"], f"{flash_py}:127", family_launches["phi3_vision_4p2b"]),
        ("decode_attention_fwd_d96", decode.KERNEL, k_rows["decode_d96"],
         k_rows["decode_d96"]["err"], f"{decode_py}:116", family_launches["phi3_vision_4p2b"]),
    ]
    # phase 17's odd GQA groups: G = 5 (llama4), G = 7 (arctic); phase 19's
    # G = 8 (jamba)
    for sfx, arch in (("g5", "llama4_maverick_400b_a17b"), ("g7", "arctic_480b"),
                      ("g8", JAMBA)):
        table += [(f"flash_attention_fwd_{sfx}", flash.SM90_KERNEL, k_rows[sfx],
                   k_rows[sfx]["err"], f"{flash_py}:127", family_launches[arch]),
                  (f"decode_attention_fwd_{sfx}", decode.KERNEL, k_rows[f"decode_{sfx}"],
                   k_rows[f"decode_{sfx}"]["err"], f"{decode_py}:116", family_launches[arch])]
    table.append(("mamba_scan_d16384", scan.KERNEL, jscan_row, jscan_err,
                  "src/repro/kernels/mamba_scan/mamba_scan.py:83", family_launches[JAMBA]))
    # phase 20's fp32 forward at (96, 64) and (96, 96)
    for sfx, arch in (("d96_dv64", "minicpm3_4b"), ("d96", "phi3_vision_4p2b")):
        r = k_rows[f"fp32_{sfx}"]
        table.append((f"flash_attention_fwd_fp32_{sfx}", flash.SM90_FP32_KERNEL, r, r["err"],
                      f"{flash_py}:127", fp32_launches_d96[arch]))
    # the backward rows: one BWD_SHAPES label and dtype each, with the
    # launches of the training run that gives the pair that shape
    for sfx, label, dt, count in (
            ("", "qwen3", torch.bfloat16, train_launches),
            ("_fp32", "qwen3", torch.float32, fp32_launches),
            ("_d96_dv64", "minicpm3 MLA", torch.bfloat16, trained["minicpm3_4b"]),
            ("_d96", "phi-3 with patches", torch.bfloat16, trained["phi3_vision_4p2b"]),
            ("_whisper", "whisper encoder", torch.bfloat16, trained["whisper_tiny"]),
            ("_g5", "llama4 G=5", torch.bfloat16, trained["llama4_maverick_400b_a17b"]),
            ("_g7", "arctic G=7", torch.bfloat16, trained["arctic_480b"]),
            ("_fp32_d96_dv64", "minicpm3 MLA", torch.float32, fp32_launches_d96["minicpm3_4b"]),
            ("_fp32_d96", "phi-3 with patches", torch.float32,
             fp32_launches_d96["phi3_vision_4p2b"])):
        for part, kern, line in zip(("dq", "dkv"), flash.backward_kernels(dt), (280, 307)):
            r = bwd[(label, dt)][part]
            table.append((f"flash_attention_bwd_{part}{sfx}", kern, r, r["err"],
                          f"{flash_py}:{line}", count))
    rows = [{"name": name, "route": "cuda", "source": str(kern.source.relative_to(ROOT)),
             "replaces": replaces, "launches": count[kern.name], "max_abs_err": err,
             "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "library": r.get("library")}
            for name, kern, r, err, replaces, count in table]
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
