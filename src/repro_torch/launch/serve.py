"""Serving launcher: the paper's workload — a farm of generation requests.

    python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --requests 16 --services 2 --prompt-len 512 --new-tokens 64

Runs on ``cuda:0``; ``--device cpu`` (with ``--reduced``) runs the same
path on the CPU through the kernels' plain versions.  ``--arch`` takes
the configs of ``repro_torch.configs`` of the dense, MLA, vision, Mamba
(falcon-mamba-7b), MoE (llama4-maverick, arctic) and hybrid
(jamba-1.5-large-398b) families.  Archs are served
from text prompts, as by the reference's launcher: a vision model
without patch embeddings.  An encoder-decoder arch (whisper) is refused:
its tasks need encoder frames, which ``serve_requests`` does not build
(run ``make_generate_program`` on tasks that carry ``enc_frames``).
``--tune-cache PATH`` installs a tuning cache (``repro_torch.tune``): the
kernels' launch parameters and the plain chunked paths' chunks are read
from it; shapes it has no entry for keep the defaults.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch.configs as cfgs
from repro_torch.core import LookupService, Service
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.runtime.serve_loop import ServeConfig, serve_requests


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--services", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--batch-per-task", type=int, default=4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths as published)")
    ap.add_argument("--kill-one", action="store_true",
                    help="fault-inject a service mid-run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--tune-cache", default=None, metavar="PATH",
                    help="kernel tuning cache (JSON from repro_torch.tune): the "
                         "kernels' tiles, KV splits and lanes and the chunked "
                         "paths' chunks are read from it; untuned shapes keep "
                         "the defaults")
    args = ap.parse_args(argv)

    if args.tune_cache:
        from repro_torch.tune import configure

        cache = configure(args.tune_cache)
        print(f"tuning cache {args.tune_cache}: {len(cache)} entries")

    device = resolve_device(args.device)
    cfg = cfgs.get(args.arch)
    if cfg.is_encoder_decoder:
        ap.error(f"{cfg.name}: every task needs encoder frames (enc_frames); "
                 "this launcher serves text prompts only")
    if args.reduced:
        cfg = cfgs.reduced(cfg)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    api = build(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # weights complete before any service stream

    lookup = LookupService()
    services = [Service(lookup, device=device) for _ in range(args.services)]
    for s in services:
        s.start()
    if args.kill_one:
        services[0].fail_after(1)

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.requests, args.prompt_len))
    sc = ServeConfig(max_new_tokens=args.new_tokens,
                     prompt_len=args.prompt_len,
                     batch_per_task=args.batch_per_task)
    t0 = time.perf_counter()
    gen, stats = serve_requests(api, params, prompts, sc, lookup=lookup)
    dt = time.perf_counter() - t0
    toks = gen.shape[0] * gen.shape[1]
    print(f"generated {tuple(gen.shape)} on {device} in {dt:.2f}s "
          f"({toks/dt:.0f} tok/s across the farm)")
    print(f"farm stats: {stats}")
    if args.tune_cache:
        print(f"tuning cache lookups: {cache.hits} hits, {cache.misses} misses")


if __name__ == "__main__":
    main()
