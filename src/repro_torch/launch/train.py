"""Training launcher: synchronous mode and JJPF farm mode.

    python -m repro_torch.launch.train --arch qwen3-1.7b --steps 4 \
        --batch 4 --seq-len 512 --mode sync --ckpt-dir build/ckpt
    python -m repro_torch.launch.train --arch qwen3-1.7b --mode farm \
        --layers 8 --services 2 --rounds 2 --batch 2 --seq-len 512

Runs on ``cuda:0``; ``--device cpu`` (with ``--reduced``) runs the same
path on the CPU through the kernels' plain versions.  ``--arch`` takes
every config of ``repro_torch.configs``: the dense, MLA, vision,
encoder-decoder, Mamba (falcon-mamba-7b), MoE (llama4-maverick, arctic)
and hybrid (jamba-1.5-large-398b) families.  ``--layers`` cuts the depth
of the chosen config, keeping its widths.
"""

from __future__ import annotations

import argparse
import json

import torch

import repro_torch.configs as cfgs
from repro_torch.checkpoint import AsyncCheckpointer
from repro_torch.core import LookupService, Service
from repro_torch.data import make_dataset
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.runtime.local_sgd import LocalSGDConfig, LocalSGDTrainer
from repro_torch.runtime.train_loop import TrainConfig, Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", choices=["sync", "farm"], default="sync")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--services", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "constant"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--metrics-out", default=None)
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = cfgs.get(args.arch)
    if args.reduced:
        cfg = cfgs.reduced(cfg)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    api = build(cfg)
    tc = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                     total_steps=args.steps, schedule=args.schedule,
                     stable_steps=args.steps // 2, decay_steps=args.steps // 4)

    if args.mode == "sync":
        ds = make_dataset("markov", cfg.vocab_size, args.seq_len, args.batch)
        ck = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
        trainer = Trainer(api, tc, ds, checkpointer=ck, ckpt_every=50,
                          device=device)
        logs = trainer.run(args.steps)
        print(f"{cfg.name} ({cfg.n_layers} layers) on {device}: final loss "
              f"{logs[-1]['loss']:.4f} (step {logs[-1]['step']}, "
              f"{logs[-1]['step_time_s'] * 1e3:.0f} ms/step)")
    else:
        lookup = LookupService()
        for _ in range(args.services):
            Service(lookup, device=device).start()
        ls = LocalSGDConfig(inner_steps=4, n_shards=args.services * 2,
                            batch_per_shard=args.batch, seq_len=args.seq_len)
        trainer = LocalSGDTrainer(api, tc, ls, lookup=lookup, device=device)
        losses = trainer.run(args.rounds)
        print(f"{cfg.name} ({cfg.n_layers} layers) on {device}: round losses "
              f"{[round(l, 4) for l in losses]}")
        print(f"farm stats: {trainer.farm_stats[-1]}")
        logs = [{"round": i, "loss": l} for i, l in enumerate(losses)]
    if device.type == "cuda":
        print(f"peak memory {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")

    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(logs, f, indent=1)


if __name__ == "__main__":
    main()
