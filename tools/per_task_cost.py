#!/usr/bin/env python3
"""The per-task serve path's host cost on one GPU: what a change to the
kernels' wrappers costs a task that runs alone, outside
``torch.func.vmap``, measured against another tree of the port in turns,
in one process on one card.

    python3 tools/per_task_cost.py [--against PKG ... --path DIR] [--pairs N]

Without ``--against`` it measures this checkout's ``repro_torch``.  With
it, each ``PKG`` is another tree of the port importable from ``DIR``
under that name (e.g. an earlier commit's ``src/repro_torch`` copied to
``DIR/repro_torch_parent`` with its imports renamed), and every
measurement alternates between the trees in ABBA order (A B C C B A for
three).  For qwen3-1.7B at
its serve shapes (``chip_smoke.py``'s phases 2 and 3: B = 4, 512-token
prompts, 64 new tokens, bf16, weights from a seeded generator, the same
in both trees):

- the host microseconds a call of the bf16 flash forward's wrapper and of
  decode's wrapper take, enqueued back to back (``CALLS`` calls, the card
  not waited for), two readings a turn, every tree's taken one after the
  other before the turn's rounds (the host's readings wander between
  slow and fast spells of a few seconds: a round between two trees'
  readings puts them in different spells);
- one task alone: prefill ms and decode ms per step (CUDA events), a
  prefill and 64 decode steps a round, two rounds a turn after an untimed
  one;

``--pairs`` turns.  Printed as medians, quartiles and every reading; as
each turn's smaller reading of a tree (the host's clock wanders between
slow and fast spells longer than a turn, so the minima compare trees
within one spell) and, for each other tree, the median over turns of
this checkout's minimum over the other's; and as one JSON line with the
card's name and power limit.  Imports neither ``jax`` nor the
reference package.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, PROMPT, NEW, H, K, D = 4, 512, 64, 16, 8, 128
CALLS = 50


def host_us(fn, calls=CALLS) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


class Tree:
    """One tree of the port: its wrappers, ops and a qwen3-1.7B model."""

    def __init__(self, pkg, dev, inputs):
        import torch

        self.name = pkg
        flash = importlib.import_module(f"{pkg}.kernels.flash_attention.flash_attention")
        decode = importlib.import_module(f"{pkg}.kernels.decode_attention.decode_attention")
        importlib.import_module(f"{pkg}.kernels.build").build_all(
            [flash.SM90_KERNEL, decode.KERNEL])
        q, k, v, qd, kc, vc = inputs
        self.calls = {
            "flash_host_us": lambda: flash.flash_attention_fwd(q, k, v, causal=True),
            "decode_host_us": lambda: decode.decode_attention_fwd(qd, kc, vc,
                                                                  cache_index=PROMPT + 31)}
        cfgs = importlib.import_module(f"{pkg}.configs")
        self.api = importlib.import_module(f"{pkg}.models").build(cfgs.get("qwen3_1p7b"))
        self.params = self.api.init(torch.Generator(device=dev).manual_seed(0))

    def round(self, tokens):
        """One prefill and NEW decode steps: (prefill ms, decode ms a step)."""
        import torch

        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        logits, caches = self.api.prefill(self.params, {"tokens": tokens},
                                          seq_budget=PROMPT + NEW)
        ev[1].record()
        for i in range(NEW):
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
            logits, caches = self.api.decode(self.params, {"tokens": nxt,
                                                           "cache_index": PROMPT + i},
                                             caches)
        ev[2].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]) / NEW


def summary(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2], "all": xs}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", action="append", default=[],
                    help="another tree's package name (repeatable)")
    ap.add_argument("--path", default=None, help="the directory it imports from")
    ap.add_argument("--pairs", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    if args.path:
        sys.path.insert(0, str(Path(args.path).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("per_task_cost: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731
    inputs = (rnd(B, PROMPT, H, D), rnd(B, PROMPT, K, D), rnd(B, PROMPT, K, D),
              rnd(B, 1, H, D), rnd(B, PROMPT + NEW, K, D), rnd(B, PROMPT + NEW, K, D))
    trees = [Tree(pkg, dev, inputs) for pkg in ["repro_torch", *args.against]]
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, trees[0].api.cfg.vocab_size, (B, PROMPT))).to(dev)
    for t in trees:
        t.round(tokens)  # untimed
    got = {t.name: {} for t in trees}
    for p in range(args.pairs):
        order = trees if p % 2 == 0 else trees[::-1]
        # ABBA: two readings of each tree a turn; the wrappers' host µs of
        # every tree back to back first (a few ms apart, one host spell),
        # then the rounds (seconds each)
        for t in order + order[::-1]:
            for key, fn in t.calls.items():
                got[t.name].setdefault(key, []).append(host_us(fn))
        for t in order + order[::-1]:
            pre, dec = t.round(tokens)
            got[t.name].setdefault("prefill_ms", []).append(pre)
            got[t.name].setdefault("decode_ms_per_step", []).append(dec)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    # each turn's smaller reading of each tree
    mins = {name: {k: [min(v[i:i + 2]) for i in range(0, len(v), 2)] for k, v in r.items()}
            for name, r in got.items()}
    out = {"card": smi, "pairs": args.pairs,
           "trees": {name: {k: summary(v) for k, v in r.items()} for name, r in got.items()},
           "turn_minima": mins, "ratios": {}}
    for name, r in out["trees"].items():
        print(f"{name} ({smi}): " + "; ".join(
            f"{k} median {s['median']:.3f} (quartiles {s['q1']:.3f}-{s['q3']:.3f}; "
            f"turn minima {', '.join(f'{m:.3f}' for m in mins[name][k])})"
            for k, s in r.items()))
    a = mins[trees[0].name]
    for t in trees[1:]:
        b = mins[t.name]
        out["ratios"][t.name] = {k: statistics.median(x / y for x, y in zip(a[k], b[k]))
                                 for k in b}
        print(f"{trees[0].name} / {t.name}, median over turns of the turn minima: "
              + "; ".join(f"{k} {v:.3f}" for k, v in out["ratios"][t.name].items()))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
