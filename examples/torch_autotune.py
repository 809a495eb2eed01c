"""Tune the kernels on the farm, then serve through the cached configs.

The port's counterpart of ``examples/autotune.py``.  The autotuner IS a
farm application, the purest embarrassingly-parallel workload there is:
N independent (build a candidate, time it, report a number) tasks.  This
example runs successive-halving sweeps over a deterministic ``sim://``
cluster with the scripted cost model (so it finishes in seconds and picks
the same winners every run): the chunks of the windowed attention path
(``xla_flash``, the reference's own sweep), the bf16 flash forward's
tiles (``flash_fwd``) at qwen3-1.7B's prefill and the bf16 backward pair's
four tiles (``flash_bwd``) at its training shape, which a training step
under ``configure(path)`` launches.  It persists the winners to
a JSON cache, installs it, and calls the model-side dispatch, which picks
the tuned configs up from the cache with zero call-site changes: the
windowed path's chunks on any device, and on the card the flash kernel's
tiles too (on the CPU the plain flash version takes no tiles).

    PYTHONPATH=src python examples/torch_autotune.py
    PYTHONPATH=src python examples/torch_autotune.py --device cpu

Runs on ``cuda:0`` by default.
"""

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sim import SimCluster
from repro_torch.tune import KernelTuner, TuningCache, configure, get_cache

SHAPE = {"B": 1, "Sq": 1024, "Skv": 1024, "H": 8, "K": 2, "D": 64, "Dv": 64}
# qwen3-1.7B's prefill of 4 prompts of 512 tokens: 16 q-heads, 8 kv-heads
FLASH_SHAPE = {"B": 4, "Sq": 512, "Skv": 512, "H": 16, "K": 8, "D": 128, "Dv": 128}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)
    cache_path = os.path.join(tempfile.mkdtemp(prefix="jjpf-tune-"),
                              "tune_cache.json")

    # 1. sweeps: farm jobs over four virtual services of unequal speed
    with SimCluster(speed_factors=[1, 1, 2, 4], seed=7, device=device) as cluster:
        with cluster.make_scheduler(max_batch=4) as sched:
            tuner = KernelTuner(scheduler=sched, cache=TuningCache(cache_path))
            results = [tuner.tune("xla_flash", SHAPE, cost_model="scripted", seed=3),
                       tuner.tune("flash_fwd", FLASH_SHAPE, "bfloat16",
                                  cost_model="scripted", seed=3),
                       # the backward pair's four tiles (dq's, dk/dv's): what a
                       # training step under configure(path) launches
                       tuner.tune("flash_bwd", FLASH_SHAPE, "bfloat16",
                                  cost_model="scripted", seed=3)]
        leases = len(cluster.trace)
    for r in results:
        print(f"{r.kernel} ({r.backend}): winner {r.config}  ({r.speedup:.2f}x over "
              f"default {r.default_config}; {r.candidates} candidates, {r.pruned} "
              f"pruned, rounds {r.rounds})")
    print(f"{leases} farm leases")

    # 2. the cache is plain JSON on disk: inspectable, committable
    with open(cache_path) as f:
        entries = json.load(f)["entries"]
    print(f"cache {cache_path}: {list(entries)}")

    # 3. serve through it: install the cache and call dispatch; the tuned
    #    configs apply with no call-site changes
    configure(cache_path)
    from repro_torch.kernels import flash_attention_dispatch
    from repro_torch.kernels.flash_attention import SM90_KERNEL

    rng = np.random.default_rng(0)

    def draw(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype("float32")).to(
            device=device, dtype=dtype)

    q, k, v = (draw((1, 1024, h, 64), torch.float32) for h in (8, 2, 2))
    out = flash_attention_dispatch(q, k, v, causal=True, window=1024)
    print(f"windowed dispatch through the tuned chunks: out {tuple(out.shape)} on "
          f"{out.device}")
    B, S, H, K, D = (FLASH_SHAPE[n] for n in ("B", "Sq", "H", "K", "D"))
    q, k, v = (draw((B, S, h, D), torch.bfloat16) for h in (H, K, K))
    before = SM90_KERNEL.launches
    out = flash_attention_dispatch(q, k, v, causal=True)
    launched = SM90_KERNEL.launches - before
    print(f"flash dispatch: out {tuple(out.shape)} on {out.device}, "
          f"{launched} bf16 flash kernel launch at tiles {results[1].config}"
          if launched else f"flash dispatch: out {tuple(out.shape)} through the plain "
          f"version on {out.device} (no tiles)")
    c = get_cache()
    print(f"cache hits={c.hits} misses={c.misses}")
    if c.hits < (2 if device.type == "cuda" else 1) or not torch.isfinite(out.float()).all():
        raise SystemExit("dispatch did not read the tuned configs")
    print("OK")


if __name__ == "__main__":
    main()
