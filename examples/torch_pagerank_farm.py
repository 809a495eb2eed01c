"""Block-parallel PageRank over the farm on the PyTorch/CUDA port.

The port's counterpart of ``examples/pagerank_farm.py``, with its graph,
blocks, damping and services.  The paper's related work (Rungsawang &
Manaskasemsak) computes PageRank on a PC cluster with low-level MPI;
JJPF's pitch is that the same computation is a task farm.  Each
power-iteration step farms one task per COLUMN BLOCK of the adjacency
matrix (y_b = A[:, b] @ x[b], independent); the client merges partial
results and iterates to convergence — fault-injected services and all.

    PYTHONPATH=src python examples/torch_pagerank_farm.py
    PYTHONPATH=src python examples/torch_pagerank_farm.py --device cpu

Runs on ``cuda:0`` by default (the blocks and the ranks live on the card);
``--device cpu`` runs it on the CPU.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import BasicClient, LookupService, Program, Service
from repro_torch.device import resolve_device

N = 1024  # nodes
BLOCKS = 8
DAMP = 0.85
MAX_ITERS = 30


def column_blocks(device) -> list:
    """The reference's random sparse-ish web graph (dense mat-vec blocks
    for simplicity), column-normalised, cut into BLOCKS column blocks."""
    rng = np.random.default_rng(0)
    A = (rng.random((N, N)) < 8.0 / N).astype(np.float32)
    deg = np.maximum(A.sum(axis=0), 1.0)
    M = (A / deg).astype(np.float32)  # column-stochastic-ish
    w = N // BLOCKS
    return [torch.from_numpy(np.ascontiguousarray(M[:, b * w:(b + 1) * w])).to(device)
            for b in range(BLOCKS)]


def partial_rank(task):
    """task: {"block": a column block of the matrix, "x_b": (N/B,)}"""
    return {"y": task["block"] @ task["x_b"]}


def pagerank(blocks, lookup, device):
    """Power iteration, one farm round a step: returns (ranks, iterations,
    last L1 delta)."""
    w = N // BLOCKS
    x = torch.full((N,), 1.0 / N, device=device)
    prog = Program(partial_rank, name="pagerank_block")
    for it in range(MAX_ITERS):
        tasks = [{"block": blocks[b], "x_b": x[b * w:(b + 1) * w]} for b in range(BLOCKS)]
        out: list = []
        cm = BasicClient(prog, None, tasks, out, lookup=lookup, lease_s=10.0)
        cm.compute(timeout=300)
        y = sum(o["y"].to(device) for o in out)
        x_new = (1 - DAMP) / N + DAMP * y
        delta = float((x_new - x).abs().sum())
        x = x_new
        if delta < 1e-7:
            break
    return x, it + 1, delta


def start_services(lookup, device):
    """The three services, registered, the first set to die after 5 tasks:
    a node lost mid-PageRank, whose tasks reschedule.  The two that stay
    up pay 20 ms a batch (``task_delay_s``, a dispatch round trip), so
    that the first takes its 5 tasks however busy the host; else they may
    take all of a round's 8 before its control thread starts."""
    services = [Service(lookup, device=device, task_delay_s=0.02 * (i > 0)) for i in range(3)]
    for s in services:
        s.start()
    services[0].fail_after(5)
    return services


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)
    blocks = column_blocks(device)

    lookup = LookupService()
    services = start_services(lookup, device)

    t0 = time.perf_counter()
    x, iters, delta = pagerank(blocks, lookup, device)
    dt = time.perf_counter() - t0
    ranks = x.cpu().numpy()
    top = np.argsort(-ranks)[:5]
    print(f"converged in {iters} iterations, {dt:.2f}s on {device} "
          f"(L1 delta {delta:.2e})")
    print("top-5 nodes:", top.tolist(), "ranks:",
          [round(float(ranks[i]), 5) for i in top])
    print("sum(x) =", round(float(ranks.sum()), 6))
    assert not services[0].alive and np.isfinite(ranks).all()
    assert abs(float(ranks.sum()) - 1.0) < 0.1
    print("OK")


if __name__ == "__main__":
    main()
