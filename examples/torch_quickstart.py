"""Quickstart on the PyTorch/CUDA port: the paper's two-line API on a local
'cluster' — and the three front-ends of the one dispatch engine behind it.

The port's counterpart of ``examples/quickstart.py``, with its programs,
tasks and knobs:

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --transport=proc
    PYTHONPATH=src python examples/torch_quickstart.py --transport=shm
    PYTHONPATH=src python examples/torch_quickstart.py --transport=tcp
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --trace /tmp/t.json

``--transport=inproc`` (default) stands the cluster up as objects in this
process; ``--transport=proc`` spawns one OS worker process per service
(the NoW deployment) — same client code, same two lines, the endpoint
addresses in the lookup are just ``proc://`` instead of ``inproc://``.
``--transport=shm`` is proc with payloads over a shared-memory ring (the
same-host fast path); ``--transport=tcp`` runs discovery itself over the
network (a LookupServer + self-registering workers — point other hosts'
workers at its address to grow the farm).

Every idiom below (blocking ``BasicClient``, futures ``FarmExecutor``,
shared multi-tenant ``FarmScheduler``) is an adapter over the same
``repro_torch.farm`` scheduler core, so all of them run on either
transport.

``--trace out.json`` attaches the telemetry spine (``repro_torch.obs``)
to every farm below and exports one Chrome trace-event JSON at the end —
open it at https://ui.perfetto.dev (or chrome://tracing): one track per
service, task spans nested under leases, scheduler decisions as instants.
A ``farm-top`` summary of the last engine prints too.

Services and workers run on ``cuda:0`` by default; ``--device cpu`` runs
them on the CPU.  The programs are module-level functions of this file,
which runs as the module ``torch_quickstart``: a worker process imports
them by name, so they reach it without ``cloudpickle``.
"""

import argparse
import os
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def poly(x):
    return x * x + 1


def shift(x):
    return x + 10


def scale(x):
    return x * 2


def inc(x):
    return x + 1


def floats(values) -> list:
    return [float(v) for v in values]


def main():
    from repro_torch.core import (BasicClient, Farm, FarmExecutor, LookupService, Pipe,
                                  Program, Seq, Service)
    from repro_torch.device import resolve_device
    from repro_torch.farm import FarmScheduler

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--transport", choices=("inproc", "proc", "shm", "tcp"),
                    default="inproc")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export a Chrome/Perfetto trace of every farm run "
                         "below to PATH")
    args = ap.parse_args()
    device = resolve_device(args.device)

    obs = None
    if args.trace:
        from repro_torch.obs import Observability

        obs = Observability()

    # --- stand up a tiny cluster (normally: one Service per pod/workstation) --
    pool = None
    if args.transport != "inproc":
        # the workers import this module to find the programs
        os.environ["PYTHONPATH"] = str(HERE) + os.pathsep + os.environ.get("PYTHONPATH", "")
    if args.transport in ("proc", "shm"):
        from repro_torch.launch.now import NowPool

        lookup = LookupService()
        pool = NowPool(3, lookup, service_prefix="qs", transport=args.transport,
                       device=device)
    elif args.transport == "tcp":
        from repro_torch.launch.tcp import TcpPool

        pool = TcpPool(3, service_prefix="qs", device=device)
        lookup = pool.lookup  # a RemoteLookup: discovery over the network
    else:
        lookup = LookupService()
        for _ in range(3):
            Service(lookup, device=device).start()

    try:
        # --- the paper's two lines ------------------------------------------
        program = Program(poly, name="poly")
        tasks = [torch.tensor(float(i)) for i in range(16)]
        output: list = []

        cm = BasicClient(program, None, tasks, output, lookup=lookup, obs=obs)
        cm.compute()

        print("results :", floats(output))
        print("stats   :", cm.stats())

        # --- skeleton composition: pipe(farm, seq) normalizes to one fused farm
        skel = Pipe(Farm(Seq(Program(shift, name="shift"))),
                    Seq(Program(scale, name="scale")))
        out2: list = []
        BasicClient(skel, None, tasks, out2, lookup=lookup, obs=obs).compute()
        print("pipeline:", floats(out2))

        # --- the batched async hot path (beyond the paper) -------------------
        # max_batch    : lease up to N shape-compatible tasks per round-trip
        #                and run them as ONE torch.func.vmap call
        # max_inflight : batches kept un-materialized per service, so device
        #                compute overlaps host scheduling
        # adaptive_batching / target_batch_latency_s : per-service controller
        #                that grows/shrinks the lease toward the latency target
        out3: list = []
        cm3 = BasicClient(program, None, tasks, out3, lookup=lookup, obs=obs,
                          max_batch=8, max_inflight=2, adaptive_batching=True,
                          target_batch_latency_s=0.05)
        cm3.compute()
        print("batched :", floats(out3))
        print("batching:", cm3.stats()["batching"])

        # --- front-end 2: futures (FarmExecutor over the same engine) --------
        # submit() returns a concurrent.futures.Future immediately; map()
        # registers the whole batch under one repository lock acquisition
        with FarmExecutor(program, lookup=lookup, max_batch=4, obs=obs) as ex:
            futs = ex.map(tasks)
            print("futures :", [float(f.result(timeout=120)) for f in futs])

        # --- front-end 3: the shared multi-tenant scheduler ------------------
        # two weighted jobs time-share the same pool; the engine arbitrates by
        # weighted fair share and revokes control threads to rebalance
        with FarmScheduler(lookup, max_batch=4, obs=obs) as sched:
            heavy = sched.submit(program, tasks, weight=2.0)
            light = sched.submit(Program(inc, name="inc"), tasks)
            heavy.wait(timeout=120)
            light.wait(timeout=120)
            print("tenants :", floats(heavy.results_in_order())[:4], "...",
                  floats(light.results_in_order())[:4], "...")
            sched_stats = sched.stats()

        if obs is not None:
            from repro_torch.obs.export import farm_top

            obs.export_chrome_trace(args.trace)
            print(farm_top(sched_stats))
            print(f"trace   : wrote {args.trace} "
                  f"({obs.stats()['events_recorded']} events) — open it at "
                  f"https://ui.perfetto.dev")
    finally:
        if pool is not None:
            pool.shutdown()
    assert floats(output) == [float(i * i + 1) for i in range(16)]
    print("OK")


if __name__ == "__main__":
    # run as the module torch_quickstart, whose functions a worker can import
    sys.path.insert(0, str(HERE))
    import torch_quickstart

    torch_quickstart.main()
