"""Multi-tenant serving farm on the PyTorch/CUDA port: two weighted jobs
time-sharing one pool.

The port's counterpart of ``examples/serve_farm.py``.  A qwen3 model
serves generation requests from two independent tenants over ONE shared
service pool (``repro_torch.farm.FarmScheduler``), each service running
its tasks on its own CUDA stream:

- ``interactive`` (weight 2.0) — latency-sensitive traffic, consumed in
  completion order as results arrive;
- ``batch`` (weight 1.0) — a background stream fed through
  ``submit_stream`` under a bounded in-flight window of 8 (backpressure,
  no materialized task list).

Mid-run a third service registers and the scheduler recruits it into the
pool and rebalances — elastic scale-out benefits every tenant.

    PYTHONPATH=src python examples/torch_serve_farm.py
    PYTHONPATH=src python examples/torch_serve_farm.py --reduced --device cpu

Runs on ``cuda:0`` by default, qwen3-1.7B at full size with weights from
a seeded generator; ``--reduced`` serves the reduced test config (head
dim 16, which only the CPU's plain kernel versions take: use it with
``--device cpu``).
"""

import argparse
import threading
import time

import numpy as np
import torch

import repro_torch.configs as cfgs
from repro_torch.core import LookupService, Service
from repro_torch.device import resolve_device
from repro_torch.farm import FarmScheduler
from repro_torch.models import build
from repro_torch.runtime.serve_loop import ServeConfig, make_generate_program


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = cfgs.get("qwen3_1p7b")
    if args.reduced:
        cfg = cfgs.reduced(cfg)
    api = build(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # weights complete before any service stream

    lookup = LookupService()
    for i in range(2):
        Service(lookup, device=device, service_id=f"node-{i}").start()

    def scale_out():
        time.sleep(0.25)
        Service(lookup, device=device, service_id="elastic-0").start()
        print("[pool] elastic-0 joined — scheduler rebalances all tenants")

    threading.Thread(target=scale_out, daemon=True).start()

    sc = ServeConfig(max_new_tokens=6, prompt_len=12, batch_per_task=2)
    program = make_generate_program(api, sc, params)
    rng = np.random.default_rng(0)

    def requests(n):
        for _ in range(0, n, sc.batch_per_task):
            prompts = rng.integers(0, cfg.vocab_size,
                                   (sc.batch_per_task, sc.prompt_len))
            yield {"tokens": torch.from_numpy(prompts)}

    t0 = time.perf_counter()
    with FarmScheduler(lookup, name="serve") as sched:
        interactive = sched.submit(program, list(requests(16)),
                                   weight=2.0, name="interactive")
        batch = sched.submit(program, weight=1.0, name="batch")
        batch.submit_stream(requests(48), window=8)

        served = 0
        for _tid, out in interactive.as_completed():
            served += out["generated"].shape[0]
        print(f"[interactive] {served} requests served "
              f"in {time.perf_counter() - t0:.1f}s "
              f"across services {sorted(interactive.stats()['per_service'])}")

        gen = torch.cat([r["generated"].cpu() for r in batch.results_in_order()])
        peak = batch.stats()["peak_unfinished"]
        print(f"[batch] {gen.shape[0]} requests x {gen.shape[1]} new tokens "
              f"in {time.perf_counter() - t0:.1f}s "
              f"(peak in-flight {peak} <= window 8)")
        assert served == 16 and gen.shape == (48, 6)
        assert peak <= 8
        assert 0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size

        for job in (interactive, batch):
            st = job.stats()
            print(f"[{st['name']}] weight={st['weight']} done={st['done']} "
                  f"service_time={st['service_time_s']:.2f}s "
                  f"per-service={st['per_service']}")
        print(f"[pool] services={sched.n_services} "
              f"rebalances={sched.stats()['rebalances']}")
    print("OK")


if __name__ == "__main__":
    main()
