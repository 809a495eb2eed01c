"""Sim launcher: ``SimPool``, the deterministic twin of ``NowPool``.

``NowPool`` stands a Network of Workstations up as real OS processes;
``SimPool`` stands the same shape of cluster up as virtual services on a
seeded :class:`repro_torch.sim.VirtualClock` — same constructor shape, same
``workers`` list, same ``kill(index)`` verb — so a scheduling or
fault-tolerance experiment can swap wall-clock processes for a
bit-reproducible simulation by changing one line.

Usage::

    lookup = LookupService()
    with SimPool(4, lookup, speed_factors=[1, 1, 2, 4], seed=7) as pool:
        cm = pool.client(program, tasks, max_batch=8)   # clock pre-wired
        cm.compute(timeout=600)        # virtual seconds, milliseconds real

The calling thread is enrolled on the pool's virtual clock for the
pool's lifetime (construction to ``shutdown``/context exit), mirroring
how ``NowPool`` owns its worker processes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from repro_torch.sim import FaultSpec, SimCluster, SimService


@dataclass
class SimWorker:
    index: int
    service_id: str
    service: SimService
    descriptor: object

    @property
    def address(self) -> str:
        return f"sim://{self.service.token}"

    @property
    def alive(self) -> bool:
        return not self.service.dead


class SimPool:
    """Spawn, register, kill, and reap ``sim://`` farm workers."""

    def __init__(self, n_workers: int, lookup=None, *, seed: int = 0,
                 speed_factors: Sequence[float] | None = None,
                 base_cost_s: float = 0.001, latency_s: float = 0.0002,
                 latency_jitter_s: float = 0.0,
                 faults: dict[int, FaultSpec] | None = None,
                 service_prefix: str = "sim", obs=None, device=None):
        if speed_factors is not None and len(speed_factors) != n_workers:
            raise ValueError("speed_factors length must equal n_workers")
        self.cluster = SimCluster(
            n_workers, seed=seed, speed_factors=speed_factors,
            base_cost_s=base_cost_s, latency_s=latency_s,
            latency_jitter_s=latency_jitter_s, faults=faults,
            lookup=lookup, service_prefix=service_prefix, obs=obs,
            device=device)
        self.lookup = self.cluster.lookup
        self.clock = self.cluster.clock
        self.cluster.open()
        self.workers = [
            SimWorker(i, svc.service_id, svc, svc.descriptor())
            for i, svc in enumerate(self.cluster.services)]

    def client(self, program, tasks, output: list | None = None, **knobs):
        """A BasicClient wired to this pool's lookup and virtual clock."""
        return self.cluster.make_client(program, tasks, output, **knobs)

    def scheduler(self, **cfg):
        """Shared-scheduler mode: a multi-tenant
        :class:`repro_torch.farm.FarmScheduler` owning this pool (lookup +
        virtual clock pre-wired) — the deterministic twin of
        ``NowPool.scheduler``."""
        return self.cluster.make_scheduler(**cfg)

    def executor(self, program, **knobs):
        """A :class:`repro_torch.core.FarmExecutor` over this pool (lookup +
        virtual clock pre-wired) — the futures front-end of the same
        engine; collect with ``executor.gather`` under the virtual
        clock."""
        return self.cluster.make_executor(program, **knobs)

    def kill(self, index: int) -> None:
        """Kill a live worker — instant scripted death, the sim analog of
        ``NowPool.kill``'s SIGKILL."""
        self.workers[index].service.kill()

    def shutdown(self) -> None:
        self.cluster.close()

    def __enter__(self) -> "SimPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def __len__(self) -> int:
        return len(self.workers)
