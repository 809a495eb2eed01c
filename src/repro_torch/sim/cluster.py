"""SimCluster: a deterministic heterogeneous NoW in one process.

The paper's headline figures (§3, Figs. 2–4) are about *scheduling*: pull
dispatch load-balancing a farm across unequal workstations, recovering
from nodes that vanish mid-task.  Those behaviors are untestable against
a wall clock — host load turns every threshold into a flake — so this
module stands up N virtual services with scriptable speed factors,
latency distributions and fault schedules (:class:`~repro_torch.sim.FaultSpec`)
on one seeded :class:`~repro_torch.sim.VirtualClock`, registers them as
``sim://`` endpoints, and lets the **real** farm stack run over them:
``BasicClient`` control threads, batched AIMD dispatch, the liveness
monitor, lease expiry, speculation — the identical code paths the
``inproc://`` and ``proc://`` backends use, scheduled cooperatively so
the whole run is bit-reproducible.

Usage::

    with SimCluster(speed_factors=[1, 1, 2, 4], seed=7) as cluster:
        out, client = cluster.run(program, tasks, max_batch=8)
        cluster.trace        # the (t, task_id, service_id, attempt) log
        cluster.clock.monotonic()   # virtual makespan

Virtual cost model per call: one dispatch-latency sample (seeded, per
service) + ``n_tasks × base_cost_s × speed_factor`` of compute, then the
result is produced by the same ``Service`` execution engine the other
backends use (real PyTorch on the cluster's ``device``, instant in
virtual time).  ``speed_factor`` keeps the repo-wide convention: 1.0 =
baseline, 4.0 = four times slower.  ``device`` follows the port's rule:
``None`` is the card, and the CPU is used only when asked for
(``device="cpu"``).
"""

from __future__ import annotations

import heapq
import random
import threading
from contextlib import contextmanager
from typing import Sequence

from repro_torch.core.client import BasicClient
from repro_torch.core.discovery import LookupService, ServiceDescriptor
from repro_torch.core.errors import ServiceFailure
from repro_torch.core.service import Service
from repro_torch.core.transport.sim import register_sim, unregister_sim

from .clock import VirtualClock
from .faults import FaultSpec

_NO_FAULTS = FaultSpec()


class SimService:
    """One virtual workstation: fault schedule + speed factor + RNG stream
    around the shared ``Service`` execution engine."""

    def __init__(self, cluster: "SimCluster", service_id: str, *,
                 speed_factor: float = 1.0, rng: random.Random,
                 fault: FaultSpec | None = None):
        self.cluster = cluster
        self.clock = cluster.clock
        self.lookup = cluster.lookup
        self.service_id = service_id
        self.speed_factor = float(speed_factor)
        self.rng = rng
        self.fault = fault or _NO_FAULTS
        # the execution engine (program cache, vmap batching, padding) —
        # constructed quiet: no lookup, no task_delay, unit speed; all
        # timing is virtual and charged by _virtual_work below
        self.engine = Service(None, service_id=service_id,
                              device=cluster.device)
        self.capabilities = {"n_devices": 1, "transport": "sim",
                             "speed_factor": self.speed_factor}
        self.token = register_sim(self)
        self._lock = threading.Lock()
        self._recruited_by: str | None = None
        self._killed = False
        self._stall_spent = False
        self.registrations = 0
        self.dropped_registrations = 0

    # ---------------- discovery (Algorithm 2 glue) -------------------- #
    def descriptor(self) -> ServiceDescriptor:
        return ServiceDescriptor(self.service_id, f"sim://{self.token}",
                                 dict(self.capabilities), keepalive=self)

    def start(self) -> None:
        if self.fault.register_at > 0:
            self.cluster.schedule(self.fault.register_at, self._register)
        else:
            self._register()

    def _register(self) -> None:
        if self.dead or self._recruited_by is not None:
            return
        p = self.fault.flaky_registration
        if p > 0 and self.rng.random() < p:
            self.dropped_registrations += 1
            self.cluster.schedule(
                self.clock.monotonic() + self.cluster.rereg_delay_s,
                self._register)
            return
        self.registrations += 1
        self.lookup.register(self.descriptor())

    # ---------------- handle verbs ------------------------------------ #
    def recruit(self, client_id: str) -> bool:
        with self._lock:
            if self.dead or self._recruited_by is not None:
                return False
            self._recruited_by = client_id
        self.lookup.unregister(self.service_id)
        return True

    def release(self) -> None:
        with self._lock:
            self._recruited_by = None
        if self.dead:
            return
        self._register()

    def ping(self) -> bool:
        return not self.dead

    def prepare(self, program) -> None:
        self._virtual_work(0)  # one round-trip to ship the program
        self.engine.prepare(program)

    def execute(self, program, payload):
        self._virtual_work(1)
        return self.engine.execute(program, payload)

    def execute_batch(self, program, payloads: list, *, block: bool = True,
                      pad_to: int | None = None) -> list:
        self._virtual_work(len(payloads))
        # block=True regardless: results are instant in virtual time, and
        # materializing here keeps the drain path (block_until_ready on
        # the control thread) a no-op under the cooperative scheduler
        return self.engine.execute_batch(program, payloads, block=True,
                                         pad_to=pad_to)

    # ---------------- the virtual cost model -------------------------- #
    @property
    def dead(self) -> bool:
        return self._dead_at(self.clock.monotonic())

    def _dead_at(self, t: float) -> bool:
        return self._killed or (self.fault.die_at is not None
                                and t >= self.fault.die_at)

    def kill(self) -> None:
        """Immediate scripted-from-outside death (``SimPool.kill``)."""
        self._killed = True
        self.lookup.unregister(self.service_id)

    def _virtual_work(self, n_tasks: int) -> None:
        """Charge one service round-trip to the virtual clock, honoring
        the fault schedule.  Raises ServiceFailure at the exact virtual
        instant the schedule says the node is gone."""
        now = self.clock.monotonic()
        f = self.fault
        if self._dead_at(now):
            if f.silent and not self._killed:
                # a wedged node: the call hangs (liveness must catch it)
                self.clock.sleep(f.hang_s)
            raise ServiceFailure(f"{self.service_id} is dead (sim)")
        end = (now + self.cluster.sample_latency(self.rng)
               + n_tasks * self.cluster.base_cost_s * self.speed_factor)
        if (f.stall_at is not None and not self._stall_spent
                and now <= f.stall_at < end):
            self._stall_spent = True  # one-shot
            end += f.stall_s
        if f.die_at is not None and f.die_at <= end:
            self.clock.sleep(max(f.die_at - now, 0.0))
            if f.silent:
                self.clock.sleep(f.hang_s)
            raise ServiceFailure(f"{self.service_id} died mid-call (sim)")
        self.clock.sleep(end - now)
        if self._killed:  # killed out-of-band while we were computing
            raise ServiceFailure(f"{self.service_id} was killed (sim)")

    @property
    def tasks_executed(self) -> int:
        return self.engine.tasks_executed


class SimCluster:
    """N SimServices + one VirtualClock + one LookupService, wired so the
    unmodified farm stack runs over them deterministically."""

    def __init__(self, n_services: int | None = None, *, seed: int = 0,
                 speed_factors: Sequence[float] | None = None,
                 base_cost_s: float = 0.001, latency_s: float = 0.0002,
                 latency_jitter_s: float = 0.0,
                 faults: dict[int, FaultSpec] | None = None,
                 lookup: LookupService | None = None,
                 rereg_delay_s: float = 0.05,
                 service_prefix: str = "sim",
                 stall_timeout_s: float = 60.0,
                 obs=None, device=None):
        if speed_factors is None:
            speed_factors = [1.0] * (4 if n_services is None else n_services)
        self.speed_factors = [float(s) for s in speed_factors]
        self.seed = seed
        self.device = device
        self.clock = VirtualClock(seed=seed, stall_timeout_s=stall_timeout_s)
        # a lookup we construct waits in virtual time (clock seam); a
        # caller-supplied one keeps whatever clock it was built with
        self.lookup = (lookup if lookup is not None
                       else LookupService(clock=self.clock))
        self.base_cost_s = base_cost_s
        self.latency_s = latency_s
        self.latency_jitter_s = latency_jitter_s
        self.rereg_delay_s = rereg_delay_s
        #: assignment trace: (virtual t, task_id, service_id, attempt) in
        #: lease order — THE determinism artifact (same seed ⇒ same list).
        #: With ``obs`` set the recorder's ``lease`` events supersede this
        #: hook (the bespoke on_lease path is deprecated): the cluster
        #: installs no hook and ``trace`` stays empty.
        self.trace: list[tuple] = []
        self.obs = obs
        if obs is not None:
            obs.bind_clock(self.clock)
        master = random.Random(seed)
        faults = faults or {}
        self.services = [
            SimService(self, f"{service_prefix}{i}", speed_factor=sf,
                       rng=random.Random(master.randrange(2**63)),
                       fault=faults.get(i))
            for i, sf in enumerate(self.speed_factors)]
        # scripted-event driver (late registrations, flaky re-register
        # retries): a managed thread that sleeps in virtual time until the
        # next event is due
        self._events: list[tuple[float, int, object]] = []
        self._eseq = 0
        self._events_cond = threading.Condition()
        self._driver: threading.Thread | None = None
        self._stopping = False
        self._entered = False

    # ---------------- lifecycle --------------------------------------- #
    def open(self) -> "SimCluster":
        """Enroll the calling thread on the virtual clock and register
        the services (``with SimCluster(...)`` calls this)."""
        if self._entered:
            return self
        self.clock.adopt_current()
        self._entered = True
        for svc in self.services:
            svc.start()
        return self

    def close(self) -> None:
        """Let every enrolled thread run out its virtual waits (hung
        silent-death calls included), stop the driver, unregister the
        endpoints, and release the calling thread from the clock."""
        if not self._entered:
            return
        with self._events_cond:
            self._stopping = True
            self.clock.cond_notify_all(self._events_cond)
        self.clock.drain()
        self._entered = False
        for svc in self.services:
            self.lookup.unregister(svc.service_id)  # no stale descriptors
            unregister_sim(svc.token)
        self.clock.thread_retire()

    def __enter__(self) -> "SimCluster":
        return self.open()

    def __exit__(self, *exc) -> None:
        self.close()

    def __len__(self) -> int:
        return len(self.services)

    # ---------------- scripted events --------------------------------- #
    def schedule(self, at: float, fn) -> None:
        """Run ``fn()`` at virtual time ``at`` (cluster-driver thread)."""
        with self._events_cond:
            if self._stopping:
                return
            heapq.heappush(self._events, (at, self._eseq, fn))
            self._eseq += 1
            if self._driver is None:
                self._driver = threading.Thread(
                    target=self._drive, daemon=True, name="sim-driver")
                self.clock.thread_spawned(self._driver)
                self._driver.start()
            else:
                self.clock.cond_notify_all(self._events_cond)

    def _drive(self) -> None:
        self.clock.thread_attach()
        try:
            with self._events_cond:
                while not self._stopping:
                    now = self.clock.monotonic()
                    if self._events and self._events[0][0] <= now:
                        _, _, fn = heapq.heappop(self._events)
                        fn()
                        continue
                    timeout = (self._events[0][0] - now if self._events
                               else 60.0)
                    self.clock.cond_wait(self._events_cond, timeout)
        finally:
            self.clock.thread_retire()

    # ---------------- farm driving ------------------------------------ #
    def sample_latency(self, rng: random.Random) -> float:
        if self.latency_jitter_s <= 0:
            return self.latency_s
        return max(0.0, self.latency_s
                   + self.latency_jitter_s * (2.0 * rng.random() - 1.0))

    def _record_lease(self, task_id, service_id, attempt, t) -> None:
        self.trace.append((round(t, 9), task_id, service_id, attempt))

    def make_client(self, program, tasks, output: list | None = None,
                    **knobs) -> BasicClient:
        """A BasicClient wired to this cluster (lookup + virtual clock +
        assignment-trace hook).  All timeouts/leases the client takes are
        in virtual seconds — deterministic, never load-dependent."""
        knobs.setdefault("lease_s", 1.0)
        if self.obs is not None:
            knobs.setdefault("obs", self.obs)
        else:
            knobs.setdefault("on_lease", self._record_lease)
        return BasicClient(program, None, tasks,
                           output if output is not None else [],
                           lookup=self.lookup, clock=self.clock, **knobs)

    def run(self, program, tasks, *, timeout: float = 600.0, **knobs):
        """Run one farm to completion; returns (output, client)."""
        client = self.make_client(program, tasks, **knobs)
        out = client.compute(timeout=timeout)
        return out, client

    def make_executor(self, program, **knobs):
        """A FarmExecutor wired to this cluster (lookup + virtual clock +
        assignment-trace hook) — the third front-end over the same
        engine; collect futures with ``executor.gather`` (clock-aware),
        never ``Future.result()`` (which would block the cooperative
        scheduler invisibly)."""
        from repro_torch.core.futures import FarmExecutor

        knobs.setdefault("lease_s", 1.0)
        if self.obs is not None:
            knobs.setdefault("obs", self.obs)
        else:
            knobs.setdefault("on_lease", self._record_lease)
        return FarmExecutor(program, lookup=self.lookup, clock=self.clock,
                            **knobs)

    def _record_job_lease(self, job_id, task_id, service_id, attempt,
                          t) -> None:
        # multi-tenant twin of _record_lease: task ids are per-job, so
        # the trace keys them as "job-N/tid" to stay collision-free
        self.trace.append((round(t, 9), f"{job_id}/{task_id}",
                           service_id, attempt))

    def make_scheduler(self, **cfg):
        """A multi-tenant :class:`repro_torch.farm.FarmScheduler` wired to this
        cluster (lookup + virtual clock + per-job lease tracing into
        ``cluster.trace``).  Call ``.start()`` (or submit) to recruit."""
        from repro_torch.farm import FarmScheduler

        cfg.setdefault("lease_s", 1.0)
        if self.obs is not None:
            cfg.setdefault("obs", self.obs)
        else:
            cfg.setdefault("on_lease", self._record_job_lease)
        return FarmScheduler(self.lookup, clock=self.clock, **cfg)

    def ideal_makespan(self, n_tasks: int) -> float:
        """Perfect-scheduling lower bound for ``n_tasks`` uniform tasks on
        this mix: total work over aggregate service rate (latency-free)."""
        agg_rate = sum(1.0 / (self.base_cost_s * sf)
                       for sf in self.speed_factors)
        return n_tasks / agg_rate


@contextmanager
def virtual_time(seed: int = 0, stall_timeout_s: float = 30.0):
    """Enroll the calling thread on a fresh VirtualClock for the duration
    of the block — for tests that drive clocked components (repository,
    LivenessMonitor) directly rather than through a SimCluster."""
    clock = VirtualClock(seed=seed, stall_timeout_s=stall_timeout_s)
    clock.adopt_current()
    try:
        yield clock
    finally:
        clock.drain()
        clock.thread_retire()
