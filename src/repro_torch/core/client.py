"""BasicClient — the paper's two-line API, as a one-job engine adapter.

    cm = BasicClient(program, None, input_tasks, output)
    cm.compute()

Paper Algorithm 1:
    1 network discovery of the LookupService;
    2 query lookup for registered services;
    3 if services are available then
    4    foreach service: fork a specific control thread;
    7    wait the end of computation;
    9 terminate

Since the engine unification this class carries **no dispatch machinery
of its own**: it is "a scheduler with exactly one job".  Construction
builds a private single-tenant :class:`repro_torch.farm.FarmScheduler` (the
one dispatch core in the repo) and registers one finite
:class:`repro_torch.farm.Job` holding ``input_tasks``; :meth:`compute` starts
the engine (recruitment through the scheduler's
:class:`~repro_torch.core.pool.ServicePool` — synchronous sweep plus, when
``elastic``, the subscribe path), waits the job out, and tears the
engine down.  The control threads, batching/AIMD hot path, speculation,
heterogeneity-aware lease caps, lease expiry, and liveness monitoring
are all the engine's — identical to what a multi-tenant
``FarmScheduler`` or a ``FarmExecutor`` runs, on ``inproc://``,
``proc://``, and ``sim://`` alike.

Teardown keeps the two historical contracts:

- **success** releases every service the moment the last result is in
  (``shutdown(join=False)``) — trailing speculative duplicates must not
  stretch the makespan;
- **abort** (timeout, program error) clock-aware-joins the control
  threads first, then releases exactly once — a timed-out client must
  never hand a still-busy service back to a shared pool.

``ControlThread`` itself now lives in :mod:`repro_torch.core.lease` (re-exported
here for backward compatibility).
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

from .clock import REAL_CLOCK
from .discovery import LookupService, ServiceDescriptor
from .lease import ControlThread  # noqa: F401  (re-export: old import path)


class BasicClient:
    """The user-facing single-tenant farm driver."""

    def __init__(self, program, contract=None,
                 input_tasks: Sequence[Any] | None = None,
                 output: list | None = None, *, lookup: LookupService | None = None,
                 lease_s: float = 30.0, speculation: bool = True,
                 elastic: bool = True, max_batch: int = 1,
                 max_inflight: int = 1, adaptive_batching: bool = True,
                 target_batch_latency_s: float = 0.05, shards: int = 1,
                 clock=None, on_lease=None, obs=None):
        """Batching knobs (beyond-paper hot path; defaults reproduce the
        paper's one-task-per-round-trip dispatch exactly):

        max_batch
            Upper bound on tasks leased per service round-trip; ``> 1``
            switches the control threads to the vmap-batched path.
        max_inflight
            Batches kept un-materialized per service so device compute
            overlaps host scheduling (``1`` = fully synchronous).
        adaptive_batching
            Let the per-service controller grow/shrink the lease size
            toward ``target_batch_latency_s`` (slow services get smaller
            leases); ``False`` always leases ``max_batch``.
        target_batch_latency_s
            Latency target per batch for the adaptive controller.
        shards
            Number of independently-locked repository shards the job's
            task state is split over (``1`` = the single-lock repository;
            raise for real-thread farms with many services contending on
            one lock — see ``benchmarks/contention.py``).
        clock
            Every timestamp and blocking wait in the engine goes through
            this :class:`repro_torch.core.clock.Clock`.  Default: wall clock.
            The ``sim://`` backend passes a deterministic
            :class:`repro_torch.sim.VirtualClock` here.
        on_lease
            Assignment-trace hook: ``(task_id, service_id, attempt, t)``
            per lease/speculative issue, in lease order.  Deprecated in
            favor of ``obs`` (the recorder's ``lease`` events carry the
            same information and more); kept for compatibility.
        obs
            Optional :class:`repro_torch.obs.Observability` bundle: structured
            trace events + metrics from the whole dispatch path.
        """
        from repro_torch.farm import FarmScheduler

        self.contract = contract
        self.lookup = lookup if lookup is not None else _default_lookup()
        self.clock = clock if clock is not None else REAL_CLOCK
        self.output = output if output is not None else []
        self.elastic = elastic
        if max_batch < 1 or max_inflight < 1:
            raise ValueError("max_batch and max_inflight must be >= 1")
        # kept only for the stats() batched-path gate below; everything
        # else about dispatch lives in the engine (captured at submit)
        self.max_batch = max_batch
        self.max_inflight = max_inflight

        engine_on_lease = None
        if on_lease is not None:  # single tenant: drop the job key
            engine_on_lease = (lambda jid, tid, sid, att, t:
                               on_lease(tid, sid, att, t))
        self.engine = FarmScheduler(
            self.lookup, clock=self.clock, max_concurrent_jobs=1,
            lease_s=lease_s, speculation=speculation, max_batch=max_batch,
            max_inflight=max_inflight, adaptive_batching=adaptive_batching,
            target_batch_latency_s=target_batch_latency_s, shards=shards,
            on_lease=engine_on_lease, elastic=elastic, admit=self._admit,
            obs=obs)
        self.obs = obs
        # the one job: finite stream, results kept in the repository (the
        # deliverable is results() in submission order, so no consumer
        # buffer) — registered now, dispatched when compute() starts the
        # engine
        self._job = self.engine.submit(
            program, list(input_tasks or []), autostart=False,
            reclaim_done=False, collect_results=False)
        self.program = self._job.program
        self.fused_stages = self._job.fused_stages

    # ------------------------------------------------------------- #
    @property
    def repository(self):
        """The job's task repository (pull queue + leases)."""
        return self._job.repository

    @property
    def job(self):
        """The engine-side :class:`repro_torch.farm.Job` this client adapts."""
        return self._job

    @property
    def n_active_services(self) -> int:
        return self.engine.n_services

    def _admit(self, desc: ServiceDescriptor) -> bool:
        """Recruitment gate: the performance contract caps the pool."""
        return self.contract is None or self.contract.wants_more(self)

    def recruit(self, desc: ServiceDescriptor) -> bool:
        """Recruit one specific service (subject to the contract) — the
        :class:`~repro_torch.core.contracts.ApplicationManager` control loop's
        verb."""
        return self.engine.recruit(desc)

    # ------------------------------------------------------------- #
    def compute(self, *, timeout: float | None = None) -> list:
        """Run the farm to completion; returns (and fills) the output list."""
        try:
            self.engine.start()
            if (self.engine.n_services == 0 and len(self.repository)
                    and not self.elastic):
                # No services and no subscribe path to bring any: fail fast.
                raise RuntimeError("no services available in lookup")
            # raises the first program error of a failed job, or
            # TimeoutError when the budget lapses
            self._job.wait(timeout=timeout)
        except BaseException:
            # abort (timeout/program error): join control threads first,
            # then release exactly-once, so a timed-out client never
            # strands (or double-releases) shared pool capacity
            self.engine.shutdown(grace_s=10.0, join=True)
            raise
        # success: release immediately (compute() returns the moment the
        # last result is in — trailing speculative duplicates must not
        # stretch the makespan); stragglers find their handle already
        # popped and release nothing (pop-then-release is exactly-once)
        self.engine.shutdown(join=False)
        results = self.repository.results()
        self.output[:] = results
        return self.output

    def stats(self) -> dict:
        s = self.repository.stats()
        s["fused_stages"] = self.fused_stages
        engine = self.engine.stats()
        if self.max_batch > 1 or self.max_inflight > 1:
            s["batching"] = engine["batching"]
        s["engine"] = engine
        return s


# --------------------------------------------------------------------- #
_GLOBAL_LOOKUP: LookupService | None = None
_GLOBAL_LOOKUP_LOCK = threading.Lock()


def _default_lookup() -> LookupService:
    """Process-wide lookup (the 'network discovery of the LookupService')."""
    global _GLOBAL_LOOKUP
    with _GLOBAL_LOOKUP_LOCK:
        if _GLOBAL_LOOKUP is None:
            _GLOBAL_LOOKUP = LookupService()
        return _GLOBAL_LOOKUP
