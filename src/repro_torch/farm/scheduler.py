"""FarmScheduler: THE dispatch engine — one core, many front-ends.

JJPF's value proposition (paper §1, §3) is that many independent
applications time-share one CoW/NoW with no reconfiguration — but the
paper's arbitration is first-come-first-served: whoever recruits first
keeps the service until it exits.  The scheduler replaces that with an
explicit, persistent arbiter, and since the engine unification it is the
*only* recruitment/dispatch/teardown implementation in the repo: the
single-tenant ``BasicClient`` is "a scheduler with exactly one job" and
``FarmExecutor`` is a futures veneer over one open-stream
:class:`~repro_torch.farm.job.Job`.

- it **owns the pool** through a :class:`repro_torch.core.pool.ServicePool`:
  every service that registers with the ``LookupService`` is recruited
  (and heartbeated if its transport needs it) and stays recruited until
  the scheduler shuts down, when it is released back to the lookup
  exactly once;
- applications are **jobs** (:class:`~repro_torch.farm.job.Job`): submit →
  admission control (at most ``max_concurrent_jobs`` running, FIFO queue
  beyond that) → weighted fair share of the pool → done/cancelled;
- the **arbiter** (:func:`~repro_torch.farm.arbiter.fair_assignment`) recomputes
  the service→job map on every pool or job-set change — submit, finish,
  cancel, weight change, service join, service death — and applies it by
  *revoking* control threads (``ControlThread.revoke``): a revoked thread
  stops leasing at the next batch boundary, drains its in-flight work, and
  the service is re-dispatched to its new job.  Tasks interrupted by a
  revocation or death re-enqueue through the ordinary lease machinery, so
  reassignment is safe mid-batch and loses nothing.

Concurrency contract: one re-entrant scheduler lock guards all maps (the
pool shares it); it is never held across a blocking clock wait, so the
whole scheduler runs deterministically under a
:class:`~repro_torch.sim.VirtualClock` — the multi-tenant fairness tests pin
exact assignment traces, not statistics.

Rebalance cost model (the NoW-scale contract): *job* events (submit,
finish, weight change, stream close) rebalance synchronously on the
thread that delivered them — there are few jobs, and their tests expect
the new shares immediately.  *Pool* events (join, death) only mark the
assignment dirty and are coalesced: a lazily-spawned, clock-enrolled
rebalancer thread waits out a short window (``rebalance_coalesce_s``)
and recomputes once per burst — 100 workstations registering at startup,
or a rack dying together, cost one arbiter run instead of 100.  A
scheduler that never sees a deferred event never spawns the thread, so
single-tenant fixed-pool runs keep the pre-coalescing schedule exactly.
The arbiter itself runs behind an :class:`~repro_torch.farm.arbiter.
IncrementalArbiter` (membership-incremental sorted order + fixpoint
memo) unless ``incremental_arbiter=False`` pins the legacy
full-recompute path — the scale benchmark gates on the two producing
byte-identical traces.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Iterable, Sequence

from repro_torch.core.clock import REAL_CLOCK
from repro_torch.core.discovery import LookupService, ServiceDescriptor
from repro_torch.core.lease import ControlThread
from repro_torch.core.pool import ServicePool, clock_join
from repro_torch.core.transport import ServiceHandle

from .arbiter import IncrementalArbiter, fair_assignment
from .job import Job


class _Slot:
    """The ControlThread owner binding one (job, service) pair — the
    duck-typed control surface (clock, program, repository, batching
    knobs, stop event, finish/error callbacks) the unmodified
    control-thread loops (per-task, batched AIMD, drain-on-revoke) run
    against."""

    def __init__(self, scheduler: "FarmScheduler", job: Job,
                 handle: ServiceHandle):
        self.scheduler = scheduler
        self.job = job
        self.handle = handle
        self.sid = handle.service_id
        # -- ControlThread's owner surface ---------------------------- #
        self.clock = scheduler.clock
        self.obs = scheduler.obs
        self.program = job.program
        self.repository = job.repository
        self.speculation = job.speculation
        self.max_batch = job.max_batch
        self.max_inflight = job.max_inflight
        self.adaptive_batching = job.adaptive_batching
        self.target_batch_latency_s = job.target_batch_latency_s
        self._stop = scheduler._stop
        self.started_at = scheduler.clock.monotonic()

    def _thread_finished(self, thread: ControlThread, *,
                         crashed: bool) -> None:
        self.scheduler._slot_finished(self, thread, crashed=crashed)

    def _record_error(self, e: Exception) -> None:
        # a program bug fails the job, never the service
        self.job._record_error(e)


class FarmScheduler:
    """Persistent shared pool + fair-share arbiter + job lifecycle."""

    def __init__(self, lookup: LookupService | None = None, *,
                 clock=None, max_concurrent_jobs: int = 8,
                 lease_s: float = 30.0, speculation: bool = True,
                 max_batch: int = 1, max_inflight: int = 1,
                 adaptive_batching: bool = True,
                 target_batch_latency_s: float = 0.05,
                 shards: int = 1,
                 on_lease: Callable | None = None,
                 elastic: bool = True,
                 admit: Callable[[ServiceDescriptor], bool] | None = None,
                 incremental_arbiter: bool = True,
                 rebalance_coalesce_s: float = 0.01,
                 obs=None,
                 name: str = "farm"):
        """``max_batch``/``max_inflight``/... are *defaults* for submitted
        jobs (overridable per job).  ``on_lease(job_id, task_id,
        service_id, attempt, t)`` is the cross-job assignment-trace hook
        (the sim wires it into ``SimCluster.trace``).  ``elastic=False``
        skips the lookup subscription: only services registered at
        :meth:`start` are recruited (the single-tenant front-ends expose
        this).  ``admit`` is an optional recruitment gate
        ``(descriptor) -> bool`` — performance contracts plug in here.
        ``incremental_arbiter=False`` pins the legacy full-recompute
        arbiter path (the equivalence baseline the scale gates compare
        against); ``rebalance_coalesce_s`` is the burst window pool
        events (joins/deaths) are coalesced over before one recompute.
        ``obs`` is an optional :class:`repro_torch.obs.Observability` bundle:
        when attached, the engine (and every layer below — repository,
        control threads, transports) records structured trace events and
        metrics through it, and ``stats()`` grows ``metrics``/``trace``
        subtrees.  ``obs=None`` records nothing and costs nothing."""
        if max_concurrent_jobs < 1:
            raise ValueError("max_concurrent_jobs must be >= 1")
        self.lookup = lookup if lookup is not None else LookupService()
        self.clock = clock if clock is not None else REAL_CLOCK
        self.obs = obs
        if obs is not None:
            obs.bind_clock(self.clock)
        self.name = name
        self.client_id = f"{name}-scheduler"
        self.max_concurrent_jobs = max_concurrent_jobs
        self.elastic = elastic
        self.defaults = dict(
            lease_s=lease_s, speculation=speculation, max_batch=max_batch,
            max_inflight=max_inflight, adaptive_batching=adaptive_batching,
            target_batch_latency_s=target_batch_latency_s, shards=shards)
        self.on_lease = on_lease

        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._started = False
        self.pool = ServicePool(
            self.lookup, lock=self._lock, clock=self.clock,
            client_id=self.client_id, admit=admit, obs=obs,
            on_join=self._service_joined, on_dead=self._service_dead,
            on_lost=self._service_lost)
        self._assignment: dict[str, str] = {}          # sid -> job_id
        self._threads: dict[str, ControlThread] = {}   # sid -> live thread
        self._batching: dict[str, dict] = {}           # sid -> last snapshot
        self._jobs: dict[str, Job] = {}
        self._running: list[str] = []                  # admission order
        self._queue: deque[str] = deque()              # FIFO admission queue
        self._seq = 0
        self.rebalances = 0           # arbiter recomputes actually run
        self.rebalance_requests = 0   # events that asked for one
        self.revocations = 0
        self._arbiter = IncrementalArbiter() if incremental_arbiter else None
        self.rebalance_coalesce_s = rebalance_coalesce_s
        self._dirty = False           # a deferred rebalance is owed
        self._sweeping = False        # inside start()'s recruit sweep
        self._rebalancer: threading.Thread | None = None
        self._rebalance_cond = threading.Condition(self._lock)
        #: scheduler event trace — with a VirtualClock, THE determinism
        #: artifact: ("service-join"|"service-dead"|"service-lost"|
        #: "job-submit"|"job-start"|"assign"|"job-end", t, ...)
        self.trace: list[tuple] = []

    # ---------------- lifecycle ------------------------------------ #
    def start(self) -> "FarmScheduler":
        """Recruit everything currently registered (and, when elastic,
        subscribe for future registrations); idempotent."""
        with self._lock:
            if self._started:
                return self
            self._started = True
            # the initial recruit sweep is the canonical join burst: N
            # services are already registered, and each on_join would be
            # a rebalance — mark dirty through the sweep, recompute once
            self._sweeping = True
            try:
                self.pool.open(elastic=self.elastic)
            finally:
                self._sweeping = False
            self._dirty = False
            self._rebalance_locked()
        return self

    def __enter__(self) -> "FarmScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def recruit(self, desc: ServiceDescriptor) -> bool:
        """Recruit one specific service into the pool (subject to the
        ``admit`` gate) — the autonomic-control surface
        :class:`~repro_torch.core.contracts.ApplicationManager` drives."""
        return self.pool.recruit(desc)

    def shutdown(self, *, grace_s: float = 10.0, join: bool = True) -> None:
        """Cancel unfinished jobs, stop every control thread, and release
        all services back to the lookup exactly once — the pool outlives
        the scheduler.  Idempotent.

        With ``join`` (default) the control threads are reaped clock-aware
        for up to ``grace_s`` before the release — what makes an *aborted*
        run safe on a shared pool (a released-while-busy service could be
        recruited by another client mid-execute).  ``join=False`` releases
        eagerly: the single-tenant success path uses it so trailing
        speculative duplicates never stretch the makespan — safe there
        because every job is already done and stragglers' results are
        discarded idempotently."""
        with self._lock:
            self._started = True  # a never-started scheduler just closes
            self.clock.event_set(self._stop)
            jobs = [j for j in self._jobs.values() if not j.done]
            threads = list(self._threads.values())
            if self._rebalancer is not None:
                threads.append(self._rebalancer)
                self.clock.cond_notify_all(self._rebalance_cond)
        self.pool.stop_recruiting()
        for job in jobs:
            job.cancel()
        self.pool.stop_monitor()
        if join:
            # clock-aware reap: control threads notice _stop at their next
            # lease boundary; a raw Thread.join would deadlock a VirtualClock
            clock_join(self.clock, threads, grace_s)
        with self._lock:
            self._assignment.clear()
        self.pool.release_all()

    # ---------------- pool membership ------------------------------ #
    def _service_joined(self, sid: str, handle: ServiceHandle) -> None:
        # ServicePool.on_join — under the scheduler lock
        self.trace.append(("service-join",
                           round(self.clock.monotonic(), 9), sid))
        if self.obs is not None:
            self.obs.event("recruit", None, sid, self.pool.speed(sid))
        if self._arbiter is not None:
            self._arbiter.service_joined(sid, 1.0 / self.pool.speed(sid))
        self._request_rebalance_locked(defer=True)

    def _service_lost(self, sid: str) -> None:
        # a service we never recruited left the lookup (rival client, or
        # died pre-recruitment) — under the scheduler lock
        self.trace.append(("service-lost",
                           round(self.clock.monotonic(), 9), sid))
        if self.obs is not None:
            self.obs.event("service-lost", None, sid)

    def _service_dead(self, service_id: str) -> None:
        """LivenessMonitor verdict (ServicePool.on_dead): expire the dead
        node's leases *now* (its job re-leases them elsewhere immediately)
        and drop it."""
        with self._lock:
            thread = self._threads.get(service_id)
            job = thread.client.job if thread is not None else None
            self._forget_service_locked(service_id, reason="service-dead")
            if job is not None:
                job.repository.expire_service(service_id)
            if thread is not None:
                thread.revoke()
            self._request_rebalance_locked(defer=True)

    def _forget_service_locked(self, sid: str, *, reason: str) -> None:
        if not self.pool.forget(sid):
            return
        if self._arbiter is not None:
            self._arbiter.service_left(sid)
        self._assignment.pop(sid, None)
        self.trace.append((reason, round(self.clock.monotonic(), 9), sid))
        if self.obs is not None:
            self.obs.event(reason, None, sid)

    # ---------------- job lifecycle -------------------------------- #
    def submit(self, program, tasks: Sequence[Any] | Iterable[Any] | None = None,
               *, weight: float = 1.0, name: str | None = None,
               autostart: bool = True, **knobs) -> Job:
        """Submit a job.  With ``tasks`` the stream is finite and closes
        immediately (the job finishes when the last task completes);
        without, it is open — feed it with ``Job.add_task`` /
        ``Job.submit_stream`` and ``Job.close`` it.  ``knobs`` override
        the scheduler-wide per-job defaults (``max_batch``, ``lease_s``,
        ...).  Admission control: beyond ``max_concurrent_jobs`` running
        jobs, submissions queue FIFO.  ``autostart=False`` registers the
        job without starting the engine (recruitment happens at the
        caller's later :meth:`start` — the single-tenant adapters defer
        it to their own run verb)."""
        merged = dict(self.defaults)
        merged.update(knobs)
        # materialize and load the task source OUTSIDE the scheduler lock:
        # a large (or blocking, or raising) iterable must not stall every
        # other tenant's rebalance/finish path, and a failure here leaves
        # no half-registered job behind
        task_list = list(tasks) if tasks is not None else None
        with self._lock:
            if autostart:
                self.start()
            if self._stop.is_set():
                raise RuntimeError("cannot submit after shutdown")
            job_id = f"job-{self._seq}"
            self._seq += 1
        job = Job(self, job_id, program, weight=weight, name=name,
                  on_lease=self.on_lease, obs=self.obs, **merged)
        if task_list is not None:
            job.add_tasks(task_list)  # private until admission: no lock
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("cannot submit after shutdown")
            self._jobs[job_id] = job
            self.trace.append(("job-submit",
                               round(self.clock.monotonic(), 9), job_id,
                               float(weight)))
            if self.obs is not None:
                self.obs.event("job-submit", None, job_id, float(weight))
            if len(self._running) < self.max_concurrent_jobs:
                self._start_job_locked(job)
                self._request_rebalance_locked(defer=False)
            else:
                self._queue.append(job_id)
            if task_list is not None:
                job.close()  # may finish an empty job on the spot
        return job

    def _start_job_locked(self, job: Job) -> None:
        self._running.append(job.job_id)
        job._mark_running()
        self.trace.append(("job-start",
                           round(self.clock.monotonic(), 9), job.job_id))
        if self.obs is not None:
            self.obs.event("job-start", None, job.job_id)

    def _admit_locked(self) -> None:
        while self._queue and len(self._running) < self.max_concurrent_jobs:
            job = self._jobs[self._queue.popleft()]
            if job.done:  # cancelled while queued
                continue
            self._start_job_locked(job)

    def _job_finished(self, job: Job) -> None:
        """Called on completion (last result recorded) and on cancel —
        from whatever thread got there first; exactly-once by
        construction (membership test under the lock)."""
        with self._lock:
            if job.job_id in self._queue:  # cancelled while queued
                self._queue.remove(job.job_id)
                job._mark_done()  # no-op if cancelled
                return
            if job.job_id not in self._running:
                return
            self._running.remove(job.job_id)
            job._mark_done()
            self.trace.append(("job-end", round(self.clock.monotonic(), 9),
                               job.job_id, job.state.value))
            if self.obs is not None:
                self.obs.event("job-end", None, job.job_id, job.state.value)
            if self._stop.is_set():
                return
            self._admit_locked()
            self._request_rebalance_locked(defer=False)

    def _priority_changed(self, job: Job) -> None:
        with self._lock:
            if job.job_id in self._running and not self._stop.is_set():
                self._request_rebalance_locked(defer=False)

    def _job_demand_changed(self, job: Job) -> None:
        """A stream closed: its demand became finite — surplus services
        (if any) should flow to other jobs without waiting for the job
        to finish."""
        with self._lock:
            if job.job_id in self._running and not self._stop.is_set():
                self._request_rebalance_locked(defer=False)

    # ---------------- the arbiter loop ----------------------------- #
    def _request_rebalance_locked(self, *, defer: bool) -> None:
        """One rebalance, please.  ``defer=False`` (job events) runs it
        now on the calling thread; ``defer=True`` (pool events) marks the
        assignment dirty and lets the rebalancer thread fold the whole
        burst into one recompute after ``rebalance_coalesce_s``.  During
        :meth:`start`'s recruit sweep everything just marks dirty — the
        sweep ends with one synchronous flush and no thread is spawned."""
        self.rebalance_requests += 1
        if self._sweeping:
            self._dirty = True
            return
        if not defer or self._stop.is_set():
            self._dirty = False
            self._rebalance_locked()
            return
        self._dirty = True
        if self._rebalancer is None:
            self._rebalancer = threading.Thread(
                target=self._rebalance_loop, daemon=True,
                name=f"{self.name}-rebalancer")
            self.clock.thread_spawned(self._rebalancer)
            self._rebalancer.start()
        else:
            self.clock.cond_notify_all(self._rebalance_cond)

    def _rebalance_loop(self) -> None:
        """The coalescing rebalancer: sleep until marked dirty, let the
        burst window close, recompute once.  Clock-enrolled, so under a
        VirtualClock a burst of same-instant joins/deaths is *provably*
        one recompute: every event lands before the window's virtual
        deadline."""
        self.clock.thread_attach()
        try:
            while True:
                with self._rebalance_cond:
                    while not self._dirty and not self._stop.is_set():
                        self.clock.cond_wait(self._rebalance_cond, 0.5)
                    if self._stop.is_set():
                        return
                # burst window: scheduler lock released while we wait
                self.clock.sleep(self.rebalance_coalesce_s)
                with self._lock:
                    if self._dirty and not self._stop.is_set():
                        self._dirty = False
                        self._rebalance_locked()
        finally:
            self.clock.thread_retire()

    def _rebalance_locked(self) -> None:
        """Recompute the fair-share service→job map and apply the diff:
        changed services are revoked (their thread exits at the next
        lease boundary and re-dispatches) or dispatched if idle."""
        if not self._started or self._stop.is_set():
            return
        self.rebalances += 1
        jobs = [(jid, self._jobs[jid].weight, self._jobs[jid]._demand())
                for jid in self._running]
        if self._arbiter is not None:
            desired = self._arbiter.compute(jobs, self._assignment)
        else:
            desired = fair_assignment(self.pool.capacities(), jobs,
                                      self._assignment)
        now = round(self.clock.monotonic(), 9)
        obs = self.obs
        changed = 0
        for sid in self.pool.ids():
            new = desired.get(sid)
            old = self._assignment.get(sid)
            if new == old:
                if new is not None and sid not in self._threads:
                    self._dispatch_locked(sid)  # idle service, same job
                continue
            if new is None:
                self._assignment.pop(sid, None)
            else:
                self._assignment[sid] = new
            self.trace.append(("assign", now, sid, new))
            changed += 1
            if obs is not None:
                obs.event("assign", now, sid, new)
            thread = self._threads.get(sid)
            if thread is not None:
                self.revocations += 1
                if obs is not None:
                    obs.event("revoke", now, sid, old)
                thread.revoke()  # _slot_finished re-dispatches on exit
            else:
                self._dispatch_locked(sid)
        if obs is not None:
            obs.event("rebalance", now, len(jobs), changed)

    def _dispatch_locked(self, sid: str) -> None:
        if self._stop.is_set() or sid in self._threads:
            return
        jid = self._assignment.get(sid)
        if jid is None:
            return  # idle — stays recruited, waiting for the next job
        job = self._jobs.get(jid)
        handle = self.pool.handle(sid)
        if job is None or job.done or handle is None:
            self._assignment.pop(sid, None)
            return
        slot = _Slot(self, job, handle)
        thread = ControlThread(slot, handle, name=f"farm-{sid}-{jid}")
        self._threads[sid] = thread
        job._service_attached(sid)
        self.clock.thread_spawned(thread)
        thread.start()

    def _slot_finished(self, slot: _Slot, thread: ControlThread, *,
                       crashed: bool) -> None:
        """A control thread exited: revoked, job drained, or service
        failure.  Crash verdicts are double-checked with a ping — a
        *program* bug also unwinds as `crashed` but must fail the job
        (done via ``_record_error``), never cost the pool a service."""
        alive = True
        if crashed:
            try:
                alive = slot.handle.ping()
            except Exception:
                alive = False
        with self._lock:
            if self._threads.get(slot.sid) is thread:
                del self._threads[slot.sid]
            self._accumulate_batching_locked(slot.sid, thread)
            slot.job._service_detached(
                slot.sid, self.clock.monotonic() - slot.started_at,
                thread.tasks_done)
            if not alive:
                self._forget_service_locked(slot.sid, reason="service-dead")
                self._request_rebalance_locked(defer=True)
                return
            if self._stop.is_set():
                return
            # re-dispatch per the *current* desired map: a revoked thread
            # lands on its new job, a finished job's thread goes wherever
            # the job-end rebalance pointed the service (or idles)
            self._dispatch_locked(slot.sid)

    # ---------------- introspection -------------------------------- #
    def _merged_snapshot_locked(self, sid: str,
                                thread: ControlThread) -> dict:
        # THE accumulation rule, in one place: dispatch counts accumulate
        # across this service's successive threads; controller state and
        # the handle's compile-cache counters (already cumulative) come
        # from the latest binding
        snap = thread.snapshot()
        prev = self._batching.get(sid)
        if prev is not None:
            snap["batches_dispatched"] += prev["batches_dispatched"]
        return snap

    def _accumulate_batching_locked(self, sid: str,
                                    thread: ControlThread) -> None:
        self._batching[sid] = self._merged_snapshot_locked(sid, thread)

    @property
    def n_services(self) -> int:
        return len(self.pool)

    def jobs(self) -> list[Job]:
        with self._lock:
            return list(self._jobs.values())

    def assignment(self) -> dict[str, str]:
        """Current desired service→job map (a copy)."""
        with self._lock:
            return dict(self._assignment)

    def services_of(self, job: Job) -> list[str]:
        with self._lock:
            return sorted(s for s, j in self._assignment.items()
                          if j == job.job_id)

    def batching_stats(self) -> dict[str, dict]:
        """Per-service batching/compile telemetry (adaptive-controller
        state, batches dispatched, cache hits), covering live control
        threads and the accumulated history of exited ones."""
        with self._lock:
            merged = dict(self._batching)
            for sid, thread in self._threads.items():
                merged[sid] = self._merged_snapshot_locked(sid, thread)
            return merged

    def stats(self) -> dict:
        """THE engine-level snapshot — every front-end's ``stats()``
        embeds this one shape (per-service pool membership + assignment,
        batching telemetry, job lifecycle, arbiter counters).  The key
        set is versioned (``schema``) and pinned by
        :mod:`repro_torch.obs.schema`; with an Observability bundle attached
        the snapshot additionally carries the metrics registry
        (``metrics``) and recorder state (``trace``)."""
        from repro_torch.obs.schema import STATS_SCHEMA

        batching = self.batching_stats()
        with self._lock:
            snap = {
                "schema": STATS_SCHEMA,
                "services": {
                    sid: {"speed_factor": self.pool.speed(sid),
                          "job": self._assignment.get(sid)}
                    for sid in self.pool.ids()},
                "n_services": len(self.pool),
                "running": list(self._running),
                "queued": list(self._queue),
                "rebalances": self.rebalances,
                "rebalance_requests": self.rebalance_requests,
                "revocations": self.revocations,
                "batching": batching,
                "jobs": {jid: j.stats() for jid, j in self._jobs.items()},
                "arbiter": (self._arbiter.stats()
                            if self._arbiter is not None else None),
            }
        if self.obs is not None:
            snap["metrics"] = self.obs.registry.snapshot()
            snap["trace"] = self.obs.recorder.stats()
        return snap
