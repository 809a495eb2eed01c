"""Job: one application's task stream inside the multi-tenant farm.

JJPF's unit of tenancy is "whatever one BasicClient is currently running";
a :class:`Job` makes it a first-class object with a lifecycle::

    submitted ── admission ──▶ RUNNING ──▶ (DRAINING) ──▶ DONE
        │ (pool full)  ▲                                    │
        ▼              │                                    │
      QUEUED ──────────┘          cancel() ──────▶ CANCELLED (exactly once)

Each job owns a private streaming :class:`~repro_torch.core.repository.
TaskRepository` — leases, expiry, speculation and batched dispatch all
work per-job, unchanged — while the scheduler arbitrates which services
pull from which repository.  ``DRAINING`` is the observable tail state:
the stream is closed and nothing is pending, but leased tasks are still
in flight on services.

Streaming submission is the unbounded-source API: ``submit_stream(it)``
feeds the repository from a clock-enrolled thread under a bounded
in-flight **window** (backpressure through
``TaskRepository.wait_unfinished_below``), so a 10k-task generator never
materializes.  Results come back through exactly one of two iterators —
``as_completed()`` (completion order, lowest latency) or
``results_in_order()`` (submission order, small reorder buffer) — and
completed records are reclaimed (``reclaim_done``), keeping peak memory
proportional to the window, not the stream.

Cancellation is exactly-once: the first ``cancel()`` drops pending work,
stops the repository from ever re-enqueuing a lease, detaches the job's
services (the scheduler re-arbitrates them to the surviving jobs), and
wakes every blocked producer/consumer; late results from in-flight tasks
are discarded idempotently.

Every wait goes through the job's clock (the farm-wide Clock seam), so
multi-tenant schedules are deterministic under ``sim://``.
"""

from __future__ import annotations

import threading
from collections import deque
from enum import Enum
from typing import Any, Callable, Iterable, Iterator

from repro_torch.core.normal_form import coerce_program
from repro_torch.core.repository import TaskRepository


class JobState(Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DRAINING = "draining"
    DONE = "done"
    CANCELLED = "cancelled"


#: states a job never leaves
TERMINAL = (JobState.DONE, JobState.CANCELLED)


class JobCancelled(RuntimeError):
    """Raised to producers/consumers of a job that was cancelled."""


class Job:
    """Handle for one submitted application; created by
    ``FarmScheduler.submit``, not directly."""

    def __init__(self, scheduler, job_id: str, program, *,
                 weight: float = 1.0, name: str | None = None,
                 lease_s: float = 30.0, speculation: bool = True,
                 max_batch: int = 1, max_inflight: int = 1,
                 adaptive_batching: bool = True,
                 target_batch_latency_s: float = 0.05,
                 on_lease: Callable | None = None,
                 reclaim_done: bool = True, collect_results: bool = True,
                 shards: int = 1, obs=None):
        """``reclaim_done``/``collect_results`` are the two memory knobs
        the single-tenant adapters flip: a farm job (both True is the
        default ``reclaim_done``) drops repository copies and buffers
        results for its one consumer iterator; ``BasicClient`` keeps the
        repository copies instead (``reclaim_done=False``) and skips the
        consumer buffer (``collect_results=False``) — its deliverable is
        ``repository.results()`` in submission order."""
        if weight <= 0:
            raise ValueError("job weight must be > 0")
        if max_batch < 1 or max_inflight < 1:
            raise ValueError("max_batch and max_inflight must be >= 1")
        self.scheduler = scheduler
        self.clock = scheduler.clock
        self.job_id = job_id
        self.name = name or job_id
        self.program, self.fused_stages = coerce_program(program)
        self._weight = float(weight)
        self.speculation = speculation
        self.max_batch = max_batch
        self.max_inflight = max_inflight
        self.adaptive_batching = adaptive_batching
        self.target_batch_latency_s = target_batch_latency_s
        # job-scoped lease hook -> scheduler-level trace
        repo_on_lease = None
        if on_lease is not None:
            repo_on_lease = (lambda tid, sid, att, t:
                             on_lease(job_id, tid, sid, att, t))
        self._collect = collect_results
        self.repository = TaskRepository(
            [], lease_s=lease_s, streaming=True, clock=self.clock,
            on_complete=self._on_complete, on_lease=repo_on_lease,
            reclaim_done=reclaim_done, shards=shards, obs=obs)

        self._cond = threading.Condition()
        self._state = JobState.QUEUED
        self._errors: list[Exception] = []
        self._results: dict[int, Any] = {}     # completed, unconsumed
        self._arrival: deque[int] = deque()    # completion order
        self._delivered = 0                    # results handed to this job
        self._added = 0                        # tasks submitted to the stream
        self._stream_closed = False            # mirrors repository.closed
        self._consumer: str | None = None      # "completed" | "ordered"
        self._services: set[str] = set()       # currently attached
        self._feeders: list[threading.Thread] = []
        self.service_time_s = 0.0
        self.tasks_by_service: dict[str, int] = {}
        self.submitted_at = self.clock.monotonic()
        self.started_at: float | None = None
        self.finished_at: float | None = None

    # ---------------- lifecycle ----------------------------------- #
    @property
    def weight(self) -> float:
        with self._cond:
            return self._weight

    def set_weight(self, weight: float) -> None:
        """Change the job's fair-share weight; takes effect at the
        rebalance this triggers."""
        if weight <= 0:
            raise ValueError("job weight must be > 0")
        with self._cond:
            self._weight = float(weight)
        self.scheduler._priority_changed(self)

    @property
    def state(self) -> JobState:
        with self._cond:
            s = self._state
        if s is JobState.RUNNING and self.repository.closed:
            st = self.repository.stats()
            if (not st["cancelled"] and st["pending"] == 0
                    and st["done"] < st["tasks"]):
                return JobState.DRAINING
        return s

    @property
    def cancelled(self) -> bool:
        with self._cond:
            return self._state is JobState.CANCELLED

    @property
    def done(self) -> bool:
        with self._cond:
            return self._state in TERMINAL

    def _demand(self) -> int | None:
        """Max services this job can use: its unfinished task count once
        the stream is closed, unbounded while it can still grow.

        Maintained as counters (tasks added minus results delivered, both
        updated at event time under the job condition) — the scheduler
        consults every running job's demand on every rebalance, and a
        pair of repository-lock round-trips per job per rebalance was
        measurable coordination overhead at NoW scale."""
        with self._cond:
            if not self._stream_closed:
                return None
            return max(self._added - self._delivered, 0)

    def _mark_running(self) -> None:
        with self._cond:
            if self._state is JobState.QUEUED:
                self._state = JobState.RUNNING
                self.started_at = self.clock.monotonic()
                self.clock.cond_notify_all(self._cond)

    def _mark_done(self) -> None:
        with self._cond:
            if self._state in TERMINAL:
                return
            self._state = JobState.DONE
            self.finished_at = self.clock.monotonic()
            self.clock.cond_notify_all(self._cond)

    def cancel(self) -> bool:
        """Cancel exactly once: pending tasks are dropped, leased tasks
        can never re-enqueue, the job's services go back to the arbiter,
        and every blocked producer/consumer wakes (consumers raise
        :class:`JobCancelled`).  Returns True iff this call did the
        cancelling."""
        with self._cond:
            if self._state in TERMINAL:
                return False
            self._state = JobState.CANCELLED
            self.finished_at = self.clock.monotonic()
            self._results.clear()
            self._arrival.clear()
            self.clock.cond_notify_all(self._cond)
        self.repository.cancel()
        self.scheduler._job_finished(self)
        return True

    def _fail(self, e: Exception) -> None:
        """A program bug (not a service death) fails the whole job."""
        with self._cond:
            self._errors.append(e)
        self.cancel()

    def _record_error(self, e: Exception) -> None:
        # ControlThread's error hook (the owner surface)
        self._fail(e)

    # ---------------- submission ----------------------------------- #
    def add_task(self, payload) -> int:
        """Append one task to the job's stream; returns its task id
        (submission index).  Raises :class:`JobCancelled` after cancel
        and ``RuntimeError`` after :meth:`close`."""
        return self.add_tasks([payload])[0]

    def add_tasks(self, tasks: Iterable[Any]) -> list[int]:
        """Append a whole batch under ONE repository lock acquisition
        (``TaskRepository.add_tasks``, which also tracks the
        peak-unfinished high-water mark) — the bulk-registration path
        ``FarmExecutor.map`` and finite-job submission ride, and the
        single lock round-trip per call the streaming ``submit`` path
        pays."""
        try:
            tids = self.repository.add_tasks(list(tasks))
        except RuntimeError:
            if self.repository.cancelled:
                raise JobCancelled(self.job_id) from None
            raise
        with self._cond:
            self._added += len(tids)
        return tids

    def close(self) -> None:
        """No more tasks will be added; the job finishes when the last
        outstanding task completes (immediately, if none are left)."""
        with self._cond:
            self._stream_closed = True
        self.repository.close()
        self.scheduler._job_demand_changed(self)
        self._maybe_finished()

    def submit_stream(self, tasks: Iterable[Any], *, window: int = 64,
                      close: bool = True) -> "Job":
        """Feed an (arbitrarily long) task source under a bounded
        in-flight window.

        A clock-enrolled feeder thread pulls from ``tasks`` and blocks in
        ``TaskRepository.wait_unfinished_below`` whenever ``window``
        tasks are unfinished — backpressure, not buffering, so the
        source is never materialized and peak memory is O(window).
        With ``close=True`` (default) the job's stream closes when the
        source is exhausted.  Returns ``self`` for chaining; consume
        results concurrently with :meth:`as_completed` or
        :meth:`results_in_order`."""
        if window < 1:
            raise ValueError("window must be >= 1")

        def feed() -> None:
            self.clock.thread_attach()
            try:
                for item in tasks:
                    if not self.repository.wait_unfinished_below(window):
                        return  # cancelled
                    try:
                        self.add_task(item)
                    except (JobCancelled, RuntimeError):
                        return
                if close:
                    self.close()
            except Exception as e:  # a buggy task source fails the job
                self._fail(e)
            finally:
                self.clock.thread_retire()

        thread = threading.Thread(
            target=feed, daemon=True,
            name=f"{self.job_id}-feeder-{len(self._feeders)}")
        self._feeders.append(thread)
        self.clock.thread_spawned(thread)
        thread.start()
        return self

    # ---------------- results -------------------------------------- #
    def _on_complete(self, task_id: int, result) -> None:
        with self._cond:
            if self._state is JobState.CANCELLED:
                return
            if self._collect:
                self._results[task_id] = result
                self._arrival.append(task_id)
            self._delivered += 1
            self.clock.cond_notify_all(self._cond)
        self._maybe_finished()

    def _maybe_finished(self) -> None:
        # completion is gated on results *delivered* to the job, not on
        # the repository's done-count: `complete` marks a record DONE
        # under the repository lock but fires on_complete after releasing
        # it, so done-count can reach N while an earlier task's result is
        # still in flight to the buffers — going DONE then would let a
        # consumer drain-and-exit without that result
        if self.repository.cancelled or not self.repository.closed:
            return
        with self._cond:
            if self._delivered < len(self.repository):
                return
        self.scheduler._job_finished(self)

    def _claim(self, mode: str) -> None:
        if not self._collect:
            raise RuntimeError(
                f"job {self.job_id} was created without result collection "
                f"(collect_results=False); read repository.results() instead")
        with self._cond:
            if self._consumer is not None and self._consumer != mode:
                raise RuntimeError(
                    f"job {self.job_id} results already being consumed via "
                    f"{self._consumer}(); a job has one consumer")
            self._consumer = mode

    def as_completed(self) -> Iterator[tuple[int, Any]]:
        """Yield ``(task_id, result)`` in completion order until the
        stream is exhausted; raises :class:`JobCancelled` if the job is
        cancelled mid-iteration.  A job has exactly one result consumer
        (this or :meth:`results_in_order`)."""
        self._claim("completed")
        while True:
            with self._cond:
                while not self._arrival and self._state not in TERMINAL:
                    self.clock.cond_wait(self._cond, 0.5)
                if self._arrival:
                    tid = self._arrival.popleft()
                    item = (tid, self._results.pop(tid))
                elif self._state is JobState.CANCELLED:
                    if self._errors:
                        raise self._errors[0]
                    raise JobCancelled(self.job_id)
                else:
                    return
            yield item

    def results_in_order(self) -> Iterator[Any]:
        """Yield results in task submission order (task id order); holds
        out-of-order completions in a reorder buffer.  Same termination /
        cancellation contract as :meth:`as_completed`."""
        self._claim("ordered")
        next_tid = 0
        while True:
            with self._cond:
                while (next_tid not in self._results
                       and self._state not in TERMINAL):
                    self.clock.cond_wait(self._cond, 0.5)
                if next_tid in self._results:
                    item = self._results.pop(next_tid)
                    next_tid += 1
                elif self._state is JobState.CANCELLED:
                    if self._errors:
                        raise self._errors[0]
                    raise JobCancelled(self.job_id)
                else:
                    return
            yield item

    def wait(self, timeout: float | None = None) -> JobState:
        """Block until the job reaches a terminal state (clock-aware);
        re-raises the first program error of a failed job.  Raises
        ``TimeoutError`` if ``timeout`` lapses first."""
        deadline = (None if timeout is None
                    else self.clock.monotonic() + timeout)
        with self._cond:
            while self._state not in TERMINAL:
                remaining = (None if deadline is None
                             else deadline - self.clock.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"job {self.job_id} not finished: {self.stats()}")
                self.clock.cond_wait(
                    self._cond, min(remaining, 0.5) if remaining is not None
                    else 0.5)
            state = self._state
            errors = list(self._errors)
        if errors:
            raise errors[0]
        return state

    # ---------------- scheduler bookkeeping ------------------------ #
    def _service_attached(self, service_id: str) -> None:
        with self._cond:
            self._services.add(service_id)

    def _service_detached(self, service_id: str, seconds: float,
                          tasks_done: int) -> None:
        with self._cond:
            self._services.discard(service_id)
            self.service_time_s += seconds
            self.tasks_by_service[service_id] = (
                self.tasks_by_service.get(service_id, 0) + tasks_done)

    @property
    def n_services(self) -> int:
        with self._cond:
            return len(self._services)

    def stats(self) -> dict:
        repo = self.repository.stats()
        with self._cond:
            return {
                "job_id": self.job_id,
                "name": self.name,
                "state": self.state.value,
                "weight": self._weight,
                "services": sorted(self._services),
                "service_time_s": self.service_time_s,
                "peak_unfinished": repo["peak_unfinished"],
                "submitted_at": self.submitted_at,
                "started_at": self.started_at,
                "finished_at": self.finished_at,
                "tasks": repo["tasks"],
                "done": repo["done"],
                "pending": repo["pending"],
                "leased": repo["leased"],
                "cancelled": repo["cancelled"],
                "reschedules": repo["reschedules"],
                "speculative_issues": repo["speculative_issues"],
                "straggler_speculations": repo["straggler_speculations"],
                "per_service": repo["per_service"],
                "shards": repo["shards"],
                "lock_wait_s": repo["lock_wait_s"],
                "lock_hold_s": repo["lock_hold_s"],
                "lock_contentions": repo["lock_contentions"],
                "lock_acquisitions": repo["lock_acquisitions"],
            }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Job({self.job_id!r}, state={self.state.value}, "
                f"weight={self.weight}, done={self.repository.stats()['done']})")
