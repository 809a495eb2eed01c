"""Future-based farm driver (the paper's §4 future work, implemented).

*"...the introduction of futures for reducing the number of thread required
on client side to manage the computation."*

``FarmExecutor`` exposes an ``Executor``-style API: ``submit(task)`` returns
a ``concurrent.futures.Future`` immediately; the stream can keep growing
while the farm runs.  Client-side threads scale with the number of
*services*, never with the number of in-flight tasks.

Since the engine unification the executor is a **futures veneer over one
open-stream job**: it owns a private single-tenant
:class:`repro_torch.farm.FarmScheduler` (the one dispatch core), registers one
open :class:`repro_torch.farm.Job`, feeds it through ``Job.add_task`` /
``Job.add_tasks`` (``map`` registers the whole batch under ONE repository
lock acquisition), and resolves futures from a single clock-enrolled
consumer thread draining ``Job.as_completed()``.  It contains zero
recruitment, release, or thread-reaping logic of its own.

``shutdown()`` follows ``Executor.shutdown(cancel_futures=True)``
semantics: every future not yet resolved is cancelled — callers blocked on
``.result()`` wake up with ``CancelledError`` instead of hanging forever —
and any later ``submit`` raises ``RuntimeError``.  A *program* bug fails
the job, and every then-pending future resolves to that exception."""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Sequence

from .client import _default_lookup
from .discovery import LookupService
from .pool import clock_join


class FarmExecutor:
    def __init__(self, program, *,
                 lookup: LookupService | None = None, lease_s: float = 30.0,
                 speculation: bool = True, max_batch: int = 1,
                 max_inflight: int = 1, adaptive_batching: bool = True,
                 target_batch_latency_s: float = 0.05, shards: int = 1,
                 clock=None, on_lease=None, obs=None):
        from repro_torch.farm import FarmScheduler

        engine_on_lease = None
        if on_lease is not None:  # single tenant: drop the job key
            engine_on_lease = (lambda jid, tid, sid, att, t:
                               on_lease(tid, sid, att, t))
        self.engine = FarmScheduler(
            lookup if lookup is not None else _default_lookup(),
            clock=clock, max_concurrent_jobs=1, lease_s=lease_s,
            speculation=speculation, max_batch=max_batch,
            max_inflight=max_inflight, adaptive_batching=adaptive_batching,
            target_batch_latency_s=target_batch_latency_s, shards=shards,
            on_lease=engine_on_lease, obs=obs)
        self.obs = obs
        # the one job: an open stream (closed only at shutdown), results
        # buffered for the consumer thread, completed records reclaimed —
        # peak memory is the in-flight window, not the whole stream
        self._job = self.engine.submit(program, autostart=False)
        self._futures: dict[int, Future] = {}
        self._flock = threading.Lock()
        self._consumer: threading.Thread | None = None
        self._started = False
        self._shutdown = False
        self._start_lock = threading.Lock()

    @property
    def job(self):
        """The engine-side open-stream :class:`repro_torch.farm.Job`."""
        return self._job

    def _ensure_started(self) -> None:
        with self._start_lock:
            if self._started:
                return
            self._started = True
            self.engine.start()
            thread = threading.Thread(target=self._consume, daemon=True,
                                      name="farm-executor-results")
            self._consumer = thread
            self.engine.clock.thread_spawned(thread)
            thread.start()

    def _consume(self) -> None:
        """The one results pump: drains the job's completion stream and
        resolves futures — per-task state lives in the repository plus
        this future map, never in a per-task thread."""
        from repro_torch.farm import JobCancelled

        clock = self.engine.clock
        clock.thread_attach()
        error: Exception | None = None
        try:
            for tid, result in self._job.as_completed():
                with self._flock:
                    fut = self._futures.pop(tid, None)
                if fut is not None and not fut.cancelled():
                    fut.set_result(result)
        except JobCancelled:
            pass  # shutdown/cancel: stranded futures are cancelled there
        except Exception as e:  # program bug: it failed the job —
            error = e           # surface it through every pending future
        finally:
            if error is not None:
                with self._flock:
                    pending = list(self._futures.values())
                    self._futures.clear()
                for fut in pending:
                    if not fut.cancelled():
                        fut.set_exception(error)
            clock.thread_retire()

    # ------------------------------------------------------------- #
    def submit(self, task: Any) -> Future:
        if self._shutdown:
            raise RuntimeError("cannot submit after shutdown")
        self._ensure_started()
        fut: Future = Future()
        # register the future under the id the repository assigns, under
        # the future-map lock: a result that lands between add_task and
        # registration blocks on the same lock in the consumer
        with self._flock:
            if self._shutdown:  # raced with shutdown(): don't strand it
                raise RuntimeError("cannot submit after shutdown")
            tid = self._job.add_task(task)
            self._futures[tid] = fut
        return fut

    def map(self, tasks: Sequence[Any]) -> list[Future]:
        """Submit a whole batch: ONE repository lock acquisition for the
        lot (``Job.add_tasks``) instead of a lock round-trip per task —
        measurable on 10k-task streaming submits."""
        if self._shutdown:
            raise RuntimeError("cannot submit after shutdown")
        self._ensure_started()
        tasks = list(tasks)
        futs: list[Future] = [Future() for _ in tasks]
        with self._flock:
            if self._shutdown:
                raise RuntimeError("cannot submit after shutdown")
            tids = self._job.add_tasks(tasks)
            for tid, fut in zip(tids, futs):
                self._futures[tid] = fut
        return futs

    def gather(self, futures: Sequence[Future], *,
               timeout: float | None = None) -> list:
        """Collect results clock-aware: under a ``sim://`` VirtualClock a
        raw ``Future.result()`` would block the cooperative scheduler
        invisibly, so this polls through the engine's clock seam.  On the
        real clock prefer plain ``.result()``."""
        clock = self.engine.clock
        deadline = (None if timeout is None
                    else clock.monotonic() + timeout)
        for fut in futures:
            while not fut.done():
                if deadline is not None and clock.monotonic() >= deadline:
                    raise TimeoutError("gather timed out")
                clock.sleep(0.02)
        return [fut.result() for fut in futures]

    def shutdown(self) -> None:
        """Stop the farm and cancel every unresolved future (callers
        blocked on ``.result()`` wake up with ``CancelledError``).
        Idempotent; ``submit`` raises afterwards."""
        with self._flock:
            self._shutdown = True
            stranded = list(self._futures.values())
            self._futures.clear()
        # cancel the stream (wakes the consumer), then the engine joins
        # its control threads and releases every service exactly once —
        # one teardown path, shared with every other front-end
        self._job.cancel()
        self.engine.shutdown(grace_s=10.0, join=True)
        consumer = self._consumer
        if consumer is not None:
            clock_join(self.engine.clock, [consumer], 10.0)
        for fut in stranded:
            fut.cancel()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    def stats(self) -> dict:
        s = self._job.repository.stats()
        engine = self.engine.stats()
        s["batching"] = engine["batching"]
        s["engine"] = engine
        return s
