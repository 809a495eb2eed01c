"""ControlThread: the per-(owner, service) lease loop — the dispatch
engine's innermost layer.

Paper Algorithm 1 forks "a specific control thread" per recruited
service; this module is that thread, extracted from the client so every
front-end shares ONE implementation.  A control thread serves one
recruited service: it pulls tasks from a :class:`~repro_torch.core.repository.
TaskRepository` (pull scheduling = automatic load balancing), pushes them
to the service, stores results, and — on a service failure — reports the
task back for rescheduling and exits.

Beyond the paper: the batched/asynchronous hot path.  With ``max_batch >
1`` the thread leases up to N shape-compatible tasks per round-trip
(``TaskRepository.get_batch``) and runs them as ONE vmap call
(``ServiceHandle.execute_batch``); with ``max_inflight > 1`` it keeps
several batches in flight on the service's CUDA stream, so device compute
overlaps host scheduling, and only waits on the oldest batch's recorded
CUDA event when the window is full.  An :class:`~repro_torch.core.batching.
AdaptiveBatchController` per service grows/shrinks the lease size from
observed batch latency, which keeps slow services (large
``speed_factor``) on small leases — sharp load balancing on
heterogeneous clusters.

Control threads are transport-agnostic: they talk to a
:class:`~repro_torch.core.transport.base.ServiceHandle` resolved from the
registered endpoint address, so the per-task and batched/AIMD paths run
unmodified over every transport (``inproc://`` in this package).

Every timestamp and blocking wait goes through ``owner.clock``
(:class:`repro_torch.core.clock.Clock`, wall clock by default) — the seam
that lets a virtual clock schedule these exact threads deterministically.
"""

from __future__ import annotations

import threading
from collections import deque

from .batching import (AdaptiveBatchController, bucket_size,
                       payload_signature, speed_capped_max_batch)
from .errors import ServiceFailure
from .transport import ServiceHandle


class ControlThread(threading.Thread):
    """One per (owner, recruited service) pair — paper §2.

    ``client`` is duck-typed — any *owner* exposing the control surface
    works: ``clock``, ``program``, ``repository``, ``speculation``,
    ``max_batch``, ``max_inflight``, ``adaptive_batching``,
    ``target_batch_latency_s``, ``_stop`` (a ``threading.Event``),
    ``_thread_finished(thread, crashed=...)`` and ``_record_error(e)``.
    Since the engine unification the one production owner is the
    ``repro_torch.farm`` scheduler's ``_Slot``, which binds the thread to one
    (job, service) pair; ``_record_error`` must always mean "program
    bug" (fails the job), never "service death".  The scheduler *revokes*
    the thread when the fair-share arbiter reassigns the service:
    :meth:`revoke` makes the thread stop leasing, drain its in-flight
    batches, and report back through ``_thread_finished`` — tasks already
    leased either complete normally or fail back through the ordinary
    lease machinery, so revocation is safe mid-batch.
    """

    def __init__(self, client, handle: ServiceHandle, *, name: str | None = None):
        super().__init__(daemon=True, name=name or f"ctl-{handle.service_id}")
        self.client = client
        self.handle = handle
        # telemetry bundle from the owner surface (optional — None is
        # the zero-overhead default)
        self.obs = getattr(client, "obs", None)
        self._revoked = threading.Event()
        self.tasks_done = 0
        self.batches_dispatched = 0
        # heterogeneity-aware lease ceiling: a service advertising itself
        # k× slower (descriptor speed_factor) is capped at max_batch/k, so
        # it can never hoard a full-size lease near the end of a stream
        speed = float(handle.capabilities.get("speed_factor") or 1.0)
        cap = speed_capped_max_batch(client.max_batch, speed)
        self.controller = AdaptiveBatchController(
            max_batch=cap,
            initial=cap if not client.adaptive_batching else None,
            target_latency_s=client.target_batch_latency_s)

    def revoke(self) -> None:
        """Ask the thread to stop pulling work and report back (the
        fair-share arbiter's reassignment verb).  Takes effect at the next
        lease boundary: the current task/batch finishes (or fails back)
        first, in-flight batches are drained, then the thread exits via
        ``_thread_finished(crashed=False)``."""
        self.client.clock.event_set(self._revoked)

    @property
    def revoked(self) -> bool:
        return self._revoked.is_set()

    def _should_stop(self) -> bool:
        return self.client._stop.is_set() or self._revoked.is_set()

    def run(self) -> None:
        self.client.clock.thread_attach()
        try:
            self._run_guarded()
        finally:
            self.client.clock.thread_retire()

    def _run_guarded(self) -> None:
        try:
            self.handle.prepare(self.client.program)
        except ServiceFailure:
            self.client._thread_finished(self, crashed=True)
            return
        except Exception as e:
            self.client._record_error(e)
            self.client._thread_finished(self, crashed=True)
            return
        if self.client.max_batch > 1 or self.client.max_inflight > 1:
            self._run_batched()
        else:
            self._run_per_task()

    # ---------------- per-task path (paper Algorithm 1) --------------- #
    def _run_per_task(self) -> None:
        repo = self.client.repository
        program = self.client.program
        sid = self.handle.service_id
        while not self._should_stop():
            got = repo.get_task(sid,
                                allow_speculation=self.client.speculation)
            if got is None:
                if repo.all_done:
                    break
                continue
            task_id, payload = got
            obs = self.obs
            if obs is not None:
                t0 = self.client.clock.monotonic()
                obs.event("dispatch", t0, sid, 1)
            try:
                result = self.handle.execute(program, payload)
            except ServiceFailure:
                repo.fail(task_id, sid)
                self.client._thread_finished(self, crashed=True)
                return
            except Exception as e:  # program bug: surface it, don't hang
                repo.fail(task_id, sid)
                self.client._record_error(e)
                self.client._thread_finished(self, crashed=True)
                return
            if obs is not None:
                now = self.client.clock.monotonic()
                obs.event("drain", now, sid, 1, t0)
                obs.dispatch_latency_s.observe(now - t0)
                obs.batch_size.observe(1)
            if repo.complete(task_id, result, sid):
                self.tasks_done += 1
        self.client._thread_finished(self, crashed=False)

    # ---------------- batched async path ------------------------------ #
    def _drain_one(self, inflight: deque) -> bool:
        """Materialize the oldest in-flight batch and record its results.
        Returns False if materialization failed (asynchronous CUDA work
        reports its errors here); the batch is failed back for re-lease.
        The wait is on the CUDA event the service recorded after the
        batch (``BatchResults.wait``); CPU batches are ready already."""
        task_ids, results, t_dispatch = inflight.popleft()
        try:
            results.wait()
        except Exception as e:
            for tid in task_ids:
                self.client.repository.fail(tid, self.handle.service_id)
            if not isinstance(e, ServiceFailure):
                self.client._record_error(e)
            return False
        now = self.client.clock.monotonic()
        obs = self.obs
        if obs is not None:
            obs.event("drain", now, self.handle.service_id, len(task_ids),
                      t_dispatch)
            obs.dispatch_latency_s.observe(now - t_dispatch)
        # service time, not residence time: with max_inflight > 1 a batch
        # queues behind its predecessors, so time-since-dispatch would be
        # inflated ~max_inflight-fold and collapse the adaptive batch to 1.
        # The batch's compute effectively starts at the later of its
        # dispatch and the previous batch's completion.
        self.controller.record(len(task_ids),
                               now - max(t_dispatch, self._last_drain_end))
        self._last_drain_end = now
        self.tasks_done += self.client.repository.complete_batch(
            list(zip(task_ids, results)), self.handle.service_id)
        if self.client.speculation:
            # observed-throughput feed for straggler detection: a service
            # whose rate collapses gets its leases speculatively re-issued
            self.client.repository.report_rate(
                self.handle.service_id, self.controller.throughput_ewma)
        return True

    def _run_batched(self) -> None:
        repo = self.client.repository
        program = self.client.program
        sid = self.handle.service_id
        adaptive = self.client.adaptive_batching
        # (task_ids, un-materialized results, dispatch time)
        inflight: deque = deque()
        self._last_drain_end = 0.0
        crashed = False
        while not self._should_stop():
            max_batch = (self.controller.next_batch() if adaptive
                         else self.client.max_batch)
            # non-blocking poll while batches are in flight: if nothing is
            # leasable right now, drain the oldest batch instead of idling
            batch = repo.get_batch(sid, max_batch,
                                   timeout=0.0 if inflight else 0.5,
                                   allow_speculation=self.client.speculation,
                                   compatible=payload_signature)
            if batch is None:
                if inflight:
                    if not self._drain_one(inflight):
                        crashed = True
                        break
                    continue
                if repo.all_done:
                    break
                continue
            task_ids = [tid for tid, _ in batch]
            payloads = [p for _, p in batch]
            t0 = self.client.clock.monotonic()
            try:
                results = self.handle.execute_batch(
                    program, payloads, block=False,
                    pad_to=bucket_size(len(payloads), self.client.max_batch))
            except ServiceFailure:
                for tid in task_ids:
                    repo.fail(tid, sid)
                crashed = True
                break
            except Exception as e:  # program bug: surface it, don't hang
                for tid in task_ids:
                    repo.fail(tid, sid)
                self.client._record_error(e)
                crashed = True
                break
            self.batches_dispatched += 1
            obs = self.obs
            if obs is not None:
                obs.event("dispatch", t0, sid, len(task_ids))
                obs.batch_size.observe(len(task_ids))
            inflight.append((task_ids, results, t0))
            while len(inflight) >= self.client.max_inflight:
                if not self._drain_one(inflight):
                    crashed = True
                    break
            if crashed:
                break
        # results already dispatched to the device are valid even if the
        # service has since died — completing them beats re-running them
        # (failed drains fail their tasks back for re-lease)
        while inflight:
            if not self._drain_one(inflight):
                crashed = True
        self.client._thread_finished(self, crashed=crashed)

    def snapshot(self) -> dict:
        """Engine-level batching/compile telemetry for this thread's
        (service, job) binding — merged into the scheduler's per-service
        accumulator at exit (``FarmScheduler.stats()["batching"]``)."""
        return {
            **self.controller.stats(),
            "batches_dispatched": self.batches_dispatched,
            "cache_hits": self.handle.cache_hits,
            "cache_misses": self.handle.cache_misses,
        }
