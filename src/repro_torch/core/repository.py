"""The task repository — now a facade over N independently-locked shards.

The paper: *"Each control thread fetches tasks to be delivered to the remote
nodes from a centralized, synchronized task repository"* — pull-based
scheduling is what gives JJPF automatic load balancing, and keeping every
task on the client until its result arrives is what gives fault tolerance
("the task can be rescheduled as soon as the control thread understands that
the corresponding service node has been disconnected").

"Centralized" stops scaling once the NoW outgrows a rack: with 1,000
control threads every lease, completion, and expiry funnelled through ONE
lock and ONE pending deque, and that lock — not the arbiter, not the
clock — became the farm's last global serialization point (the failure
mode the EP-efficiency literature pins on a serialized task source).
Since the sharding work, :class:`TaskRepository` is a thin facade over
``shards`` independent :class:`RepositoryShard` s:

  * each shard owns its slice of the task records, its own pending deque,
    its own ``work``/``progress`` conditions, and its own
    :class:`~repro_torch.core.leases.LeaseTable` (deadline heap included) —
    two services leasing or completing *different* tasks never touch the
    same lock;
  * tasks are hashed to shards at ``add_tasks`` time (``task_id %
    shards``, so routing any task-keyed call is arithmetic, not a lookup
    table);
  * leasers are bound to a **home shard** (stable hash of the service
    id) and *work-steal* from sibling shards in ring order before
    parking on the home shard's condition — pull load balancing survives
    sharding because an idle service drains whichever shard still has
    work;
  * global reads (``stats()``, ``all_done``, ``unfinished()``, the
    ``wait_*`` predicates) aggregate the shards' event-time counters
    without any global lock — every counter is monotone and written
    under its shard's lock, so a lock-free sum is always a valid
    (momentarily conservative) snapshot;
  * ``expire_service``, ``cancel()``, ``close()`` and rate reports fan
    out per-shard.

``shards=1`` (the default) degenerates to exactly the pre-sharding
engine: one shard holding everything, the home shard is shard 0, the
steal ring is empty, and every wait/notify happens on the same
conditions in the same order — same-seed ``sim://`` lease traces are
byte-identical to the single-lock repository (gated by the golden-trace
test and the contention benchmark).

Extensions beyond the paper carried over unchanged (see DESIGN.md):
lease timeouts, speculative re-execution of stragglers (idempotent
``complete``, first result wins — across steals, expiry re-enqueues and
speculative duplicates alike), and batched leasing (``get_batch`` hands
a service up to N shape-compatible tasks in one round-trip; a batch may
span shards, each slice leased under its own shard's lock).

Every timestamp and every blocking wait goes through a
:class:`repro_torch.core.clock.Clock` (wall clock by default), which is what
lets the ``sim://`` backend run this exact code under a deterministic
virtual clock.  Waits are additionally capped at the next lease deadline
of the shard being parked on, so expiry is event-driven.  The lock-wait /
lock-hold meters intentionally use ``time.perf_counter`` (never the
clock seam): they profile *real* contention, which a virtual clock
serializes away by construction.
"""

from __future__ import annotations

import threading
import zlib
from collections import deque
from dataclasses import dataclass
from enum import Enum
from time import perf_counter
from typing import Any

from .clock import REAL_CLOCK
from .leases import LeaseTable


_UNSET = object()


class TaskState(Enum):
    PENDING = "pending"
    LEASED = "leased"
    DONE = "done"


@dataclass
class TaskRecord:
    task_id: int
    payload: Any
    state: TaskState = TaskState.PENDING
    result: Any = None
    attempts: int = 0
    completed_by: str | None = None
    group_key: Any = None  # memoized compatibility key (see get_batch)
    group_key_set: bool = False
    created_at: float = 0.0  # stamped only when telemetry is attached


class _LockMeter:
    """An RLock context manager that meters contention.

    Lock-*wait* time is measured only on the contended path (a failed
    non-blocking acquire), so the uncontended hot path pays one extra
    try-acquire and nothing else; lock-*hold* time costs two
    ``perf_counter`` reads per acquisition (~100 ns).  Both feed the
    repository's ``stats()`` and the contention benchmark.  Counters are
    plain ints/floats written while the lock is held (hold/acquisitions)
    or by the single acquiring thread (wait/contentions), so lock-free
    readers see monotone, never-corrupt values.
    """

    __slots__ = ("lock", "wait_s", "hold_s", "contentions", "acquisitions",
                 "_t_acq")

    def __init__(self):
        self.lock = threading.RLock()
        self.wait_s = 0.0
        self.hold_s = 0.0
        self.contentions = 0
        self.acquisitions = 0
        self._t_acq = 0.0

    def __enter__(self) -> "_LockMeter":
        if not self.lock.acquire(blocking=False):
            t0 = perf_counter()
            self.lock.acquire()
            self.wait_s += perf_counter() - t0
            self.contentions += 1
        self.acquisitions += 1
        self._t_acq = perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.hold_s += perf_counter() - self._t_acq
        self.lock.release()

    def pause_hold(self) -> None:
        """Close the current hold window before a ``cond_wait`` releases
        the lock inside a metered section — a park is idle time, not lock
        hold (pair with :meth:`resume_hold` after the wait returns)."""
        self.hold_s += perf_counter() - self._t_acq

    def resume_hold(self) -> None:
        self._t_acq = perf_counter()


class RepositoryShard:
    """One independently-locked slice of a repository's task state.

    Owns its records, pending deque, lease table, and a pair of
    conditions over ONE lock: ``_progress`` is the progress condition
    (completions, close, cancel — watched by ``wait_all`` /
    ``wait_until`` / streaming backpressure), ``_work`` is the leaser
    condition (new or re-enqueued tasks — watched by control threads
    parked here as their home shard).  Splitting them keeps a completion
    from waking N idle leasers who will find nothing.

    Shards never lock each other: every method here takes only this
    shard's lock, and the facade sequences cross-shard operations
    (steal scans, fan-outs, the exhaustion broadcast) as a series of
    independent single-shard steps.  Global flags (``_cancelled``,
    ``_closed``) and aggregate counters are read from the owning facade
    without a lock — they are monotone/terminal, so a stale read is at
    worst a one-iteration delay, never a correctness loss.
    """

    __slots__ = ("owner", "index", "_clock", "_obs", "meter", "_progress",
                 "_work", "records", "_pending", "leases", "done_count",
                 "leased_count", "reschedules", "_durations",
                 "completions_per_service")

    def __init__(self, owner: "TaskRepository", index: int, *, clock,
                 lease_s: float, speculation_factor: float,
                 straggler_rate_factor: float, on_lease, obs=None):
        self.owner = owner
        self.index = index
        self._clock = clock
        self._obs = obs  # Observability bundle or None (no telemetry)
        self.meter = _LockMeter()
        self._progress = threading.Condition(self.meter.lock)
        self._work = threading.Condition(self.meter.lock)
        self.records: dict[int, TaskRecord] = {}
        self._pending: deque[int] = deque()
        self.leases = LeaseTable(
            lease_s=lease_s, speculation_factor=speculation_factor,
            straggler_rate_factor=straggler_rate_factor, on_lease=on_lease)
        self.done_count = 0
        self.leased_count = 0
        self.reschedules = 0
        self._durations: list[float] = []
        self.completions_per_service: dict[str, int] = {}

    # ---------------- leasing ------------------------------------- #
    def _lease_locked(self, rec: TaskRecord, service_id: str,
                      now: float) -> None:
        rec.state = TaskState.LEASED
        rec.attempts += 1
        self.leased_count += 1
        self.leases.lease(rec.task_id, service_id, rec.attempts, now)

    def _expire_locked(self) -> None:
        """Re-enqueue leases past their deadline (the LeaseTable pops only
        the actually-expired heap prefix)."""
        obs = self._obs
        expired = None
        for tid in self.leases.expired(self._clock.monotonic()):
            rec = self.records[tid]
            if rec.state != TaskState.LEASED:
                continue
            rec.state = TaskState.PENDING
            self.leased_count -= 1
            self._pending.append(tid)
            self.reschedules += 1
            if obs is not None:
                if expired is None:
                    expired = []
                expired.append(tid)
        if expired:
            obs.event("expire", None, tuple(expired))

    def maybe_work(self, now: float) -> bool:
        """Lock-free peek: could this shard have a leasable task right
        now?  Reads the pending deque's truthiness and the deadline-heap
        head without the shard lock (GIL-atomic reads; lazy-deleted heap
        entries make the answer conservative) so a steal scan skips
        provably-empty sibling shards without touching their locks — at
        32 shards the scan would otherwise acquire 32 locks per wakeup.
        A stale True costs one harmless lock acquire; a stale False is
        corrected within one poll cap."""
        if self._pending:
            return True
        nd = self.leases.next_deadline()
        return nd is not None and nd <= now

    def try_lease_one(self, service_id: str):
        """Expire lapsed leases, then lease the next pending task.
        Returns ``(task_id, payload)`` or None if nothing is leasable."""
        with self.meter:
            self._expire_locked()
            while self._pending:
                tid = self._pending.popleft()
                rec = self.records[tid]
                if rec.state != TaskState.PENDING:
                    # stale queue entry: the task was re-enqueued by an
                    # expiry and then completed by its original owner
                    # before anyone re-leased it — leasing it again would
                    # re-run (and double-count) a DONE task
                    continue
                now = self._clock.monotonic()
                self._lease_locked(rec, service_id, now)
                obs = self._obs
                if obs is not None:
                    obs.queue_wait_s.observe(now - rec.created_at)
                    obs.event("lease", now, service_id,
                              ((tid, rec.attempts),))
                return tid, rec.payload
        return None

    def fill_batch(self, service_id: str, batch: list, max_batch: int,
                   compatible, group_key):
        """Expire, then move up to ``max_batch - len(batch)`` compatible
        pending tasks into ``batch`` under one lock hold; skipped tasks go
        back to the head in their original order.  Returns the (possibly
        newly established) group key so a batch can keep filling across
        sibling shards."""
        with self.meter:
            self._expire_locked()
            if not self._pending:
                return group_key
            now = self._clock.monotonic()
            obs = self._obs
            leased = None if obs is None else []
            oldest = now
            skipped: list[int] = []
            while self._pending and len(batch) < max_batch:
                tid = self._pending.popleft()
                rec = self.records[tid]
                if rec.state != TaskState.PENDING:
                    continue  # stale entry (see try_lease_one)
                if compatible is None:
                    key = None
                elif rec.group_key_set:
                    key = rec.group_key
                else:  # computed once per task, under the shard lock
                    key = rec.group_key = compatible(rec.payload)
                    rec.group_key_set = True
                if group_key is _UNSET:
                    group_key = key
                elif key != group_key:
                    skipped.append(tid)
                    continue
                self._lease_locked(rec, service_id, now)
                batch.append((tid, rec.payload))
                if leased is not None:
                    leased.append((tid, rec.attempts))
                    if rec.created_at < oldest:
                        oldest = rec.created_at
            # skipped tasks go back to the head, original order
            self._pending.extendleft(reversed(skipped))
            if leased:
                # one queue-wait sample per dispatch (the oldest task's
                # wait): a per-task observe here doubles the recorder's
                # hot-path cost for no extra scheduling signal
                obs.queue_wait_s.observe(now - oldest)
                obs.event("lease", now, service_id, tuple(leased))
        return group_key

    def try_speculate(self, service_id: str):
        """Issue a speculative duplicate of a straggler task owned by this
        shard, or None."""
        with self.meter:
            tid = self.leases.speculation_candidate(
                service_id, self._durations, self._clock.monotonic())
            if tid is None:
                return None
            rec = self.records[tid]
            rec.attempts += 1
            now = self._clock.monotonic()
            self.leases.issue_speculative(tid, service_id, rec.attempts,
                                          now)
            if self._obs is not None:
                self._obs.event("speculate", now, service_id, tid,
                                rec.attempts)
            return tid, rec.payload

    def park_leaser(self, remaining: float, next_deadline=_UNSET) -> None:
        """Block on this shard's work condition until notified, but never
        past the next lease deadline — expiry stays event-driven (the
        waiter that wakes at the deadline re-enqueues the lapsed lease
        itself on its next scan).  Unsharded, the deadline is this
        shard's own (read under the lock); sharded, the facade passes the
        lock-free minimum across ALL shards, since a sibling's expiry
        must also wake a parker whose home is idle."""
        with self.meter:
            if next_deadline is _UNSET:
                next_deadline = self.leases.next_deadline()
            if next_deadline is not None:
                # expired entries were popped on the last scan, so > 0
                remaining = min(
                    remaining,
                    max(next_deadline - self._clock.monotonic(), 1e-6))
            self.meter.pause_hold()
            try:
                self._clock.cond_wait(self._work, remaining)
            finally:
                self.meter.resume_hold()

    # ---------------- completion ----------------------------------- #
    def _record_done_locked(self, rec: TaskRecord, result, service_id: str,
                            now: float):
        owner = self.owner
        if rec.state == TaskState.LEASED:
            self.leased_count -= 1
        rec.state = TaskState.DONE
        rec.result = None if owner.reclaim_done else result
        if owner.reclaim_done:
            rec.payload = None
        rec.completed_by = service_id
        self.done_count += 1
        lease = self.leases.finish(rec.task_id)
        if lease is not None:
            self._durations.append(now - lease.start)
        self.completions_per_service[service_id] = (
            self.completions_per_service.get(service_id, 0) + 1)
        return lease

    def complete_some(self, results: list, service_id: str) -> list:
        """Record ``(task_id, result)`` pairs belonging to this shard
        under ONE lock hold; returns the pairs actually recorded
        (idempotent: first result wins, late/speculative duplicates and
        post-cancel results are dropped).  Completions wake progress
        watchers only — leasers parked in get_task/get_batch gain nothing
        from a task finishing, and waking all N of them per completion is
        the O(N²) herd.  The one completion they DO care about is the
        last one: it turns "wait for work" into "stream exhausted"
        (``exhausted`` in the return protocol: the facade broadcasts it
        to sibling shards outside this lock)."""
        owner = self.owner
        recorded: list[tuple[int, Any]] = []
        exhausted = False
        obs = self._obs
        spans = None if obs is None else []
        with self.meter:
            now = self._clock.monotonic()
            for task_id, result in results:
                rec = self.records[task_id]
                if rec.state == TaskState.DONE or owner._cancelled:
                    continue
                lease = self._record_done_locked(rec, result, service_id,
                                                 now)
                recorded.append((task_id, result))
                if spans is not None:
                    spans.append((task_id,
                                  now if lease is None else lease.start))
            if spans:
                # one lease-duration sample per completion batch: the
                # tasks of one drained dispatch were leased together, so
                # their starts coincide in the common case
                obs.lease_duration_s.observe(now - spans[0][1])
                obs.event("complete", now, service_id, tuple(spans))
            if recorded:
                owner._notify_progress_from(self)
                if owner._exhausted():
                    self._clock.cond_notify_all(self._work)
                    exhausted = True
        if exhausted:
            owner._broadcast_exhausted(exclude=self)
        return recorded

    # ---------------- rescheduling / teardown ----------------------- #
    def fail_one(self, task_id: int, service_id: str) -> None:
        owner = self.owner
        with self.meter:
            if owner._cancelled:
                self.leases.fail(task_id, service_id)
                return  # a cancelled stream never re-enqueues work
            rec = self.records[task_id]
            if (self.leases.fail(task_id, service_id)
                    and rec.state == TaskState.LEASED):
                rec.state = TaskState.PENDING
                self.leased_count -= 1
                self._pending.append(task_id)
                self.reschedules += 1
                if self._obs is not None:
                    self._obs.event("task-fail", None, service_id, task_id)
                self._notify_all_locked()

    def expire_service_shard(self, service_id: str) -> int:
        expired = 0
        with self.meter:
            for tid in self.leases.expire_service(service_id):
                rec = self.records[tid]
                if rec.state != TaskState.LEASED:
                    continue
                rec.state = TaskState.PENDING
                self.leased_count -= 1
                self._pending.append(tid)
                self.reschedules += 1
                expired += 1
            if expired:
                if self._obs is not None:
                    self._obs.event("expire-service", None, service_id,
                                    expired)
                self._notify_all_locked()
        return expired

    def report_rate_shard(self, service_id: str,
                          tasks_per_s: float) -> None:
        with self.meter:
            # wake waiters only when the straggler set actually changed
            # (a service just crossed the cutoff, either way) — rates are
            # reported once per drained batch, and an unconditional
            # notify here would double every batch's wakeup storm
            if self.leases.report_rate(service_id, tasks_per_s):
                self._notify_all_locked()

    def cancel_shard(self) -> int:
        """Terminal sweep (the facade already latched ``_cancelled``):
        drop pending work, clear leases, wake everyone.  Returns how many
        pending entries were dropped."""
        with self.meter:
            dropped = len(self._pending)
            self._pending.clear()
            # clear outstanding leases up front: their results (if any
            # arrive) are dropped by the guards in complete/fail, and a
            # cancelled repository must never read as holding leases
            self.leases.clear()
            if self.leased_count:
                for rec in self.records.values():
                    if rec.state == TaskState.LEASED:
                        rec.state = TaskState.PENDING
            self.leased_count = 0
            self._notify_all_locked()
            return dropped

    def add_records(self, recs: list) -> None:
        """Append freshly created records (facade assigned the ids) and
        wake this shard's leasers + progress watchers once."""
        with self.meter:
            for rec in recs:
                self.records[rec.task_id] = rec
                self._pending.append(rec.task_id)
            self._notify_all_locked()

    def notify_all_shard(self) -> None:
        """Wake everyone parked on this shard (close / exhaustion
        broadcast)."""
        with self.meter:
            self._notify_all_locked()

    def _notify_all_locked(self) -> None:
        """Wake leasers (``_work``) and progress watchers — for events
        that create leasable work or end the repository."""
        self._clock.cond_notify_all(self._work)
        self.owner._notify_progress_from(self)


class TaskRepository:
    """Thread-safe pull queue with leases, rescheduling and speculation —
    a facade over ``shards`` independently-locked :class:`RepositoryShard`
    slices (``shards=1``, the default, IS the pre-sharding single-lock
    repository, trace-for-trace)."""

    def __init__(self, tasks: list, *, lease_s: float = 30.0,
                 speculation_factor: float = 3.0, on_complete=None,
                 streaming: bool = False, clock=None, on_lease=None,
                 straggler_rate_factor: float = 0.5,
                 reclaim_done: bool = False, shards: int = 1, obs=None):
        if shards < 1:
            raise ValueError("shards must be >= 1")
        self._clock = clock if clock is not None else REAL_CLOCK
        self._obs = obs  # Observability bundle or None (no telemetry)
        self.on_complete = on_complete  # callable(task_id, result)
        self.streaming = streaming  # open-ended stream (futures / jobs)
        # drop payload+result from each record the moment it completes —
        # for unbounded streams whose results are consumed through
        # ``on_complete`` (farm jobs), so peak memory is the in-flight
        # window, not the whole stream.  ``results()`` is meaningless then.
        self.reclaim_done = reclaim_done
        self._closed = False
        self._cancelled = False
        self._on_lease = on_lease
        self._shards = [
            RepositoryShard(self, k, clock=self._clock, lease_s=lease_s,
                            speculation_factor=speculation_factor,
                            straggler_rate_factor=straggler_rate_factor,
                            on_lease=on_lease, obs=obs)
            for k in range(shards)]
        self.n_shards = shards
        # serializes task-id allocation (and add-vs-cancel) — held only
        # at add/cancel time, never on the lease/complete hot path
        self._add_lock = threading.Lock()
        #: global task-id -> record map (same objects the shards hold);
        #: append-only under _add_lock, read lock-free (GIL-safe)
        self.records: dict[int, TaskRecord] = {}
        self._n_added = 0
        self._home_cache: dict[str, int] = {}
        # progress watchers (wait_all / wait_until / backpressure): with
        # one shard they park on the shard's own progress condition — the
        # pre-sharding behavior exactly; with N shards they park on this
        # facade-level condition, which completing shards notify only
        # when someone is actually waiting (the waiter count) so the
        # common no-watcher case costs completions nothing
        self._progress_cond = (self._shards[0]._progress if shards == 1
                               else threading.Condition())
        self._progress_local = shards == 1
        self._progress_waiters = 0
        t_submit = 0.0 if obs is None else self._clock.monotonic()
        for i, t in enumerate(tasks):
            rec = TaskRecord(i, t, created_at=t_submit)
            self.records[i] = rec
            shard = self._shards[i % shards]
            shard.records[i] = rec
            shard._pending.append(i)
        self._n_added = len(tasks)
        if obs is not None and tasks:
            obs.event("task-submit", t_submit, len(tasks), 0)
        # high-water mark of unfinished tasks — the streaming-submission
        # backpressure metric; tracked at add time under _add_lock so
        # submitters pay no repository-lock round-trip for it
        self.peak_unfinished = len(tasks)

    # -- lease-policy pass-throughs (API compatibility) ---------------- #
    @property
    def lease_s(self) -> float:
        return self._shards[0].leases.lease_s

    @property
    def speculative_issues(self) -> int:
        return sum(s.leases.speculative_issues for s in self._shards)

    @property
    def straggler_speculations(self) -> int:
        return sum(s.leases.straggler_speculations for s in self._shards)

    @property
    def on_lease(self):
        return self._on_lease

    @property
    def leases(self) -> LeaseTable:
        """The lease table — only well-defined unsharded (shards=1);
        sharded repositories keep one table per shard (``shards_list``)."""
        if self.n_shards != 1:
            raise RuntimeError(
                "a sharded repository has one LeaseTable per shard; "
                "use repo.shards_list[k].leases")
        return self._shards[0].leases

    @property
    def shards_list(self) -> list:
        return self._shards

    # ---------------- routing -------------------------------------- #
    def _shard_of(self, task_id: int) -> RepositoryShard:
        return self._shards[task_id % self.n_shards]

    def _home_shard(self, service_id: str) -> int:
        home = self._home_cache.get(service_id)
        if home is None:
            # stable across runs/processes (hash() is salted): home-shard
            # binding is part of the deterministic lease schedule
            home = zlib.crc32(service_id.encode()) % self.n_shards
            self._home_cache[service_id] = home
        return home

    # ---------------- aggregate state ------------------------------- #
    def _done_total(self) -> int:
        return sum(s.done_count for s in self._shards)

    def _exhausted(self) -> bool:
        """Every added task is done and no more can arrive.  Lock-free:
        each shard's done counter is monotone and ``_n_added`` is frozen
        once the stream closes (the only time this can return True), so
        a racy sum can only under-count — never a false positive that
        matters."""
        if self.streaming and not self._closed:
            return False
        return self._done_total() == self._n_added

    def __len__(self) -> int:
        return self._n_added

    @property
    def all_done(self) -> bool:
        return self._cancelled or self._exhausted()

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def closed(self) -> bool:
        """True once the stream can no longer grow (non-streaming
        repositories are born closed)."""
        return self._closed or not self.streaming

    # ---------------- progress notification ------------------------- #
    def _notify_progress_from(self, shard: RepositoryShard) -> None:
        """Wake progress watchers; called UNDER ``shard``'s lock.  With
        one shard the progress condition IS the shard's own (notify in
        place — the pre-sharding behavior); with N the facade condition
        is notified only when a watcher is registered."""
        if self._progress_local:
            self._clock.cond_notify_all(shard._progress)
        elif self._progress_waiters:
            with self._progress_cond:
                self._clock.cond_notify_all(self._progress_cond)

    def _broadcast_exhausted(self, exclude: RepositoryShard) -> None:
        """The last task just completed: wake leasers parked on every
        OTHER shard so they observe exhaustion now instead of sleeping
        out their poll cap (the completing shard already notified its
        own)."""
        for shard in self._shards:
            if shard is not exclude:
                with shard.meter:
                    self._clock.cond_notify_all(shard._work)

    # ---------------- stream lifecycle ------------------------------ #
    def close(self) -> None:
        """End a streaming repository: no more tasks will be added."""
        self._closed = True
        for shard in self._shards:
            shard.notify_all_shard()

    def cancel(self) -> int:
        """Terminal, idempotent: drop every pending task, stop handing out
        work, and make ``all_done`` True so pulling control threads (and
        anyone in ``wait_all``) unwind.  Tasks already leased keep their
        records but their results are dropped on arrival (``complete``
        returns False) and their leases can never re-enqueue — a cancelled
        repository cannot leak work back into the farm.  Fans out
        per-shard.  Returns how many pending tasks were dropped."""
        with self._add_lock:
            if self._cancelled:
                return 0
            self._cancelled = True
            self._closed = True
        dropped = sum(shard.cancel_shard() for shard in self._shards)
        if self._obs is not None:
            self._obs.event("cancel", None, dropped)
        return dropped

    def add_task(self, payload) -> int:
        """Streams can grow while the farm runs."""
        return self.add_tasks([payload])[0]

    def add_tasks(self, payloads: list) -> list[int]:
        """Register a whole batch of tasks under ONE lock acquisition per
        *touched shard* and ONE notify each — streaming submitters
        (``FarmExecutor.map``, ``Job.add_tasks``) were paying a lock
        round-trip per task.  Ids are allocated under the add lock and
        hashed to shards (``tid % shards``)."""
        with self._add_lock:
            if self._cancelled:
                raise RuntimeError("cannot add tasks: repository cancelled")
            n = self.n_shards
            base = self._n_added
            tids = []
            obs = self._obs
            t_submit = 0.0 if obs is None else self._clock.monotonic()
            per_shard: list[list] = [[] for _ in range(n)]
            for i, payload in enumerate(payloads):
                tid = base + i
                rec = TaskRecord(tid, payload, created_at=t_submit)
                self.records[tid] = rec
                per_shard[tid % n].append(rec)
                tids.append(tid)
            self._n_added = base + len(tids)
            if obs is not None and tids:
                obs.event("task-submit", t_submit, len(tids), base)
            for k, recs in enumerate(per_shard):
                if recs:
                    self._shards[k].add_records(recs)
            unfinished = self._n_added - self._done_total()
            if unfinished > self.peak_unfinished:
                self.peak_unfinished = unfinished
            return tids

    def unfinished(self) -> int:
        """Tasks added but not yet completed (pending + leased)."""
        return self._n_added - self._done_total()

    def wait_unfinished_below(self, n: int, *, timeout: float | None = None
                              ) -> bool:
        """Block until fewer than ``n`` tasks are unfinished — the
        backpressure wait for streaming submitters (``Job.submit_stream``):
        a feeder sleeps here instead of materializing an unbounded task
        source.  Event-driven (completions notify the progress
        condition); returns False on timeout or if the repository is
        cancelled meanwhile."""
        deadline = (None if timeout is None
                    else self._clock.monotonic() + timeout)
        with self._progress_cond:
            self._progress_waiters += 1
            try:
                while self._n_added - self._done_total() >= n:
                    if self._cancelled:
                        return False
                    remaining = (None if deadline is None
                                 else deadline - self._clock.monotonic())
                    if remaining is not None and remaining <= 0:
                        return False
                    self._clock.cond_wait(
                        self._progress_cond,
                        min(remaining, 0.5) if remaining is not None
                        else 0.5)
                return not self._cancelled
            finally:
                self._progress_waiters -= 1

    # ---------------- leasing --------------------------------------- #
    def get_task(self, service_id: str, *, timeout: float = 0.5,
                 allow_speculation: bool = True):
        """Lease the next pending task (or a speculative copy of a
        straggler).  Scans the home shard first, then steals from sibling
        shards in ring order; parks on the home shard when nothing is
        leasable anywhere.  Returns (task_id, payload) or None if the
        stream is exhausted (all tasks done) — a None with ``all_done``
        False means "try again" (everything currently leased)."""
        deadline = self._clock.monotonic() + timeout
        shards = self._shards
        n = self.n_shards
        home = self._home_shard(service_id)
        while True:
            if self._cancelled:
                return None
            if n == 1:  # the pre-sharding path, lock-for-lock
                got = shards[0].try_lease_one(service_id)
                if got is not None:
                    return got
            else:
                now = self._clock.monotonic()
                for k in range(n):
                    shard = shards[(home + k) % n]
                    if shard.maybe_work(now):
                        got = shard.try_lease_one(service_id)
                        if got is not None:
                            if k and self._obs is not None:
                                self._obs.event("steal", None, service_id,
                                                shard.index, home)
                            return got
            if self._exhausted():
                return None
            if allow_speculation:
                for k in range(n):
                    shard = shards[(home + k) % n]
                    if n > 1 and not len(shard.leases):
                        continue  # lock-free: nothing leased, nothing to
                        # speculate on (stale reads self-correct next loop)
                    got = shard.try_speculate(service_id)
                    if got is not None:
                        return got
            remaining = deadline - self._clock.monotonic()
            if remaining <= 0:
                return None
            self._park(shards[home], remaining)

    def _park(self, home_shard: RepositoryShard, remaining: float) -> None:
        """Park a leaser on its home shard.  Sharded, the wait cap is the
        lock-free minimum deadline across ALL shards (a sibling's lease
        expiring must wake a parker whose own shard is idle — nobody
        notifies on expiry)."""
        if self.n_shards == 1:
            home_shard.park_leaser(remaining)
            return
        hint = None
        for s in self._shards:
            nd = s.leases.next_deadline()
            if nd is not None and (hint is None or nd < hint):
                hint = nd
        home_shard.park_leaser(remaining, hint)

    def get_batch(self, service_id: str, max_batch: int, *,
                  timeout: float = 0.5, allow_speculation: bool = True,
                  compatible=None):
        """Lease up to ``max_batch`` *compatible* pending tasks at once.

        ``compatible`` maps a payload to a hashable group key (e.g.
        :func:`repro_torch.core.batching.payload_signature`); only tasks sharing
        the key of the first pending task are leased together, the rest
        stay pending in their original order.  ``None`` treats every task
        as compatible.  A batch fills from the home shard first and keeps
        filling from sibling shards (same group key) until full.

        Returns a non-empty list of ``(task_id, payload)`` pairs, or
        ``None`` with the same contract as :meth:`get_task` (exhausted, or
        nothing leasable before the timeout).  When nothing is pending but
        a straggler qualifies, returns a singleton speculative batch."""
        if max_batch <= 1:
            got = self.get_task(service_id, timeout=timeout,
                                allow_speculation=allow_speculation)
            return None if got is None else [got]
        deadline = self._clock.monotonic() + timeout
        shards = self._shards
        n = self.n_shards
        home = self._home_shard(service_id)
        while True:
            if self._cancelled:
                return None
            batch: list = []
            group_key: Any = _UNSET  # `compatible` may return None
            if n == 1:  # the pre-sharding path, lock-for-lock
                shards[0].fill_batch(service_id, batch, max_batch,
                                     compatible, group_key)
            else:
                now = self._clock.monotonic()
                for k in range(n):
                    shard = shards[(home + k) % n]
                    if shard.maybe_work(now):
                        filled = len(batch)
                        group_key = shard.fill_batch(
                            service_id, batch, max_batch, compatible,
                            group_key)
                        if k and self._obs is not None \
                                and len(batch) > filled:
                            self._obs.event("steal", None, service_id,
                                            shard.index, home)
                        if len(batch) >= max_batch:
                            break
            if batch:
                return batch
            if self._exhausted():
                return None
            if allow_speculation:
                for k in range(n):
                    shard = shards[(home + k) % n]
                    if n > 1 and not len(shard.leases):
                        continue  # see get_task
                    got = shard.try_speculate(service_id)
                    if got is not None:
                        return [got]
            remaining = deadline - self._clock.monotonic()
            if remaining <= 0:
                return None
            self._park(shards[home], remaining)

    def report_rate(self, service_id: str, tasks_per_s: float | None) -> None:
        """Control threads report observed per-service throughput here
        (the AIMD controller's EWMA); it feeds straggler detection —
        the heterogeneity-aware arm of speculation.  Fans out to every
        shard: the service may hold (or speculate on) leases anywhere."""
        if tasks_per_s is None:
            return
        for shard in self._shards:
            shard.report_rate_shard(service_id, tasks_per_s)

    # ---------------- completion ------------------------------------ #
    def complete(self, task_id: int, result, service_id: str) -> bool:
        """Idempotent: the first result wins (speculative duplicates are
        dropped).  Returns True if this call recorded the result."""
        recorded = self._shard_of(task_id).complete_some(
            [(task_id, result)], service_id)
        if not recorded:
            return False
        if self.on_complete is not None:
            self.on_complete(task_id, result)
        return True

    def complete_batch(self, results: list, service_id: str) -> int:
        """Record a batch of ``(task_id, result)`` pairs under ONE lock
        acquisition *per touched shard* and ONE notify each — with
        batched dispatch, per-task ``complete`` calls made the repository
        lock the next bottleneck.  Returns how many results were recorded
        (idempotent like ``complete``)."""
        n = self.n_shards
        if n == 1:
            recorded = self._shards[0].complete_some(results, service_id)
        else:
            per_shard: dict[int, list] = {}
            for pair in results:
                per_shard.setdefault(pair[0] % n, []).append(pair)
            recorded = []
            for k, chunk in per_shard.items():
                recorded.extend(
                    self._shards[k].complete_some(chunk, service_id))
        if self.on_complete is not None:
            for task_id, result in recorded:
                self.on_complete(task_id, result)
        return len(recorded)

    def fail(self, task_id: int, service_id: str) -> None:
        """A service died / errored mid-task: reschedule (the paper's natural
        descheduling point is the task start, so we simply re-enqueue)."""
        self._shard_of(task_id).fail_one(task_id, service_id)

    def expire_service(self, service_id: str) -> int:
        """Heartbeat-declared death: expire every lease held (solely) by
        ``service_id`` *now* instead of waiting out the lease deadline.
        This is the LivenessMonitor -> lease machinery hook; fans out
        per-shard; returns the number of tasks re-enqueued."""
        if self._cancelled:
            return 0
        return sum(shard.expire_service_shard(service_id)
                   for shard in self._shards)

    # ---------------- waits ------------------------------------------ #
    def wait_all(self, timeout: float | None = None) -> bool:
        deadline = (None if timeout is None
                    else self._clock.monotonic() + timeout)
        with self._progress_cond:
            self._progress_waiters += 1
            try:
                while self._done_total() < self._n_added:
                    if self._cancelled:
                        return True  # terminal: nothing left to wait for
                    remaining = (None if deadline is None
                                 else deadline - self._clock.monotonic())
                    if remaining is not None and remaining <= 0:
                        return False
                    self._clock.cond_wait(
                        self._progress_cond,
                        remaining if remaining is not None else 1.0)
                return True
            finally:
                self._progress_waiters -= 1

    def wait_until(self, predicate, timeout: float | None = None) -> bool:
        """Event-driven wait for an arbitrary progress condition:
        ``predicate(stats_dict)`` is re-evaluated on every repository
        state change (completions, reschedules, leases expiring).  Tests
        use this instead of sleep-polling loops — under load the wait
        stretches, but it can never miss the event or flake."""
        deadline = (None if timeout is None
                    else self._clock.monotonic() + timeout)
        with self._progress_cond:
            self._progress_waiters += 1
            try:
                while not predicate(self._stats_aggregate()):
                    remaining = (None if deadline is None
                                 else deadline - self._clock.monotonic())
                    if remaining is not None and remaining <= 0:
                        return False
                    self._clock.cond_wait(
                        self._progress_cond,
                        min(remaining, 0.5) if remaining is not None
                        else 0.5)
                return True
            finally:
                self._progress_waiters -= 1

    def results(self) -> list:
        return [self.records[i].result for i in sorted(self.records)]

    # ---------------- introspection ---------------------------------- #
    def _stats_aggregate(self) -> dict:
        # every figure here is a counter maintained at event time under
        # its shard's lock and read lock-free — this snapshot is
        # O(shards × services), never O(tasks), and never blocks a
        # lease/complete anywhere
        shards = self._shards
        done = sum(s.done_count for s in shards)
        leased = sum(s.leased_count for s in shards)
        per_service: dict[str, int] = {}
        service_rates: dict[str, float] = {}
        for s in shards:
            for sid, c in s.completions_per_service.items():
                per_service[sid] = per_service.get(sid, 0) + c
            service_rates.update(s.leases._service_rates)
        return {
            "tasks": self._n_added,
            "done": done,
            "cancelled": self._cancelled,
            # derived, not len(_pending): the queues may briefly hold
            # stale entries for tasks that completed between expiry and
            # re-lease (a cancelled repository reads 0 — its queues are
            # dropped even though interrupted records sit in PENDING)
            "pending": (0 if self._cancelled
                        else self._n_added - done - leased),
            "leased": leased,
            "reschedules": sum(s.reschedules for s in shards),
            "peak_unfinished": self.peak_unfinished,
            "speculative_issues": sum(
                s.leases.speculative_issues for s in shards),
            "straggler_speculations": sum(
                s.leases.straggler_speculations for s in shards),
            "service_rates": service_rates,
            "per_service": per_service,
            "shards": self.n_shards,
            **self.lock_stats(),
        }

    def lock_stats(self) -> dict:
        """Aggregated shard-lock contention meters (real time, even under
        a virtual clock — see the module docstring)."""
        meters = [s.meter for s in self._shards]
        return {
            "lock_wait_s": sum(m.wait_s for m in meters),
            "lock_hold_s": sum(m.hold_s for m in meters),
            "lock_contentions": sum(m.contentions for m in meters),
            "lock_acquisitions": sum(m.acquisitions for m in meters),
        }

    def stats(self) -> dict:
        return self._stats_aggregate()
