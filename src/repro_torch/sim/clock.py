"""VirtualClock: a deterministic cooperative scheduler for the farm stack.

The whole point of the ``sim://`` backend is that it drives the *real*
runtime — ``TaskRepository`` leases, ``ControlThread`` AIMD dispatch,
``LivenessMonitor`` heartbeats — not a parallel reimplementation.  Those
components are genuinely multi-threaded, and thread interleavings are the
one source of nondeterminism no seed can fix.  The virtual clock removes
it by construction:

**Exactly one enrolled thread runs at a time.**  Every enrolled thread
eventually blocks through the clock (a virtual ``sleep``, a condition
wait with timeout, an event wait); at that moment it parks itself and
hands the *run token* to the parked thread with the earliest virtual wake
time, advancing virtual time to that instant.  Ties are broken by the
thread's stable name + spawn-incarnation, never by OS scheduling, so the
same seed and the same fault/speed schedule produce the identical
interleaving — and therefore the identical task-to-service assignment
trace — on every run.

Real time spent while a thread holds the token (program runs, tensor work)
is invisible to the schedule: ordering decisions depend only on virtual
timestamps.  That is what lets a 90-virtual-second heterogeneous-NoW
experiment finish in milliseconds of wall time and still be
bit-reproducible.

Enrollment protocol (see :class:`repro_torch.core.clock.Clock`):

- a spawner calls ``thread_spawned(thread)`` *before* ``thread.start()``
  so the scheduler knows the thread exists before anyone else parks
  (otherwise whether the new thread is considered runnable would depend
  on a startup race);
- the thread's ``run`` calls ``thread_attach()`` first and
  ``thread_retire()`` in a ``finally``;
- the main thread enters with ``adopt_current()`` and, before leaving the
  simulation, calls ``drain()`` — a special park with no wake time that
  is only scheduled once every other thread has retired (it lets
  stragglers such as a silently-hung service call finish their virtual
  sleeps).

A thread that blocks *outside* the clock while holding the token would
freeze the simulation; every enrolled wait therefore carries a real-time
stall watchdog (``stall_timeout_s``) that raises instead of hanging CI.

Scheduling cost: token hand-offs are the inner loop of every simulation
(one per virtual sleep/wait), so the scheduler keeps a lazy-deletion
min-heap of ``(effective wake, key)`` entries instead of scanning every
enrolled waiter per hand-off, and an object index for notify/set instead
of scanning every waiter for a matching ``obj``.  Both are O(log N) /
O(matched) where the old scans were O(enrolled threads) — the difference
between a 4-service sim and a 1,000-service one.  Stale heap entries
(re-park, ready-mark, retire) are invalidated by a per-waiter generation
counter and skipped on pop; the selection order — min ``(effective wake,
stable key)`` — is identical to the old full scan, so traces are
byte-for-byte unchanged.
"""

from __future__ import annotations

import heapq
import threading
from collections import defaultdict, deque

from repro_torch.core.clock import Clock


class _Waiter:
    __slots__ = ("key", "event", "parked", "wake", "obj", "ready", "ident",
                 "gen")

    def __init__(self, key: tuple):
        self.key = key                    # (thread name, incarnation)
        self.event = threading.Event()    # run-token grant
        self.parked = False
        self.wake: float | None = None    # virtual wake time (None = drain)
        self.obj = None                   # condition/event being waited on
        self.ready = False                # woken by notify/set, not timeout
        self.ident: int | None = None     # OS thread id, bound at attach
        self.gen = 0                      # heap-entry generation (lazy del)


class VirtualClock(Clock):
    """Deterministic discrete-event clock with cooperative run-token
    scheduling.  ``seed`` does not feed the scheduler itself (ordering is
    fully determined by wake times and stable thread keys); it is carried
    here so simulation components can derive their RNG streams from one
    place."""

    virtual = True

    def __init__(self, *, seed: int = 0, stall_timeout_s: float = 60.0):
        self.seed = seed
        self.stall_timeout_s = stall_timeout_s
        self._mutex = threading.Lock()
        self._now = 0.0
        self._waiters: dict[tuple, _Waiter] = {}
        self._by_ident: dict[int, _Waiter] = {}
        self._pending: dict[str, deque] = defaultdict(deque)  # spawned, unattached
        self._incarnations: dict[str, int] = defaultdict(int)
        self._running: _Waiter | None = None
        # lazy-deletion scheduling heap: (effective wake, key, gen, waiter);
        # an entry is live iff the waiter is still parked with that gen.
        # Parked non-ready waiters always satisfy wake >= _now (time only
        # advances to the minimum effective wake), and ready-marks push a
        # fresh entry at _now, so heap order == the old scan's
        # min(effective wake, key) selection exactly.
        self._heap: list[tuple[float, tuple, int, _Waiter]] = []
        # obj -> waiters parked on that condition/event (for notify/set)
        self._by_obj: dict[object, set[_Waiter]] = {}

    # ------------------------------------------------------------- #
    # scheduling core
    # ------------------------------------------------------------- #
    def _push_locked(self, w: _Waiter, eff: float) -> None:
        w.gen += 1
        heapq.heappush(self._heap, (eff, w.key, w.gen, w))

    def _mark_ready_locked(self, w: _Waiter) -> None:
        if not w.parked or w.ready:
            return
        w.ready = True
        self._push_locked(w, self._now)  # supersedes the timeout entry

    def _unpark_locked(self, w: _Waiter) -> None:
        w.parked = False
        w.ready = False
        w.gen += 1  # invalidate any heap entries still referencing w
        if w.obj is not None:
            peers = self._by_obj.get(w.obj)
            if peers is not None:
                peers.discard(w)
                if not peers:
                    del self._by_obj[w.obj]
            w.obj = None

    def _schedule_locked(self) -> None:
        """Grant the run token to the parked waiter with the earliest
        virtual wake (stable-key tie-break); advance time to it."""
        if self._running is not None:
            return
        best = None
        while self._heap:
            eff, _key, gen, w = self._heap[0]
            if not w.parked or w.gen != gen:
                heapq.heappop(self._heap)  # stale (re-parked/retired/ready)
                continue
            heapq.heappop(self._heap)
            best, best_eff = w, eff
            break
        if best is None:  # only drain sentinels (or nobody) left
            for w in self._waiters.values():
                if w.parked and w.wake is None:
                    best = w
                    break
            if best is None:
                return
            # a drain park never advances time
        else:
            self._now = max(self._now, best_eff)
        self._unpark_locked(best)
        self._running = best
        best.event.set()

    def _me(self) -> _Waiter:
        w = self._by_ident.get(threading.get_ident())
        if w is None:
            raise RuntimeError(
                "thread %r touched a VirtualClock without enrolling "
                "(thread_spawned/thread_attach or adopt_current first)"
                % threading.current_thread().name)
        return w

    def _park(self, wake: float | None, obj=None) -> None:
        me = self._me()
        with self._mutex:
            if self._running is not me:
                raise RuntimeError(
                    f"thread {me.key} parked without holding the run token")
            me.parked = True
            me.wake = wake
            me.obj = obj
            me.ready = False
            if obj is not None:
                self._by_obj.setdefault(obj, set()).add(me)
            if wake is not None:
                self._push_locked(me, max(wake, self._now))
            self._running = None
            self._schedule_locked()
        if not me.event.wait(self.stall_timeout_s):
            raise RuntimeError(
                f"virtual clock stalled for {self.stall_timeout_s}s of real "
                f"time waiting to schedule {me.key} (an enrolled thread is "
                f"blocking outside the clock, or every thread retired)")
        me.event.clear()

    # ------------------------------------------------------------- #
    # Clock interface
    # ------------------------------------------------------------- #
    def monotonic(self) -> float:
        with self._mutex:
            return self._now

    def sleep(self, seconds: float) -> None:
        with self._mutex:
            wake = self._now + max(seconds, 0.0)
        self._park(wake)

    def cond_wait(self, cond: threading.Condition, timeout: float) -> None:
        if timeout is None:
            timeout = 3600.0  # virtual waits must be finite; 1h is "forever"
        with self._mutex:
            wake = self._now + max(timeout, 0.0)
        cond.release()
        try:
            self._park(wake, obj=cond)
        finally:
            cond.acquire()

    def cond_notify_all(self, cond: threading.Condition) -> None:
        with self._mutex:
            for w in tuple(self._by_obj.get(cond, ())):
                self._mark_ready_locked(w)
        cond.notify_all()  # harmless; covers any unmanaged raw waiter

    def event_wait(self, event: threading.Event, timeout: float) -> bool:
        if event.is_set():
            return True
        with self._mutex:
            wake = self._now + max(timeout, 0.0)
        self._park(wake, obj=event)
        return event.is_set()

    def event_set(self, event: threading.Event) -> None:
        event.set()
        with self._mutex:
            for w in tuple(self._by_obj.get(event, ())):
                self._mark_ready_locked(w)

    # ------------------------------------------------------------- #
    # thread lifecycle
    # ------------------------------------------------------------- #
    def thread_spawned(self, thread: threading.Thread) -> None:
        with self._mutex:
            name = thread.name
            inc = self._incarnations[name]
            self._incarnations[name] = inc + 1
            w = _Waiter((name, inc))
            w.parked = True
            w.ready = True  # runnable as soon as the scheduler reaches it
            w.wake = self._now
            self._push_locked(w, self._now)
            self._waiters[w.key] = w
            self._pending[name].append(w)

    def thread_attach(self) -> None:
        name = threading.current_thread().name
        with self._mutex:
            queue = self._pending.get(name)
            if not queue:
                raise RuntimeError(
                    f"thread {name!r} attached without thread_spawned")
            w = queue.popleft()
            w.ident = threading.get_ident()
            self._by_ident[w.ident] = w
            if self._running is None:
                # nothing holds the token (fresh clock, or every enrolled
                # thread retired before we attached): elect a runner now
                self._schedule_locked()
        # wait for the run token (may already have been granted)
        if not w.event.wait(self.stall_timeout_s):
            raise RuntimeError(
                f"virtual clock stalled granting first run to {w.key}")
        w.event.clear()

    def thread_retire(self) -> None:
        me = self._me()
        with self._mutex:
            self._waiters.pop(me.key, None)
            self._by_ident.pop(me.ident, None)
            if self._running is me:
                self._running = None
            self._schedule_locked()

    def adopt_current(self) -> None:
        t = threading.current_thread()
        self.thread_spawned(t)
        self.thread_attach()

    def drain(self) -> None:
        """Park with no wake time until every other enrolled thread has
        retired (each gets scheduled, runs its remaining virtual waits,
        and exits); returns with the caller as the sole enrolled thread."""
        me = self._me()
        while True:
            with self._mutex:
                if all(w is me for w in self._waiters.values()):
                    return
            self._park(None)

    # ------------------------------------------------------------- #
    def stats(self) -> dict:
        with self._mutex:
            return {
                "now": self._now,
                "enrolled": sorted("%s#%d" % k for k in self._waiters),
                "running": None if self._running is None
                else "%s#%d" % self._running.key,
            }
