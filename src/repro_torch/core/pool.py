"""ServicePool: recruited-pool membership for the dispatch engine.

Before the engine unification, three front-ends each carried their own
copy of this lifecycle (recruit → watch → heartbeat-monitor → release
exactly once → clock-aware reaping).  Now there is one: the
``repro_torch.farm`` scheduler owns a :class:`ServicePool`, and every
front-end (``BasicClient``, ``FarmExecutor``, ``FarmScheduler`` itself)
goes through it.

The pool keeps Jini's Algorithm 2 contract: a recruited service is
*unregistered* from the lookup for exactly as long as one engine holds
it, and :meth:`release_all` hands every handle back **exactly once**
(pop-then-release — a control thread that exits concurrently finds its
handle already popped and releases nothing).

Concurrency: the pool does not lock for itself — it is constructed with
its owner's re-entrant lock and every mutation happens under it, so the
owner's callbacks (``on_join``/``on_dead``/``on_lost``) can safely
re-enter owner state without a second lock (and without lock-order
inversions between pool and owner).  Lookup observer callbacks and
LivenessMonitor verdicts take the same lock before touching the pool.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable

from .clock import REAL_CLOCK
from .discovery import LookupService, ServiceDescriptor
from .transport import LivenessMonitor, ServiceHandle, resolve_handle

_EPS = 1e-9


def clock_join(clock, threads: Iterable[threading.Thread],
               grace_s: float) -> None:
    """Clock-aware reaping: wait (up to ``grace_s``) for control threads
    to exit, polling through the clock seam.  A raw ``Thread.join`` would
    deadlock a :class:`~repro_torch.sim.VirtualClock`'s cooperative scheduler;
    ``clock.sleep`` keeps the join deterministic under simulation and is
    an ordinary poll on the real clock."""
    deadline = clock.monotonic() + grace_s
    for t in threads:
        while t.is_alive() and clock.monotonic() < deadline:
            clock.sleep(0.02)


class ServicePool:
    """The engine's recruited services: membership only, no dispatch.

    ``admit``
        optional predicate ``(descriptor) -> bool`` consulted before any
        recruitment (both the synchronous sweep in :meth:`open` and the
        asynchronous subscribe path) — the hook performance contracts
        (``ParDegreeContract``) cap recruitment through.
    ``on_join``
        ``(service_id, handle)`` after a successful recruit, under the
        owner lock — the scheduler rebalances here.
    ``on_dead``
        ``(service_id)`` when the LivenessMonitor declares a watched
        handle dead; called WITHOUT the owner lock held by the monitor
        thread (the owner takes its lock, then typically calls
        :meth:`forget`).
    ``on_lost``
        ``(service_id)`` when a service the pool never recruited leaves
        the lookup (a rival client got there first, or the node died
        pre-recruitment), under the owner lock.
    """

    def __init__(self, lookup: LookupService, *, lock: threading.RLock,
                 clock=None, client_id: str = "pool",
                 admit: Callable[[ServiceDescriptor], bool] | None = None,
                 obs=None,
                 on_join: Callable[[str, ServiceHandle], None] | None = None,
                 on_dead: Callable[[str], None] | None = None,
                 on_lost: Callable[[str], None] | None = None):
        self.lookup = lookup
        self.clock = clock if clock is not None else REAL_CLOCK
        self.client_id = client_id
        self.admit = admit
        # telemetry bundle stamped onto recruited handles so transports
        # can record frame/reconnect/shm events (None = no telemetry)
        self.obs = obs
        self.on_join = on_join
        self.on_dead = on_dead
        self.on_lost = on_lost
        self._lock = lock
        self._stopped = False
        self._unsubscribe = None
        self._monitor: LivenessMonitor | None = None
        self._handles: dict[str, ServiceHandle] = {}
        self._speed: dict[str, float] = {}
        # membership-derived views (sorted ids, capacities) are cached and
        # invalidated on join/forget/release: the scheduler reads them on
        # every rebalance, and rebuilding a 1,000-entry sorted list (or a
        # dict of divisions) per event is exactly the per-event O(S) cost
        # the incremental arbiter exists to avoid
        self._version = 0
        self._ids_cache: list[str] | None = None
        self._caps_cache: dict[str, float] | None = None

    def _membership_changed_locked(self) -> None:
        self._version += 1
        self._ids_cache = None
        self._caps_cache = None

    # ---------------- membership ----------------------------------- #
    def open(self, *, elastic: bool = True) -> None:
        """Recruit everything currently registered; with ``elastic``
        (default) also subscribe for services that register later.
        Idempotent."""
        with self._lock:
            if self._stopped:
                return
            if elastic and self._unsubscribe is None:
                self._unsubscribe = self.lookup.subscribe(
                    self._on_register, self._on_unregister)
            for desc in self.lookup.query():
                self.recruit(desc)

    def _on_register(self, desc: ServiceDescriptor) -> None:
        with self._lock:
            if self._stopped:
                return
            self.recruit(desc)

    def _on_unregister(self, service_id: str) -> None:
        # only meaningful for services we never managed to recruit (our
        # own recruits unregister as part of claiming them)
        with self._lock:
            if self._stopped or service_id in self._handles:
                return
            if self.on_lost is not None:
                self.on_lost(service_id)

    def recruit(self, desc: ServiceDescriptor) -> bool:
        """Resolve + claim one service; enters the pool and fires
        ``on_join``.  Caller-safe under or outside the owner lock."""
        with self._lock:
            if self._stopped:
                return False
            sid = desc.service_id
            if sid in self._handles:
                return True
            if self.admit is not None and not self.admit(desc):
                return False
            handle = resolve_handle(desc, lookup=self.lookup)
            if handle is None:  # stale registration (endpoint already gone)
                return False
            if self.obs is not None:
                handle.obs = self.obs
            # enter the map before recruiting: recruit() unregisters the
            # service from the lookup, and _on_unregister must see it as
            # ours rather than report it lost
            self._handles[sid] = handle
            if not handle.recruit(self.client_id):
                del self._handles[sid]
                handle.close()
                return False
            self._speed[sid] = max(
                float(handle.capabilities.get("speed_factor") or 1.0), _EPS)
            self._membership_changed_locked()
            if handle.needs_heartbeat:
                if self._monitor is None:
                    self._monitor = LivenessMonitor(clock=self.clock)
                self._monitor.watch(handle, self._declared_dead)
            if self.on_join is not None:
                self.on_join(sid, handle)
            return True

    def _declared_dead(self, service_id: str) -> None:
        # LivenessMonitor verdict (monitor thread, no owner lock held)
        if self.on_dead is not None:
            self.on_dead(service_id)

    def forget(self, service_id: str) -> bool:
        """Drop a dead service: close the handle, stop heartbeating it,
        never release (there is nothing to hand back).  Returns True if
        the service was in the pool."""
        with self._lock:
            handle = self._handles.pop(service_id, None)
            if handle is None:
                return False
            self._speed.pop(service_id, None)
            self._membership_changed_locked()
            if self._monitor is not None and handle.needs_heartbeat:
                self._monitor.unwatch(service_id)
            handle.close()
            return True

    # ---------------- teardown ------------------------------------- #
    def stop_recruiting(self) -> None:
        """No new members: drop the lookup subscription and refuse
        further recruits (the first phase of engine shutdown)."""
        with self._lock:
            self._stopped = True
            unsubscribe, self._unsubscribe = self._unsubscribe, None
        if unsubscribe is not None:
            unsubscribe()

    def stop_monitor(self) -> None:
        with self._lock:
            monitor, self._monitor = self._monitor, None
        if monitor is not None:
            monitor.stop()

    def release_all(self) -> None:
        """Hand every recruited service back to the lookup, exactly once
        (Algorithm 2's while-loop: serve one engine, re-register).
        Pop-then-release: anything racing this (a control thread exiting,
        a second release_all) finds the map already empty."""
        with self._lock:
            handles = list(self._handles.values())
            self._handles.clear()
            self._speed.clear()
            self._membership_changed_locked()
        for h in handles:
            try:
                h.release()
            except Exception:
                pass  # release is an RPC on proc://; a dead peer is fine
            h.close()

    # ---------------- introspection -------------------------------- #
    def __len__(self) -> int:
        with self._lock:
            return len(self._handles)

    def __contains__(self, service_id: str) -> bool:
        with self._lock:
            return service_id in self._handles

    def handle(self, service_id: str) -> ServiceHandle | None:
        with self._lock:
            return self._handles.get(service_id)

    def ids(self) -> list[str]:
        """Sorted service ids; the returned list is a membership-keyed
        cache — treat it as immutable."""
        with self._lock:
            if self._ids_cache is None:
                self._ids_cache = sorted(self._handles)
            return self._ids_cache

    def speed(self, service_id: str) -> float:
        with self._lock:
            return self._speed.get(service_id, 1.0)

    def version(self) -> int:
        """Monotonic membership version: bumps on every join/forget/
        release — the cache key for anything derived from the member
        set (the incremental arbiter's sorted order, these caches)."""
        with self._lock:
            return self._version

    def capacities(self) -> dict[str, float]:
        """service_id -> capacity (1 / speed_factor), the arbiter's
        currency: a 4×-slower node counts for a quarter of a baseline
        node.  The returned dict is a membership-keyed cache — treat it
        as immutable."""
        with self._lock:
            if self._caps_cache is None:
                self._caps_cache = {sid: 1.0 / s
                                    for sid, s in self._speed.items()}
            return self._caps_cache

    def membership(self) -> dict[str, dict]:
        with self._lock:
            return {sid: {"speed_factor": self._speed[sid]}
                    for sid in sorted(self._handles)}
