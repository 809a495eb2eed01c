"""TraceRecorder: per-thread bounded ring buffers of structured events.

The farm's hot path is many threads (one control thread per recruited
service, plus feeders, the rebalancer, and whoever calls ``submit``)
hitting shared state behind carefully scoped locks — instrumentation
must not add a shared lock of its own.  The recorder therefore keeps
**one ring buffer per thread**: ``event()`` touches only thread-local
state (one tuple concat + one deque append on the hot path), and the
rings are only walked together at export time.

Rings are keyed by **thread name**, not thread id: thread names in this
repo are deterministic (``farm-{sid}-{jid}``, ``{job}-feeder-{k}``,
``sim-runner`` ...) while ids are allocation-order accidents, and a
revoked service's successor thread reuses the name — so a same-seed
``sim://`` run produces the same ring map, and :meth:`events` (sorted by
``(t, ring, seq)``) is byte-stable.  Timestamps come from the owning
:class:`~repro_torch.core.clock.Clock` seam (callers usually pass ``t`` from a
clock read they already paid for; ``t=None`` reads the recorder's
clock), so virtual-clock runs trace virtual time.

An event is a plain tuple ``(t, kind, *fields)``.  The taxonomy lives in
:data:`repro_torch.obs.schema.EVENT_KINDS`; hot-path producers emit **one
event per batch**, never per task (per-task detail rides inside the
event's fields), which is what keeps tracing-enabled overhead inside the
benchmark gate (``benchmarks/observability.py``, ≤ 3% µs/task).

``ring_size=0`` plus a ``sink`` callable turns the recorder into an
O(1)-memory streaming consumer — ``benchmarks/scale.py`` hashes a
million-task lease trace this way without materializing it.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable

from repro_torch.core.clock import REAL_CLOCK

DEFAULT_RING_SIZE = 16384


class _Ring:
    __slots__ = ("name", "events", "appended")

    def __init__(self, name: str, maxlen: int):
        self.name = name
        self.events: deque | None = deque(maxlen=maxlen) if maxlen else None
        self.appended = 0  # lifetime count (drops = appended - len(events))


class TraceRecorder:
    """Lock-free-on-the-hot-path structured event log.

    ``clock``     timestamps for ``event(..., t=None)`` (default: wall).
    ``ring_size`` per-thread bound; oldest events drop first.  ``0``
                  stores nothing (sink-only mode).
    ``sink``      optional ``(ring_name, event_tuple)`` callable invoked
                  on every event *from the emitting thread* — only
                  deterministic in order under ``sim://``'s cooperative
                  scheduler; real-clock users must make it thread-safe.
    """

    def __init__(self, *, clock=None, ring_size: int = DEFAULT_RING_SIZE,
                 sink: Callable[[str, tuple], None] | None = None):
        if ring_size < 0:
            raise ValueError("ring_size must be >= 0")
        self._clock = clock if clock is not None else REAL_CLOCK
        self._ring_size = ring_size
        self._sink = sink
        self._rings: dict[str, _Ring] = {}
        self._rings_lock = threading.Lock()  # ring creation only
        self._local = threading.local()

    def bind_clock(self, clock) -> None:
        """Late clock binding: front-ends build an ``Observability``
        before they know their engine's clock; the engine binds it at
        construction so ``t=None`` events read the right seam."""
        if clock is not None:
            self._clock = clock

    @property
    def clock(self):
        return self._clock

    # ---------------- hot path ------------------------------------- #
    def _ring(self) -> _Ring:
        try:
            return self._local.ring
        except AttributeError:
            name = threading.current_thread().name
            with self._rings_lock:
                ring = self._rings.get(name)
                if ring is None:
                    ring = self._rings[name] = _Ring(name, self._ring_size)
            self._local.ring = ring
            return ring

    def event(self, kind: str, t: float | None, *fields) -> None:
        """Record one event on the calling thread's ring.  ``t=None``
        stamps with the recorder's clock; producers that already hold a
        clock read pass it to avoid the second read."""
        ring = self._ring()
        if t is None:
            t = self._clock.monotonic()
        ev = (t, kind) + fields
        if ring.events is not None:
            ring.events.append(ev)
        ring.appended += 1
        sink = self._sink
        if sink is not None:
            sink(ring.name, ev)

    # ---------------- consumption ---------------------------------- #
    def events(self) -> list[tuple]:
        """All retained events merged across rings, sorted by
        ``(t, ring_name, per-ring sequence)`` — a deterministic total
        order under ``sim://`` (virtual timestamps + deterministic
        thread names)."""
        keyed = []
        with self._rings_lock:
            rings = sorted(self._rings.items())
        for name, ring in rings:
            if not ring.events:
                continue
            base = ring.appended - len(ring.events)
            keyed.extend(((ev[0], name, base + i), ev)
                         for i, ev in enumerate(ring.events))
        keyed.sort(key=lambda pair: pair[0])
        return [ev for _, ev in keyed]

    def clear(self) -> None:
        with self._rings_lock:
            for ring in self._rings.values():
                if ring.events is not None:
                    ring.events.clear()

    def stats(self) -> dict:
        with self._rings_lock:
            rings = list(self._rings.values())
        retained = sum(len(r.events) for r in rings if r.events is not None)
        recorded = sum(r.appended for r in rings)
        return {
            "rings": len(rings),
            "ring_size": self._ring_size,
            "events_recorded": recorded,
            "events_retained": retained,
            "events_dropped": recorded - retained if self._ring_size else 0,
        }
