"""MetricsRegistry: counters, gauges and fixed-bucket histograms.

One registry per :class:`~repro_torch.obs.Observability` bundle.  Instruments
are created once (registration takes a lock) and updated lock-cheap
(one ``threading.Lock`` per instrument; hot-path producers usually
already hold a shard or controller lock, so the instrument lock is
uncontended).  ``snapshot()`` renders the whole registry as one
versioned, JSON-serializable tree — the shape the periodic JSONL dump
and ``engine.stats()["metrics"]`` expose.

Histograms use *fixed* bucket boundaries chosen at registration:
observation is a bisect over a tuple (no allocation), and two same-seed
``sim://`` runs produce identical snapshots because the boundaries are
part of the schema, not the data.
"""

from __future__ import annotations

import threading
from bisect import bisect_left

#: snapshot tree schema tag (bump on incompatible shape changes)
METRICS_SCHEMA = "jjpf.metrics/v1"

#: default latency boundaries (seconds): 100 µs .. 100 s, log-ish steps
LATENCY_BUCKETS_S = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                     0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0)

#: default batch-size boundaries (tasks per lease)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


class Counter:
    """Monotone event counter."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-boundary histogram: counts[i] holds observations <=
    boundaries[i]; the last slot is the overflow bucket."""

    __slots__ = ("name", "boundaries", "counts", "sum", "count", "_lock")

    def __init__(self, name: str, boundaries):
        bounds = tuple(float(b) for b in boundaries)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError("boundaries must be non-empty and "
                             "strictly increasing")
        self.name = name
        self.boundaries = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect_left(self.boundaries, v)  # le buckets: v <= bound[i]
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "boundaries": list(self.boundaries),
                "counts": list(self.counts),
                "sum": self.sum,
                "count": self.count,
            }


class MetricsRegistry:
    """Named instrument store with one versioned snapshot tree."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _get(self, store: dict, name: str, factory):
        with self._lock:
            inst = store.get(name)
            if inst is None:
                inst = store[name] = factory()
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, lambda: Gauge(name))

    def histogram(self, name: str,
                  boundaries=LATENCY_BUCKETS_S) -> Histogram:
        return self._get(self._histograms, name,
                         lambda: Histogram(name, boundaries))

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "schema": METRICS_SCHEMA,
            "counters": {n: c.snapshot() for n, c in sorted(counters.items())},
            "gauges": {n: g.snapshot() for n, g in sorted(gauges.items())},
            "histograms": {n: h.snapshot()
                           for n, h in sorted(histograms.items())},
        }
