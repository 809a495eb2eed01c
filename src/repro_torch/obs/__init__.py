"""repro_torch.obs — the farm's telemetry spine.

One :class:`Observability` bundle per engine: a
:class:`~repro_torch.obs.recorder.TraceRecorder` (per-thread ring buffers of
task-lifecycle / scheduler / transport events, clock-seam timestamps) +
a :class:`~repro_torch.obs.metrics.MetricsRegistry` (counters, gauges,
fixed-bucket histograms) + exporters (Perfetto/Chrome trace JSON,
periodic JSONL metrics, ``farm_top`` text).

Attach it by passing ``obs=Observability()`` to any front-end
(``BasicClient``, ``FarmExecutor``, ``FarmScheduler``) or a
``SimCluster``; the engine binds its clock into the bundle, every layer
below (repository, control threads, pool, transports) picks it up, and
``engine.stats()`` grows ``metrics``/``trace`` subtrees.  ``obs=None``
(the default) is free: not a single event object is constructed on the
dispatch path.

Under ``sim://`` the whole pipeline is deterministic: same seed ⇒
byte-identical exported traces (gated in ``tests/test_torch_obs.py``,
against the reference package's own trace), which
supersedes the bespoke ``on_lease`` assignment-trace hook (still
honored for backward compatibility, but new consumers should read the
recorder — see ``benchmarks/scale.py`` / ``heterogeneous_now.py``).
"""

from __future__ import annotations

from .export import (PeriodicMetricsDump, chrome_trace_events,
                     dump_metrics_jsonl, export_chrome_trace, farm_top,
                     validate_chrome_trace)
from .metrics import (BATCH_BUCKETS, LATENCY_BUCKETS_S, Counter, Gauge,
                      Histogram, MetricsRegistry)
from .recorder import TraceRecorder
from . import schema

__all__ = [
    "Observability", "TraceRecorder", "MetricsRegistry", "Counter",
    "Gauge", "Histogram", "chrome_trace_events", "export_chrome_trace",
    "validate_chrome_trace", "dump_metrics_jsonl", "PeriodicMetricsDump",
    "farm_top", "schema", "LATENCY_BUCKETS_S", "BATCH_BUCKETS",
]


class Observability:
    """Recorder + registry + the engine's standard instruments.

    ``clock``     timestamp source; engines re-bind their own at
                  construction (:meth:`bind_clock`), so leaving the
                  default is fine.
    ``ring_size`` per-thread event ring bound (``0`` = sink-only).
    ``sink``      per-event callable ``(ring_name, event)`` — the
                  O(1)-memory streaming consumer hook.
    """

    def __init__(self, *, clock=None, ring_size: int | None = None,
                 sink=None):
        kw = {} if ring_size is None else {"ring_size": ring_size}
        self.recorder = TraceRecorder(clock=clock, sink=sink, **kw)
        self.registry = MetricsRegistry()
        # the engine's standard histograms (fixed buckets => same-seed
        # sim snapshots are identical)
        self.queue_wait_s = self.registry.histogram(
            "queue_wait_s", LATENCY_BUCKETS_S)
        self.lease_duration_s = self.registry.histogram(
            "lease_duration_s", LATENCY_BUCKETS_S)
        self.dispatch_latency_s = self.registry.histogram(
            "dispatch_latency_s", LATENCY_BUCKETS_S)
        self.batch_size = self.registry.histogram(
            "batch_size", BATCH_BUCKETS)

    def bind_clock(self, clock) -> None:
        self.recorder.bind_clock(clock)

    # -- convenience pass-throughs ---------------------------------- #
    @property
    def event(self):
        return self.recorder.event

    def events(self) -> list[tuple]:
        return self.recorder.events()

    def export_chrome_trace(self, path: str, **kw) -> list[dict]:
        return export_chrome_trace(self.recorder, path, **kw)

    def dump_metrics(self, path: str, *, extra: dict | None = None) -> dict:
        return dump_metrics_jsonl(
            self.registry, path, t=self.recorder.clock.monotonic(),
            extra=extra)

    def stats(self) -> dict:
        return self.recorder.stats()
