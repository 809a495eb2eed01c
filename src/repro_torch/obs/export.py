"""Exporters: Chrome trace-event JSON (Perfetto), JSONL metrics, farm-top.

The Chrome trace-event format (the JSON array flavor) is what
https://ui.perfetto.dev and chrome://tracing load directly.  Layout:

* ``pid 1`` is the farm; one **track (tid) per service** in order of
  first appearance, plus ``tid 0`` for the scheduler/repository track.
* Every completed task becomes a complete span (``ph="X"``) on its
  service's track covering its **lease** (lease start → completion) —
  the paper's per-task service time.  Each drained batch becomes a
  nested ``dispatch`` span (dispatch → materialization), so leases
  visually contain the batches that executed them.
* Everything else (lease grants, speculation, expiry, recruit/assign/
  revoke/rebalance, job lifecycle, transport frames) is an instant
  (``ph="i"``), and a cumulative ``tasks_done`` counter track
  (``ph="C"``) tracks goodput.
* Each emitted dict carries its source event kind in ``cat`` — the
  "≥ N event types" acceptance check counts distinct categories.

Serialization is canonical (sorted keys, fixed separators, timestamps
rounded to 0.1 µs) so two same-seed ``sim://`` runs export
**byte-identical** files — pinned by SHA-256 in ``tests/test_obs.py``.
"""

from __future__ import annotations

import json
from typing import Iterable

from .metrics import MetricsRegistry


def _us(t: float) -> float:
    # trace-event timestamps are µs; round to 0.1 µs so float noise
    # can't break byte-identical exports
    return round(t * 1e6, 1)


def chrome_trace_events(events: Iterable[tuple], *,
                        process_name: str = "jjpf-farm") -> list[dict]:
    """Render recorder events (``(t, kind, *fields)`` tuples, already in
    deterministic order) as a Chrome trace-event list."""
    tracks: dict[str, int] = {}  # service_id -> tid (first appearance)
    out: list[dict] = []
    done_total = 0

    def track(sid: str) -> int:
        tid = tracks.get(sid)
        if tid is None:
            tid = tracks[sid] = len(tracks) + 1
        return tid

    def instant(t, kind, sid, args=None, name=None):
        ev = {"name": name or kind, "cat": kind, "ph": "i", "s": "t",
              "pid": 1, "tid": 0 if sid is None else track(sid),
              "ts": _us(t)}
        if args:
            ev["args"] = args
        out.append(ev)

    for ev in events:
        t, kind = ev[0], ev[1]
        if kind == "complete":
            sid, pairs = ev[2], ev[3]
            tid = track(sid)
            for task_id, start in pairs:
                out.append({"name": f"task {task_id}", "cat": "complete",
                            "ph": "X", "pid": 1, "tid": tid,
                            "ts": _us(start), "dur": _us(t - start),
                            "args": {"task": task_id, "service": sid}})
            done_total += len(pairs)
            out.append({"name": "tasks_done", "cat": "counter", "ph": "C",
                        "pid": 1, "tid": 0, "ts": _us(t),
                        "args": {"done": done_total}})
        elif kind == "drain":
            sid, n, t0 = ev[2], ev[3], ev[4]
            out.append({"name": f"dispatch[{n}]", "cat": "dispatch",
                        "ph": "X", "pid": 1, "tid": track(sid),
                        "ts": _us(t0), "dur": _us(t - t0),
                        "args": {"n": n, "service": sid}})
        elif kind == "lease":
            sid, pairs = ev[2], ev[3]
            instant(t, kind, sid,
                    {"tasks": [p[0] for p in pairs], "n": len(pairs)})
        elif kind == "dispatch":
            # the matching drain draws the span; keep the instant for
            # batches that never materialized (crash mid-flight)
            continue
        elif kind == "speculate":
            instant(t, kind, ev[2], {"task": ev[3], "attempt": ev[4]})
        elif kind == "steal":
            instant(t, kind, ev[2], {"shard": ev[3], "home": ev[4]})
        elif kind in ("task-fail", "service-dead", "service-lost",
                      "reconnect"):
            instant(t, kind, ev[2])
        elif kind == "expire":
            instant(t, kind, None, {"tasks": list(ev[2])})
        elif kind == "expire-service":
            instant(t, kind, ev[2], {"n": ev[3]})
        elif kind == "recruit":
            instant(t, kind, ev[2], {"speed_factor": ev[3]})
        elif kind in ("assign", "revoke"):
            instant(t, kind, ev[2], {"job": ev[3]})
        elif kind == "rebalance":
            instant(t, kind, None, {"jobs": ev[2], "changed": ev[3]})
        elif kind in ("job-submit", "job-start", "job-end"):
            instant(t, kind, None,
                    {"job": ev[2], **({"detail": ev[3]}
                                      if len(ev) > 3 else {})})
        elif kind == "task-submit":
            instant(t, kind, None, {"n": ev[2], "first_task": ev[3]})
        elif kind == "frame":
            instant(t, kind, ev[2],
                    {"bytes_out": ev[3], "bytes_in": ev[4]})
        elif kind == "shm-ring":
            instant(t, kind, ev[2],
                    {"ring_bytes": ev[3], "inline_fallbacks": ev[4]})
        elif kind == "cancel":
            instant(t, kind, None, {"dropped": ev[2]})
        else:  # unknown kinds still show up rather than vanish
            instant(t, kind, None, {"fields": [repr(f) for f in ev[2:]]})

    meta = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": process_name}},
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "scheduler"}}]
    for sid, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
        meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                     "tid": tid, "args": {"name": f"service {sid}"}})
    return meta + out


def export_chrome_trace(source, path: str, **kw) -> list[dict]:
    """Write a Perfetto-loadable trace file.  ``source`` is a
    TraceRecorder, an Observability bundle, or an event list.  Returns
    the emitted trace-event list."""
    events = source
    if hasattr(source, "recorder"):  # Observability
        events = source.recorder.events()
    elif hasattr(source, "events"):  # TraceRecorder
        events = source.events()
    trace = chrome_trace_events(events, **kw)
    with open(path, "w") as fh:
        json.dump(trace, fh, sort_keys=True, separators=(",", ":"))
    return trace


def validate_chrome_trace(source) -> dict:
    """Schema-check a trace (path, JSON string, or event list) and
    report what it holds — the acceptance gate reads this.  Raises
    ``ValueError`` on malformed traces."""
    if isinstance(source, str):
        with open(source) as fh:
            trace = json.load(fh)
    else:
        trace = source
    if not isinstance(trace, list) or not trace:
        raise ValueError("trace must be a non-empty JSON array")
    service_tracks = set()
    categories = set()
    spans = instants = 0
    for ev in trace:
        if not isinstance(ev, dict):
            raise ValueError(f"non-dict trace event: {ev!r}")
        ph = ev.get("ph")
        if ph not in ("M", "X", "i", "C"):
            raise ValueError(f"unknown phase {ph!r} in {ev!r}")
        if "pid" not in ev or "name" not in ev:
            raise ValueError(f"event missing pid/name: {ev!r}")
        if ph == "M":
            if (ev["name"] == "thread_name"
                    and ev["args"]["name"].startswith("service ")):
                service_tracks.add(ev["tid"])
            continue
        if "ts" not in ev or "tid" not in ev:
            raise ValueError(f"event missing ts/tid: {ev!r}")
        if ph == "X":
            if "dur" not in ev or ev["dur"] < 0:
                raise ValueError(f"X event missing/negative dur: {ev!r}")
            spans += 1
        elif ph == "i":
            instants += 1
        categories.add(ev.get("cat", ""))
    return {
        "events": len(trace),
        "spans": spans,
        "instants": instants,
        "service_tracks": len(service_tracks),
        "event_types": sorted(categories - {"counter"}),
    }


# ------------------------------------------------------------------ #
# metrics dumps
# ------------------------------------------------------------------ #
def dump_metrics_jsonl(registry: MetricsRegistry, path: str, *,
                       t: float | None = None, extra: dict | None = None
                       ) -> dict:
    """Append one registry snapshot as a JSON line (the periodic dump
    format: one line per sample, ``t`` = clock seam time)."""
    snap = registry.snapshot()
    if t is not None:
        snap["t"] = t
    if extra:
        snap.update(extra)
    with open(path, "a") as fh:
        fh.write(json.dumps(snap, sort_keys=True) + "\n")
    return snap


class PeriodicMetricsDump:
    """Clock-enrolled sampler: appends a JSONL snapshot every
    ``interval_s`` until stopped (virtual intervals under ``sim://``)."""

    def __init__(self, obs, path: str, *, interval_s: float = 1.0):
        import threading

        self.obs = obs
        self.path = path
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="obs-metrics-dump")
        clock = obs.recorder.clock
        clock.thread_spawned(self._thread)
        self._thread.start()

    def _run(self) -> None:
        clock = self.obs.recorder.clock
        clock.thread_attach()
        try:
            while not self._stop.is_set():
                clock.sleep(self.interval_s)
                dump_metrics_jsonl(self.obs.registry, self.path,
                                   t=clock.monotonic())
        finally:
            clock.thread_retire()

    def stop(self) -> None:
        clock = self.obs.recorder.clock
        clock.event_set(self._stop)
        from repro_torch.core.pool import clock_join

        clock_join(clock, [self._thread], 5.0)


# ------------------------------------------------------------------ #
# farm-top
# ------------------------------------------------------------------ #
def farm_top(stats: dict) -> str:
    """One-shot text summary of an engine snapshot (the ``top(1)`` of
    the farm): jobs, per-service assignment + batching, totals."""
    lines = [
        f"farm-top — {stats.get('schema', 'jjpf.stats/v0')}",
        f"services: {stats['n_services']}  "
        f"running jobs: {len(stats['running'])}  "
        f"queued: {len(stats['queued'])}  "
        f"rebalances: {stats['rebalances']}"
        + (f"/{stats['rebalance_requests']} requests"
           if "rebalance_requests" in stats else "")
        + f"  revocations: {stats['revocations']}",
    ]
    jobs = stats.get("jobs", {})
    if jobs:
        lines.append(f"{'JOB':<10} {'STATE':<10} {'W':>5} {'DONE':>8} "
                     f"{'TASKS':>8} {'RESCHED':>8} {'SVCS':>5}")
        for jid, j in sorted(jobs.items()):
            lines.append(f"{jid:<10} {j['state']:<10} {j['weight']:>5.1f} "
                         f"{j['done']:>8} {j['tasks']:>8} "
                         f"{j['reschedules']:>8} {len(j['services']):>5}")
    services = stats.get("services", {})
    if services:
        batching = stats.get("batching", {})
        lines.append(f"{'SERVICE':<14} {'JOB':<10} {'SPEED':>6} "
                     f"{'BATCH':>6} {'DISPATCHES':>10}")
        for sid, svc in sorted(services.items()):
            snap = batching.get(sid, {})
            lines.append(
                f"{sid:<14} {str(svc['job']):<10} "
                f"{svc['speed_factor']:>6.2f} "
                f"{snap.get('batch', '-')!s:>6} "
                f"{snap.get('batches_dispatched', 0):>10}")
    trace = stats.get("trace")
    if trace:
        lines.append(f"trace: {trace['events_recorded']} events in "
                     f"{trace['rings']} rings "
                     f"({trace['events_dropped']} dropped)")
    return "\n".join(lines)
