"""The port's telemetry spine held to the reference's ``test_obs.py``.

- recorder — per-thread rings merged in a deterministic order, bounded
  drop-oldest retention, sink-only mode;
- metrics — counters, gauges, fixed-bucket histograms, the versioned
  snapshot;
- the Chrome trace-event exporter — schema, one track per service, spans;
- **the golden ``sim://`` trace** — the reference's churny scenario
  (``_golden_run``: seed 17, a mid-run death, a late joiner, speculation,
  ``max_batch=4``) run through the port exports the *same bytes* as the
  reference's run in the same test, and both hash to the reference's
  pinned SHA-256 with its 162 events;
- tracing disabled is free, and the recorder's lease stream agrees with
  the ``on_lease`` hook.
"""

from __future__ import annotations

import hashlib
import json
import threading

import pytest
import torch

import repro.core as ref_core
import repro.obs as ref_obs
import repro.sim as ref_sim
from repro_torch.core import Program
from repro_torch.obs import Observability
from repro_torch.obs.export import (chrome_trace_events, dump_metrics_jsonl,
                                    export_chrome_trace, farm_top,
                                    validate_chrome_trace)
from repro_torch.obs.metrics import (BATCH_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry)
from repro_torch.obs.recorder import TraceRecorder
from repro_torch.sim import FaultSpec, SimCluster


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards (set per test, not at import: every xdist worker imports
    every test file)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _affine3(x):
    return x * 3.0 + 1.0


PROGRAM = Program(_affine3, name="affine", host=True)

#: the reference's golden scenario and its pinned trace (tests/test_obs.py)
GOLDEN_SEED = 17
GOLDEN_SHA256 = \
    "9b081ddb9128014d21579a3f4a12426269516c03bbbafcd091a05e9c8561e77f"
GOLDEN_EVENTS = 162


def _golden_run(pkg: str = "port"):
    if pkg == "ref":
        obs = ref_obs.Observability()
        cluster = ref_sim.SimCluster(
            speed_factors=[1.0, 1.0, 2.0, 4.0], seed=GOLDEN_SEED,
            base_cost_s=0.002, latency_s=0.0002,
            faults={1: ref_sim.FaultSpec(die_at=0.08),
                    3: ref_sim.FaultSpec(register_at=0.05)}, obs=obs)
        program = ref_core.Program(_affine3, name="affine", jit=False)
    else:
        obs = Observability()
        cluster = SimCluster(
            speed_factors=[1.0, 1.0, 2.0, 4.0], seed=GOLDEN_SEED,
            base_cost_s=0.002, latency_s=0.0002,
            faults={1: FaultSpec(die_at=0.08), 3: FaultSpec(register_at=0.05)},
            obs=obs, device="cpu")
        program = PROGRAM
    with cluster:
        out, _client = cluster.run(program, [float(i) for i in range(96)],
                                   max_batch=4, lease_s=0.3)
        assert sorted(float(v) for v in out) == \
            sorted(i * 3.0 + 1.0 for i in range(96))
    return obs


# ------------------------------------------------------------------ #
# recorder
# ------------------------------------------------------------------ #
def test_recorder_per_thread_rings_merge_deterministically():
    rec = TraceRecorder()
    barrier = threading.Barrier(3)

    def emit(k):
        barrier.wait()
        for i in range(5):
            rec.event("tick", float(i), k)

    threads = [threading.Thread(target=emit, args=(k,), name=f"ring-{k}")
               for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    evs = rec.events()
    assert len(evs) == 15
    assert [e[0] for e in evs] == sorted(e[0] for e in evs)
    assert [e[2] for e in evs] == [0, 1, 2] * 5
    s = rec.stats()
    assert s["rings"] == 3 and s["events_recorded"] == 15
    assert s["events_dropped"] == 0


def test_recorder_bounded_ring_drops_oldest():
    rec = TraceRecorder(ring_size=4)
    for i in range(10):
        rec.event("tick", float(i))
    assert [e[0] for e in rec.events()] == [6.0, 7.0, 8.0, 9.0]
    s = rec.stats()
    assert s["events_recorded"] == 10
    assert s["events_retained"] == 4
    assert s["events_dropped"] == 6
    rec.clear()
    assert rec.events() == []


def test_recorder_sink_only_mode_retains_nothing():
    got = []
    rec = TraceRecorder(ring_size=0, sink=lambda ring, ev: got.append(ev))
    for i in range(100):
        rec.event("tick", float(i), i * 2)
    assert len(got) == 100 and got[7] == (7.0, "tick", 14)
    assert rec.events() == []
    assert rec.stats()["events_recorded"] == 100
    assert rec.stats()["events_retained"] == 0


# ------------------------------------------------------------------ #
# metrics
# ------------------------------------------------------------------ #
def _fill(reg):
    c = reg.counter("tasks_done")
    c.inc()
    c.inc(4)
    reg.gauge("pool_size").set(7)
    h = reg.histogram("batch", boundaries=BATCH_BUCKETS)
    for v in (1, 3, 1000, 5000):
        h.observe(v)
    return c


def test_counter_gauge_histogram_and_snapshot_shape():
    reg = MetricsRegistry()
    c = _fill(reg)
    assert reg.counter("tasks_done") is c  # get-or-create
    snap = reg.snapshot()
    assert snap["schema"] == "jjpf.metrics/v1"
    assert snap["counters"]["tasks_done"] == 5
    assert snap["gauges"]["pool_size"] == 7
    hs = snap["histograms"]["batch"]
    assert hs["count"] == 4 and hs["sum"] == 6004
    assert hs["counts"][0] == 1 and hs["counts"][-1] == 1
    assert sum(hs["counts"]) == 4
    # the same instruments in the reference give the same snapshot
    ref_reg = ref_obs.MetricsRegistry()
    _fill(ref_reg)
    assert snap == ref_reg.snapshot()


def test_histogram_rejects_bad_boundaries():
    with pytest.raises(ValueError):
        Histogram("x", (1.0, 1.0, 2.0))
    with pytest.raises(ValueError):
        Histogram("x", ())


def test_instruments_are_thread_safe():
    c = Counter("n")
    g = Gauge("v")
    threads = [threading.Thread(target=lambda: [c.inc() for _ in range(1000)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    g.set(3.5)
    assert c.snapshot() == 4000 and g.snapshot() == 3.5


# ------------------------------------------------------------------ #
# exporters and the golden trace
# ------------------------------------------------------------------ #
def test_chrome_trace_export_loads_and_validates(tmp_path):
    obs = _golden_run()
    path = tmp_path / "trace.json"
    export_chrome_trace(obs, str(path))
    with open(path) as f:
        events = json.load(f)
    assert isinstance(events, list) and events
    info = validate_chrome_trace(str(path))
    assert info["service_tracks"] == 4
    assert len(info["event_types"]) >= 5
    assert info["spans"] > 0 and info["instants"] > 0
    assert {"lease", "complete", "recruit"} <= set(info["event_types"])


def test_chrome_trace_spans_nest_under_service_tracks():
    events = chrome_trace_events(_golden_run().events())
    tids = {e["args"]["name"]: e["tid"] for e in events
            if e["ph"] == "M" and e["name"] == "thread_name"}
    assert tids["scheduler"] == 0
    svc_tids = {v for k, v in tids.items() if k.startswith("service ")}
    spans = [e for e in events if e["ph"] == "X"]
    assert spans and all(e["tid"] in svc_tids for e in spans
                         if e["cat"] == "complete")
    for e in spans:
        assert e["dur"] >= 0 and e["ts"] >= 0


def test_golden_trace_is_the_references_byte_for_byte(tmp_path):
    """The port's run of the reference's golden scenario exports the same
    bytes as the reference's run, and both hash to the pinned golden."""
    paths = {}
    for pkg in ("ref", "port", "port-again"):
        obs = _golden_run("ref" if pkg == "ref" else "port")
        assert len(obs.events()) == GOLDEN_EVENTS
        paths[pkg] = tmp_path / f"{pkg}.json"
        if pkg == "ref":
            ref_obs.export_chrome_trace(obs.recorder, str(paths[pkg]))
        else:
            export_chrome_trace(obs, str(paths[pkg]))
    ref_bytes = paths["ref"].read_bytes()
    port_bytes = paths["port"].read_bytes()
    assert port_bytes == paths["port-again"].read_bytes()
    if port_bytes != ref_bytes:  # name the first event that differs
        ref_ev, port_ev = json.loads(ref_bytes), json.loads(port_bytes)
        first = next(i for i, (a, b) in enumerate(zip(ref_ev, port_ev))
                     if a != b)
        pytest.fail(f"event {first}: port {port_ev[first]} != "
                    f"reference {ref_ev[first]}")
    assert hashlib.sha256(port_bytes).hexdigest() == GOLDEN_SHA256
    assert hashlib.sha256(ref_bytes).hexdigest() == GOLDEN_SHA256


def test_metrics_jsonl_dump_appends_lines(tmp_path):
    obs = _golden_run()
    path = tmp_path / "metrics.jsonl"
    dump_metrics_jsonl(obs.registry, str(path), t=1.0)
    dump_metrics_jsonl(obs.registry, str(path), t=2.0,
                       extra={"note": "second"})
    lines = path.read_text().splitlines()
    assert len(lines) == 2
    first, second = (json.loads(ln) for ln in lines)
    assert first["t"] == 1.0 and second["note"] == "second"
    assert second["histograms"]["queue_wait_s"]["count"] > 0


def test_farm_top_renders_jobs_and_services():
    obs = Observability()
    with SimCluster(speed_factors=[1.0, 2.0], seed=3, base_cost_s=0.002,
                    obs=obs, device="cpu") as cluster:
        with cluster.make_scheduler(max_batch=4) as sched:
            job = sched.submit(PROGRAM, [float(i) for i in range(24)])
            job.wait(timeout=600)
            text = farm_top(sched.stats())
    assert "job-0" in text and "sim0" in text
    assert "JOB" in text and "SERVICE" in text
    assert "jjpf.stats/v1" in text


# ------------------------------------------------------------------ #
# tracing disabled: zero events, no recorder on the dispatch path
# ------------------------------------------------------------------ #
def test_tracing_disabled_constructs_no_recorder(monkeypatch):
    def boom(self, *a, **kw):
        raise AssertionError("TraceRecorder constructed without obs")

    monkeypatch.setattr(TraceRecorder, "__init__", boom)
    monkeypatch.setattr(TraceRecorder, "event", boom)
    with SimCluster(speed_factors=[1.0, 1.0], seed=3, base_cost_s=0.002,
                    device="cpu") as cluster:
        out, client = cluster.run(PROGRAM, [float(i) for i in range(24)],
                                  max_batch=4)
        assert len(out) == 24
        stats = client.engine.stats()
    assert "metrics" not in stats and "trace" not in stats
    assert client.obs is None and client.engine.obs is None
    assert client.repository._obs is None
    for shard in client.repository._shards:
        assert shard._obs is None
    assert cluster.trace, "on_lease compatibility path stopped recording"


def test_obs_and_on_lease_lease_streams_agree():
    def run_hook():
        with SimCluster(speed_factors=[1.0, 2.0], seed=11,
                        base_cost_s=0.002, device="cpu") as cluster:
            cluster.run(PROGRAM, [float(i) for i in range(48)], max_batch=4)
            return [(tid, sid, att) for (_t, tid, sid, att)
                    in cluster.trace]

    def run_obs():
        obs = Observability()
        with SimCluster(speed_factors=[1.0, 2.0], seed=11,
                        base_cost_s=0.002, obs=obs, device="cpu") as cluster:
            cluster.run(PROGRAM, [float(i) for i in range(48)], max_batch=4)
        flat = []
        for ev in obs.events():
            if ev[1] == "lease":
                flat.extend((tid, ev[2], att) for tid, att in ev[3])
            elif ev[1] == "speculate":
                flat.append((ev[3], ev[2], ev[4]))
        return flat

    assert run_hook() == run_obs()
