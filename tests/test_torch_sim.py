"""The port's engine host remainder held to the reference, on the CPU.

Every scenario of the reference's ``test_sim_scheduling.py`` and
``test_engine_parity.py`` runs twice on the same seed: through the
reference package (``repro``, host programs with ``jit=False``) and
through the port (``repro_torch``, host programs with ``host=True``,
``SimCluster(device="cpu")``).  Under the virtual clock both runs are
deterministic, so the port must reproduce the reference's outputs, its
full assignment trace (virtual timestamps included), its per-service
tallies and its virtual makespan exactly — and the reference's own
invariants must hold on the port's run.  The futures front-end
(``FarmExecutor``), the performance contracts and ``task_delay_s`` are
held to ``test_futures.py`` and ``test_system.py`` the same way.
"""

import threading
import time
from concurrent.futures import CancelledError
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.launch.sim as ref_launch_sim
import repro.sim as ref_sim
import repro_torch.core as port_core
import repro_torch.launch.sim as port_launch_sim
import repro_torch.obs.schema as port_schema
import repro_torch.sim as port_sim
from repro_torch.core.clock import Clock
from repro_torch.core.transport import LivenessMonitor as PortLivenessMonitor

SEEDS = [1, 2, 3]


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards (set per test, not at import: every xdist worker imports
    every test file)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _affine(x):
    return x * 2.0 + 1.0


REF = SimpleNamespace(
    name="ref", sim=ref_sim, launch=ref_launch_sim,
    prog=ref_core.Program(_affine, name="affine", jit=False), kw={})
PORT = SimpleNamespace(
    name="port", sim=port_sim, launch=port_launch_sim,
    prog=port_core.Program(_affine, name="affine", host=True),
    kw={"device": "cpu"})
BOTH = [REF, PORT]


def _ref(tasks):
    return [t * 2.0 + 1.0 for t in tasks]


def _faults(pkg, spec: dict | None):
    """{index: FaultSpec kwargs} -> the package's FaultSpec objects."""
    if spec is None:
        return None
    return {i: pkg.sim.FaultSpec(**kw) for i, kw in spec.items()}


def _run(pkg, seed, *, n_tasks=40, speeds=(1, 1, 2, 4), faults=None,
         **knobs):
    tasks = [float(i) for i in range(n_tasks)]
    knobs.setdefault("max_batch", 4)
    knobs.setdefault("max_inflight", 2)
    with pkg.sim.SimCluster(speed_factors=speeds, seed=seed,
                            faults=_faults(pkg, faults),
                            latency_jitter_s=0.0001, **pkg.kw) as cluster:
        out, client = cluster.run(pkg.prog, tasks, **knobs)
        return ([float(v) for v in out], list(cluster.trace),
                client.stats(), cluster.clock.monotonic())


def _both(*args, **kw):
    """The scenario through the reference and through the port; the port
    must reproduce outputs, trace, tallies and makespan exactly."""
    ref = _run(REF, *args, **kw)
    port = _run(PORT, *args, **kw)
    assert port[0] == ref[0]
    assert port[1] == ref[1], "assignment trace differs from the reference's"
    assert port[2]["per_service"] == ref[2]["per_service"]
    for key in ("done", "reschedules", "pending", "leased"):
        assert port[2][key] == ref[2][key], key
    assert port[3] == ref[3], "virtual makespan differs"
    return port


# ------------------------------------------------------------------ #
# the virtual clock itself
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
def test_virtual_clock_sleep_orders_by_wake_time(pkg):
    with pkg.sim.virtual_time() as clock:
        order = []

        def sleeper(name, delay):
            def run():
                clock.thread_attach()
                try:
                    clock.sleep(delay)
                    order.append((name, clock.monotonic()))
                finally:
                    clock.thread_retire()
            t = threading.Thread(target=run, name=name)
            clock.thread_spawned(t)
            t.start()

        sleeper("late", 0.5)
        sleeper("early", 0.1)
        clock.sleep(1.0)
        assert order == [("early", 0.1), ("late", 0.5)]
        assert clock.monotonic() == 1.0


def test_virtual_clock_condition_timeout_and_enrolment():
    with port_sim.virtual_time() as clock:
        cond = threading.Condition()
        with cond:
            clock.cond_wait(cond, 2.5)  # nobody notifies: pure timeout
        assert clock.monotonic() == 2.5
    assert issubclass(port_sim.VirtualClock, Clock)
    with pytest.raises(RuntimeError, match="without enrolling"):
        port_sim.VirtualClock().sleep(1.0)


# ------------------------------------------------------------------ #
# determinism: same seed, same schedule, in both packages
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_schedule_identical_trace(seed):
    faults = {0: dict(die_at=0.006), 2: dict(stall_at=0.004, stall_s=0.05)}
    a = _both(seed, faults=faults, lease_s=0.5)
    b = _run(PORT, seed, faults=faults, lease_s=0.5)
    assert a[0] == b[0] and a[1] == b[1] and a[3] == b[3]


@pytest.mark.parametrize("seed", SEEDS)
def test_all_tasks_complete_exactly_once_under_random_schedule(seed):
    import random

    rng = random.Random(seed)
    speeds = [rng.choice([1, 1, 2, 4]) for _ in range(4)]
    victim = rng.randrange(4)
    faults = {victim: dict(die_at=rng.uniform(0.002, 0.02),
                           silent=rng.random() < 0.5, hang_s=2.0)}
    straggler = (victim + 1 + rng.randrange(3)) % 4
    faults[straggler] = dict(stall_at=rng.uniform(0.002, 0.02),
                             stall_s=rng.uniform(0.05, 0.4))
    n_tasks = rng.randrange(30, 80)
    out, trace, stats, _ = _both(seed, n_tasks=n_tasks, speeds=speeds,
                                 faults=faults, lease_s=0.2)
    assert out == _ref([float(i) for i in range(n_tasks)])
    assert stats["done"] == n_tasks
    assert sum(stats["per_service"].values()) == n_tasks
    assert stats["pending"] == 0 and stats["leased"] == 0
    assert {t[1] for t in trace} == set(range(n_tasks))


@pytest.mark.parametrize("seed", SEEDS)
def test_faster_services_complete_proportionally_more(seed):
    out, _, stats, _ = _both(seed, n_tasks=120, speeds=(1, 1, 4, 4),
                             speculation=False, lease_s=5.0)
    per = stats["per_service"]
    assert out == _ref([float(i) for i in range(120)])
    for fast in ("sim0", "sim1"):
        for slow in ("sim2", "sim3"):
            assert per.get(fast, 0) > 2 * per.get(slow, 0), per


@pytest.mark.parametrize("speeds,floor", [
    ((1, 1, 1, 1), 0.9),
    ((1, 1, 2, 4), 0.8),
    ((1, 2, 2, 4), 0.8),
])
def test_efficiency_floor_for_paper_mixes(speeds, floor):
    n_tasks, base = 240, 0.001
    tasks = [float(i) for i in range(n_tasks)]
    spans = []
    for pkg in BOTH:
        with pkg.sim.SimCluster(speed_factors=speeds, seed=7,
                                base_cost_s=base, latency_s=0.0001,
                                latency_jitter_s=0.00001,
                                **pkg.kw) as cluster:
            _, client = cluster.run(pkg.prog, tasks, max_batch=8,
                                    max_inflight=2, lease_s=5.0)
            spans.append(cluster.clock.monotonic())
            assert client.stats()["done"] == n_tasks
            ideal = cluster.ideal_makespan(n_tasks)
    assert spans[1] == spans[0]
    assert ideal / spans[1] >= floor


# ------------------------------------------------------------------ #
# fault paths, each isolated (speculation off where it would mask them)
# ------------------------------------------------------------------ #
def test_loud_death_fails_leases_back_immediately():
    out, _, stats, makespan = _both(3, speeds=(1, 1, 1),
                                    faults={0: dict(die_at=0.004)},
                                    speculation=False, lease_s=100.0)
    assert out == _ref([float(i) for i in range(40)])
    assert stats["reschedules"] >= 1
    assert makespan < 1.0


def test_silent_death_recovered_by_liveness_not_lease():
    faults = {0: dict(die_at=0.004, silent=True, hang_s=30.0)}
    out, _, stats, makespan = _both(3, speeds=(1, 1, 1), faults=faults,
                                    speculation=False, lease_s=100.0,
                                    timeout=90.0)
    assert out == _ref([float(i) for i in range(40)])
    assert stats["reschedules"] >= 1
    assert 1.5 < makespan < 5.0


def test_stall_past_lease_expires_and_duplicates_are_dropped():
    faults = {0: dict(stall_at=0.003, stall_s=2.0)}
    out, _, stats, makespan = _both(5, speeds=(1, 1), faults=faults,
                                    speculation=False, lease_s=0.2,
                                    max_inflight=1)
    assert out == _ref([float(i) for i in range(40)])
    assert stats["reschedules"] >= 1
    assert stats["done"] == 40
    assert sum(stats["per_service"].values()) == 40
    assert makespan < 2.5


def test_rate_straggler_gets_speculative_backup():
    got = []
    for pkg in BOTH:
        with pkg.sim.SimCluster(speed_factors=[1, 1, 60], seed=13,
                                **pkg.kw) as cluster:
            tasks = [float(i) for i in range(60)]
            out, client = cluster.run(pkg.prog, tasks, max_batch=4,
                                      max_inflight=2, lease_s=50.0)
            got.append(([float(v) for v in out], client.stats(),
                        list(cluster.trace)))
    (ref_out, ref_stats, ref_trace), (out, stats, trace) = got
    assert out == ref_out and trace == ref_trace
    assert sorted(out) == sorted(_ref([float(i) for i in range(60)]))
    assert (stats["straggler_speculations"]
            == ref_stats["straggler_speculations"])
    assert stats["straggler_speculations"] >= 1
    assert stats["done"] == 60


def test_lookup_wait_for_services_runs_on_virtual_clock():
    with port_sim.SimCluster(speed_factors=[1, 1], seed=2, device="cpu",
                             faults={1: port_sim.FaultSpec(register_at=5.0)}
                             ) as cluster:
        assert len(cluster.lookup) == 1
        assert cluster.lookup.wait_for_services(2, timeout_s=30.0)
        assert cluster.clock.monotonic() == 5.0


def test_late_joiner_recruited_elastically_mid_run():
    out, _, stats, _ = _both(9, speeds=(4, 1),
                             faults={1: dict(register_at=0.01)})
    assert out == _ref([float(i) for i in range(40)])
    assert stats["per_service"].get("sim1", 0) > 0


def test_flaky_registration_retries_until_it_lands():
    dropped = []
    for pkg in BOTH:
        with pkg.sim.SimCluster(
                speed_factors=[1, 1], seed=11, **pkg.kw,
                faults=_faults(pkg, {1: dict(flaky_registration=0.7)})
                ) as cluster:
            tasks = [float(i) for i in range(40)]
            out, _ = cluster.run(pkg.prog, tasks, max_batch=4)
            dropped.append(cluster.services[1].dropped_registrations)
        assert [float(v) for v in out] == _ref(tasks)
    assert dropped[1] == dropped[0] and dropped[1] >= 1


def test_speed_factor_caps_slow_services_lease():
    with port_sim.SimCluster(speed_factors=[1, 8], seed=2,
                             device="cpu") as cluster:
        tasks = [float(i) for i in range(64)]
        _, client = cluster.run(PORT.prog, tasks, max_batch=16,
                                max_inflight=2)
        batching = client.stats()["batching"]
    assert batching["sim1"]["max_batch"] == 2
    assert batching["sim0"]["max_batch"] == 16


def test_sim_pool_mirrors_now_pool_api():
    outs = []
    for pkg in BOTH:
        with pkg.launch.SimPool(3, seed=4, speed_factors=[1, 1, 2],
                                **pkg.kw) as pool:
            assert len(pool) == 3
            assert pool.workers[2].address.startswith("sim://")
            tasks = [float(i) for i in range(30)]
            cm = pool.client(pkg.prog, tasks, max_batch=4, speculation=False)
            outs.append([float(v) for v in cm.compute(timeout=600)])
            pool.kill(0)
            assert not pool.workers[0].alive
        assert len(pool.lookup) == 0
    assert outs[1] == outs[0] == _ref([float(i) for i in range(30)])


def test_sim_liveness_monitor_under_virtual_clock():
    with port_sim.virtual_time() as clock:
        repo = port_core.TaskRepository(["x"], lease_s=60.0, clock=clock)
        tid, _ = repo.get_task("flaky")

        class _Handle:
            service_id = "flaky"
            needs_heartbeat = True
            alive = True

            def ping(self):
                return self.alive

        handle = _Handle()
        monitor = PortLivenessMonitor(interval_s=0.25, timeout_s=1.5,
                                      clock=clock)
        monitor.watch(handle, repo.expire_service)
        handle.alive = False
        got = repo.get_task("survivor", timeout=10.0)
        assert got is not None and got[0] == tid
        assert clock.monotonic() == pytest.approx(1.75)
        assert monitor.deaths == 1
        monitor.stop()


def test_sim_cluster_runs_on_the_card_unless_given_the_cpu():
    """The port's device rule: ``device=None`` asks for the card, which
    raises here instead of quietly simulating on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is legitimate there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sim.SimCluster(speed_factors=[1.0])
    cluster = port_sim.SimCluster(speed_factors=[1.0], device="cpu")
    assert cluster.services[0].engine.device == torch.device("cpu")


def test_sim_cluster_runs_device_programs_on_its_device():
    """A non-host program (tensors moved to the service's device) through
    the simulator: the same per-task results as ``interpret()``."""
    prog = port_core.Program(lambda x: x * x - 1.0, name="sqm1")
    tasks = [torch.full((3,), float(i)) for i in range(12)]
    want = port_core.interpret(port_core.Farm(port_core.Seq(prog)), tasks)
    with port_sim.SimCluster(speed_factors=[1, 2], seed=5,
                             device="cpu") as cluster:
        out, _ = cluster.run(prog, tasks, max_batch=4)
    assert all(torch.equal(a, b) for a, b in zip(out, want))


# ------------------------------------------------------------------ #
# three front-ends, one engine: lease and assignment traces of the
# reference's test_engine_parity.py, equal to the reference's own
# ------------------------------------------------------------------ #
CONFIGS = [
    dict(speeds=(1, 1, 2, 4), max_batch=4, max_inflight=2),
    dict(speeds=(1, 1, 1), max_batch=1, max_inflight=1),
]


def _lease_trace(raw):
    norm = []
    for t, tid, sid, attempt in raw:
        if isinstance(tid, str):
            tid = int(tid.rsplit("/", 1)[1])
        norm.append((t, tid, sid, attempt))
    return norm


def _engine_trace(engine):
    return sorted(ev for ev in engine.trace
                  if ev[0] == "service-join"
                  or (ev[0] == "assign" and ev[3] is not None))


def _cluster(pkg, seed, speeds):
    return pkg.sim.SimCluster(speed_factors=speeds, seed=seed,
                              latency_jitter_s=0.0001, **pkg.kw)


def _tasks(n):
    return [float(i) for i in range(n)]


def _run_basic(pkg, seed, n, cfg):
    with _cluster(pkg, seed, cfg["speeds"]) as cluster:
        out, client = cluster.run(pkg.prog, _tasks(n),
                                  max_batch=cfg["max_batch"],
                                  max_inflight=cfg["max_inflight"])
        return ([float(v) for v in out], _lease_trace(cluster.trace),
                _engine_trace(client.engine),
                client.stats()["per_service"])


def _run_scheduler(pkg, seed, n, cfg):
    with _cluster(pkg, seed, cfg["speeds"]) as cluster:
        sched = cluster.make_scheduler(max_batch=cfg["max_batch"],
                                       max_inflight=cfg["max_inflight"])
        with sched:
            job = sched.submit(pkg.prog, _tasks(n))
            job.wait(timeout=600)
            out = [float(v) for v in job.results_in_order()]
            per_service = job.stats()["per_service"]
        return (out, _lease_trace(cluster.trace), _engine_trace(sched),
                per_service)


def _run_executor(pkg, seed, n, cfg):
    with _cluster(pkg, seed, cfg["speeds"]) as cluster:
        ex = cluster.make_executor(pkg.prog, max_batch=cfg["max_batch"],
                                   max_inflight=cfg["max_inflight"])
        futs = ex.map(_tasks(n))
        out = [float(v) for v in ex.gather(futs, timeout=600)]
        per_service = ex.stats()["per_service"]
        trace = _lease_trace(cluster.trace)
        engine_trace = _engine_trace(ex.engine)
        ex.shutdown()
        return out, trace, engine_trace, per_service


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=["batched-hetero", "per-task-uniform"])
def test_three_front_ends_identical_schedule(seed, cfg):
    n = 60
    reference = [float(v) for v in port_core.interpret(
        port_core.Farm(port_core.Seq(PORT.prog)), _tasks(n))]
    ref_basic = _run_basic(REF, seed, n, cfg)
    runs = [f(PORT, seed, n, cfg)
            for f in (_run_basic, _run_scheduler, _run_executor)]
    for run in runs:
        assert run[0] == reference
        # the reference's BasicClient trace, timestamps included
        assert run[1] == ref_basic[1]
        assert run[2] == ref_basic[2]
        assert run[3] == ref_basic[3]


@pytest.mark.parametrize("seed", SEEDS)
def test_front_end_stats_share_one_engine_shape(seed):
    n = 40
    with _cluster(PORT, seed, (1, 2)) as cluster:
        _, client = cluster.run(PORT.prog, _tasks(n), max_batch=4)
        basic_engine = client.stats()["engine"]
    with _cluster(PORT, seed, (1, 2)) as cluster:
        ex = cluster.make_executor(PORT.prog, max_batch=4)
        ex.gather(ex.map(_tasks(n)), timeout=600)
        exec_engine = ex.stats()["engine"]
        ex.shutdown()
    with _cluster(PORT, seed, (1, 2)) as cluster:
        with cluster.make_scheduler(max_batch=4) as sched:
            job = sched.submit(PORT.prog, _tasks(n))
            job.wait(timeout=600)
            sched_engine = sched.stats()
    for engine in (basic_engine, exec_engine, sched_engine):
        port_schema.validate_engine_stats(engine)
        assert set(engine) >= port_schema.ENGINE_KEYS
        for snap in engine["batching"].values():
            assert {"max_batch", "batches_dispatched",
                    "cache_hits"} <= set(snap)
    assert exec_engine["services"].keys() == sched_engine["services"].keys()
    assert (basic_engine["batching"].keys() == exec_engine["batching"].keys()
            == sched_engine["batching"].keys())


def test_executor_bulk_map_registers_batch_atomically():
    with _cluster(PORT, 5, (1, 1)) as cluster:
        ex = cluster.make_executor(PORT.prog, max_batch=8)
        futs = ex.map(_tasks(500))
        assert len(futs) == 500
        got = ex.gather(futs, timeout=600)
        assert [float(v) for v in got] == _ref(_tasks(500))
        ex.shutdown()


# ------------------------------------------------------------------ #
# FarmExecutor lifecycle (test_futures.py), contracts and task_delay_s
# (test_system.py), on in-process CPU services
# ------------------------------------------------------------------ #
def _identity(x):
    return x


def test_shutdown_cancels_unresolved_futures():
    ex = port_core.FarmExecutor(port_core.Program(_identity),
                                lookup=port_core.LookupService())
    fut = ex.submit(torch.tensor(1.0))
    ex.shutdown()
    assert fut.cancelled()
    with pytest.raises(CancelledError):
        fut.result(timeout=5)


def test_blocked_result_caller_wakes_on_shutdown():
    ex = port_core.FarmExecutor(port_core.Program(_identity),
                                lookup=port_core.LookupService())
    fut = ex.submit(torch.tensor(2.0))
    outcome: dict = {}

    def waiter():
        try:
            outcome["value"] = fut.result(timeout=30)
        except CancelledError:
            outcome["cancelled"] = True

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    ex.shutdown()
    t.join(timeout=5)
    assert not t.is_alive(), "caller stayed blocked after shutdown"
    assert outcome.get("cancelled") is True


def test_submit_after_shutdown_raises():
    ex = port_core.FarmExecutor(port_core.Program(_identity),
                                lookup=port_core.LookupService())
    ex.shutdown()
    with pytest.raises(RuntimeError, match="shutdown"):
        ex.submit(torch.tensor(3.0))


def test_executor_streams_and_keeps_resolved_results():
    lookup = port_core.LookupService()
    for _ in range(2):
        port_core.Service(lookup, device="cpu").start()
    with port_core.FarmExecutor(port_core.Program(lambda x: x * 4),
                                lookup=lookup) as ex:
        futs = [ex.submit(torch.tensor(float(i))) for i in range(12)]
        vals = [float(f.result(timeout=60)) for f in futs]
    assert vals == [4.0 * i for i in range(12)]
    assert float(futs[2].result(timeout=1)) == 8.0  # kept after shutdown
    ex.shutdown()  # idempotent


def test_contract_limits_parallelism():
    lookup = port_core.LookupService()
    for _ in range(3):
        port_core.Service(lookup, device="cpu").start()
    out = []
    cm = port_core.BasicClient(port_core.Program(_identity),
                               port_core.ParDegreeContract(parallelism=1),
                               [torch.tensor(i) for i in range(10)], out,
                               lookup=lookup)
    cm.compute(timeout=120)
    assert [int(v) for v in out] == list(range(10))
    assert len(cm.stats()["per_service"]) == 1


def test_application_manager_recruits_replacements():
    lookup = port_core.LookupService()
    s1 = port_core.Service(lookup, device="cpu")
    s1.start()
    s1.fail_after(1)
    out = []
    tasks = [torch.tensor(i) for i in range(6)]
    cm = port_core.BasicClient(port_core.Program(lambda x: x * 5),
                               port_core.ParDegreeContract(2), tasks, out,
                               lookup=lookup, lease_s=5.0, elastic=False)
    mgr = port_core.ApplicationManager(cm, interval_s=0.02)
    mgr.start()

    def later():
        time.sleep(0.2)
        port_core.Service(lookup, device="cpu").start()

    threading.Thread(target=later, daemon=True).start()
    cm.compute(timeout=120)
    mgr.stop()
    assert [int(v) for v in out] == [5 * i for i in range(6)]
    assert mgr.recruit_events >= 1


def test_task_delay_pulls_more_tasks_to_the_fast_service():
    """``task_delay_s`` (the dispatch round-trip stand-in the NoW workers
    and the sim scenarios use): paid per task and once per batch."""
    lookup = port_core.LookupService()
    fast = port_core.Service(lookup, task_delay_s=0.001, service_id="fast",
                             device="cpu")
    slow = port_core.Service(lookup, task_delay_s=0.05, service_id="slow",
                             device="cpu")
    fast.start()
    slow.start()
    out = []
    cm = port_core.BasicClient(port_core.Program(_identity), None,
                               [torch.tensor(i) for i in range(40)], out,
                               lookup=lookup, speculation=False)
    cm.compute(timeout=120)
    per = cm.stats()["per_service"]
    assert per.get("fast", 0) > per.get("slow", 0)
    assert sum(per.values()) == 40
    prog = port_core.Program(_identity, host=True)
    t0 = time.perf_counter()
    slow.execute_batch(prog, [1.0, 2.0, 3.0, 4.0])
    assert 0.05 <= time.perf_counter() - t0 < 0.2  # once, not 4 times
    assert np.isclose(slow.task_delay_s, 0.05)


# ------------------------------------------------------------------ #
# the shards=1 golden of the reference's benchmarks/contention.py
# ------------------------------------------------------------------ #
CONTENTION_GOLDEN_SHA256 = (
    "272110425a85dabb62c84e5cd537dc298bee27c8993df7037af92d535ab4685e")
CONTENTION_GOLDEN_EVENTS = 808


def test_streaming_job_lease_trace_is_the_contention_golden():
    """``benchmarks/contention.py``'s golden scenario (24 services, 800
    streamed tasks, two deaths and a late join, batched leases with
    speculation) through the port's scheduler: its lease trace hashes to
    the reference's pinned single-lock golden."""
    import hashlib

    n_services, n_tasks = 24, 800
    faults = {0: port_sim.FaultSpec(die_at=0.2),
              1: port_sim.FaultSpec(die_at=0.25),
              n_services - 1: port_sim.FaultSpec(register_at=0.15)}
    prog = port_core.Program(lambda x: x * 3.0 + 1.0, name="affine",
                             host=True)
    with port_sim.SimCluster(speed_factors=[1.0] * n_services, seed=17,
                             base_cost_s=0.5 * n_services / n_tasks,
                             latency_s=0.0, faults=faults,
                             stall_timeout_s=300.0, device="cpu") as cluster:
        sched = cluster.make_scheduler(max_batch=4, max_inflight=1,
                                       adaptive_batching=False,
                                       speculation=True)
        with sched:
            job = sched.submit(prog, None, collect_results=True)
            job.submit_stream((float(i) for i in range(n_tasks)), window=256)
            got = dict(job.as_completed())
            job.wait(timeout=300)
            cluster.clock.sleep(3.0)
            trace = tuple(cluster.trace)
    assert len(got) == n_tasks
    assert all(got[i] == i * 3.0 + 1.0 for i in range(n_tasks))
    h = hashlib.sha256()
    for item in trace:
        h.update(repr(item).encode())
    assert len(trace) == CONTENTION_GOLDEN_EVENTS
    assert h.hexdigest() == CONTENTION_GOLDEN_SHA256
