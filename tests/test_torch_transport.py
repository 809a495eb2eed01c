"""The port's process transports held to the reference's
``test_transport.py`` and ``test_shm.py``: the frame codec, ``proc://``
and ``shm://`` farms on CPU worker processes, real SIGKILL, and the
socket bytes a task costs.

- The codec rejects the same corrupt and truncated frames as the
  reference's, with the same errors, and packs the same envelope bytes.
- Tensors cross the wire as compact CPU tensors of any dtype (bf16
  included); numpy and Python leaves as they are.
- ``proc://`` and ``shm://`` farms of two CPU workers match
  ``interpret()`` per task and batched; a SIGKILLed worker's tasks are
  rescheduled, also on the route a bare install takes (no ``msgpack``,
  no ``cloudpickle``, in the client and in the workers); a program bug
  surfaces as ``RemoteProgramError``.
- Socket bytes per task on the 1 MiB fp32 payload of ``BENCH_wire.json``,
  computed for the reference and the port in one test.
- No port module imports ``jax``, ``repro``, ``msgpack`` or
  ``cloudpickle`` unconditionally.

Workers are few (each start costs a torch import): one ``proc`` and one
``shm`` pool for the module, two pools that lose a worker, and one
reference worker.
"""

from __future__ import annotations

import functools
import gc
import importlib
import json
import operator
import os
import random
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.transport.wire as ref_wire
from repro_torch.core import (BasicClient, Farm, LookupService, Program,
                              RemoteProgramError, Seq, Service,
                              TaskRepository, interpret, resolve_handle)
from repro_torch.core.batching import BatchResults
from repro_torch.core.errors import TransportError
from repro_torch.core.transport import LivenessMonitor, wire
from repro_torch.core.transport.proc import ProcHandle
from repro_torch.core.transport.shm import (MIN_SHM_BYTES, ShmHandle,
                                            ShmRing, detach_all,
                                            dump_pytree_shm)
from repro_torch.core.transport.wire import (MAX_FRAME_BYTES, dump_program,
                                             dump_pytree, load_program,
                                             load_pytree, pack_envelope,
                                             recv_frame, send_frame,
                                             unpack_envelope)
from repro_torch.launch.now import NowPool

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards (set per test, not at import: every xdist worker imports
    every test file)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# programs a worker can import by reference (no cloudpickle needed)
INC = functools.partial(operator.add, 1.0)
DOUBLE = functools.partial(operator.mul, 2.0)


# --------------------------------------------------------------------- #
# wire codec: the same frames rejected, the same envelope bytes
# --------------------------------------------------------------------- #
def _feed(raw: bytes) -> socket.socket:
    a, b = socket.socketpair()
    a.sendall(raw)
    a.close()
    b.settimeout(5.0)
    return b


def _outcome(mod, raw: bytes):
    """What ``mod.recv_frame`` makes of ``raw``: the message, ``None`` (clean
    EOF), or ``("error", type name, message)``."""
    b = _feed(raw)
    try:
        return mod.recv_frame(b)
    except Exception as e:
        return ("error", type(e).__name__, str(e))
    finally:
        b.close()


def _frame(body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + body


BAD_FRAMES = {
    "zero-length": (struct.pack(">I", 0), "zero-length frame"),
    "truncated-header": (b"\x00\x00", "mid-frame header"),
    "truncated-body": (struct.pack(">I", 100) + b"M" + b"x" * 10,
                       "mid-frame body"),
    "corrupt-tag": (_frame(b"Xjunk"), "unknown envelope tag"),
    "corrupt-msgpack": (_frame(b"M\xc1\xc1\xc1"), "corrupt msgpack envelope"),
    "corrupt-pickle": (_frame(b"P\x80\x05junk-not-a-pickle"),
                       "corrupt pickle envelope"),
    "oversized": (struct.pack(">I", MAX_FRAME_BYTES + 1) + b"M" + b"x" * 16,
                  "announced"),
}


@pytest.mark.parametrize("case", sorted(BAD_FRAMES))
def test_bad_frames_fail_as_the_references_do(case):
    raw, match = BAD_FRAMES[case]
    t0 = time.monotonic()
    got = _outcome(wire, raw)
    assert time.monotonic() - t0 < 1.0  # no hang, no giant allocation
    assert got[:2] == ("error", "TransportError") and match in got[2], got
    assert got == _outcome(ref_wire, raw)


def test_zero_length_and_non_dict_envelopes():
    with pytest.raises(TransportError, match="zero-length frame"):
        unpack_envelope(b"")
    msgpack = pytest.importorskip("msgpack")
    raw = _frame(b"M" + msgpack.packb([1, 2, 3]))
    assert _outcome(wire, raw)[2].endswith("expected dict")
    assert _outcome(wire, raw) == _outcome(ref_wire, raw)


def test_fuzz_corrupted_frames_fail_exactly_as_the_references():
    """For the reference's 200 seeded corruptions of a valid frame, the
    port's reader returns what the reference's returns: the same message,
    the same clean EOF, or a TransportError with the same text."""
    frame = pack_envelope({"op": "execute", "uid": 7,
                           "payload": b"\x00" * 50})
    raw = struct.pack(">I", len(frame)) + frame
    rng = random.Random(1306)
    for _ in range(200):
        corrupt = bytearray(raw)
        for _ in range(rng.randint(1, 3)):
            corrupt[rng.randrange(len(corrupt))] = rng.randrange(256)
        got = _outcome(wire, bytes(corrupt))
        assert got is None or isinstance(got, dict) or \
            got[1] == "TransportError", got
        assert got == _outcome(ref_wire, bytes(corrupt))


@pytest.mark.parametrize("codec", ["msgpack", "pickle"])
def test_envelopes_pack_to_the_references_bytes(codec, monkeypatch):
    if codec == "msgpack":
        pytest.importorskip("msgpack")
    else:
        monkeypatch.setattr(wire, "_msgpack", None)
        monkeypatch.setattr(ref_wire, "_msgpack", None)
    for msg in ({"op": "hello"}, {"op": "hello", "shm": True,
                                  "shm_bytes": 1 << 24},
                {"op": "execute", "uid": 12, "payload": b"\x01" * 64},
                {"op": "error", "kind": "ValueError", "message": "m",
                 "traceback": "t"}):
        data = pack_envelope(msg)
        assert data == ref_wire.pack_envelope(msg)
        assert data[:1] == (b"M" if codec == "msgpack" else b"P")
        assert unpack_envelope(data) == msg


def test_pickle_fallback_roundtrip_without_msgpack(monkeypatch):
    monkeypatch.setattr(wire, "_msgpack", None)
    a, b = socket.socketpair()
    try:
        send_frame(a, {"op": "ping"})
        assert recv_frame(b) == {"op": "ping"}
        with pytest.raises(TransportError, match="msgpack"):
            unpack_envelope(b"M\x81")
    finally:
        a.close()
        b.close()


# --------------------------------------------------------------------- #
# payloads and programs
# --------------------------------------------------------------------- #
def test_pytree_roundtrip_moves_tensors_to_compact_cpu_tensors():
    batch = torch.arange(64.0).reshape(16, 4)
    tree = {"a": batch[4:8], "b": [np.float32(2.0), 3], "c": None,
            "d": batch.t()[1], "n": np.arange(3.0)}
    data = dump_pytree(tree)
    out = load_pytree(data)
    assert torch.equal(out["a"], batch[4:8]) and out["a"].is_contiguous()
    assert torch.equal(out["d"], batch[:, 1])
    np.testing.assert_array_equal(out["n"], np.arange(3.0))
    assert out["b"] == [2.0, 3] and out["c"] is None
    # a slice ships its own 16 floats, not the batch's 64
    assert len(dump_pytree(batch[4:8])) < len(dump_pytree(batch))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.int32, torch.bool])
def test_tensors_of_every_dtype_roundtrip_the_wire(dtype):
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(8, 97, generator=g) * 4).to(dtype)  # >= 512 B
    y = load_pytree(dump_pytree({"x": x}))["x"]
    assert y.dtype == dtype and torch.equal(y, x)
    ring = ShmRing(1 << 16)
    try:  # and through the shm ring: raw bytes plus a torch dtype
        z = load_pytree(dump_pytree_shm([x], ring))[0]
        assert z.dtype == dtype and torch.equal(z, x)
        assert ring.bytes_written == x.numel() * x.element_size()
    finally:
        ring.close(unlink=True)
        detach_all()


def test_program_ships_by_value_and_by_reference(monkeypatch):
    pytest.importorskip("cloudpickle")
    q = load_program(dump_program(Program(lambda x: x * 3.0, name="tri")))
    assert q.name == "tri" and not q.host
    assert float(q(torch.tensor(2.0))) == 6.0
    monkeypatch.setattr(wire, "_cloudpickle", None)
    q = load_program(dump_program(Program(INC, name="inc", host=True)))
    assert q.host and q(2.0) == 3.0
    with pytest.raises(TransportError, match="without cloudpickle"):
        dump_program(Program(lambda x: x, name="anon"))


# --------------------------------------------------------------------- #
# liveness: heartbeat death feeds the lease machinery
# --------------------------------------------------------------------- #
class _FakeHandle:
    service_id = "flaky"
    needs_heartbeat = True

    def __init__(self):
        self.alive = True
        self.closed = 0

    def ping(self):
        return self.alive

    def close(self):
        self.closed += 1


def test_liveness_monitor_expires_and_closes_dead_services():
    from repro_torch.sim import virtual_time

    with virtual_time() as clock:
        repo = TaskRepository(["x"], lease_s=60.0, clock=clock)
        tid, _ = repo.get_task("flaky")
        handle = _FakeHandle()
        monitor = LivenessMonitor(interval_s=0.05, timeout_s=0.2, clock=clock)
        monitor.watch(handle, repo.expire_service)
        try:
            handle.alive = False
            got = repo.get_task("survivor", timeout=5.0)
            assert got is not None and got[0] == tid
            assert repo.stats()["reschedules"] == 1
            assert monitor.deaths == 1
            assert clock.monotonic() < 1.0
        finally:
            monitor.stop()
    assert handle.closed >= 1


# --------------------------------------------------------------------- #
# proc:// and shm:// farms on CPU worker processes
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def proc_cluster():
    lookup = LookupService()
    with NowPool(2, lookup, service_prefix="pw", device="cpu") as pool:
        yield lookup, pool


@pytest.fixture(scope="module")
def shm_cluster():
    lookup = LookupService()
    with NowPool(2, lookup, service_prefix="sw", transport="shm",
                 device="cpu") as pool:
        yield lookup, pool
    detach_all()


def _farm_matches_interpret(lookup, prog, tasks):
    reference = interpret(Farm(Seq(prog)), tasks)
    for kwargs in ({}, {"max_batch": 4, "max_inflight": 2}):
        out: list = []
        BasicClient(prog, None, tasks, out, lookup=lookup,
                    speculation=False, **kwargs).compute(timeout=120)
        assert len(out) == len(reference)
        for got, want in zip(out, reference):
            assert got.device.type == "cpu" and torch.equal(got, want)
    # released workers re-register for the next client (Algorithm 2)
    assert lookup.wait_for_services(2, timeout_s=10.0)


def test_proc_farm_per_task_and_batched_match_interpret(proc_cluster):
    lookup, pool = proc_cluster
    assert pool.workers[0].address.startswith("proc://")
    assert pool.workers[0].descriptor.capabilities["device"] == "cpu"
    _farm_matches_interpret(lookup, Program(lambda x: x * x - 1.0,
                                            name="sqm1"),
                            [torch.tensor(float(i)) for i in range(10)])


def test_shm_farm_per_task_and_batched_match_interpret(shm_cluster):
    lookup, _ = shm_cluster
    _farm_matches_interpret(
        lookup, Program(lambda x: x * 2.0 + 1.0, name="aff"),
        [torch.full((2048,), float(i)) for i in range(8)])  # 8 KiB each


def test_proc_bf16_tensors_roundtrip_through_a_worker(proc_cluster):
    _, pool = proc_cluster
    handle = resolve_handle(pool.workers[0].descriptor)
    try:
        x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
        x = x.to(torch.bfloat16)
        y = handle.execute(Program(DOUBLE, name="dbl"), x)
        assert y.dtype == torch.bfloat16 and torch.equal(y, x * 2.0)
        ys = handle.execute_batch(Program(DOUBLE, name="dbl"), [x, x + 1])
        assert isinstance(ys, BatchResults)
        assert torch.equal(ys[1], (x + 1) * 2.0)
    finally:
        handle.close()


def _die_mid_batch_scenario(handle_a, handle_b):
    prog = Program(DOUBLE, name="dbl")
    repo = TaskRepository([torch.tensor(float(i)) for i in range(4)],
                          lease_s=0.2)
    batch_a = repo.get_batch("A", 4, compatible=None)
    assert len(batch_a) == 4
    results_a = handle_a.execute_batch(prog, [p for _, p in batch_a])
    batch_b = repo.get_batch("B", 4, timeout=5.0)
    assert sorted(t for t, _ in batch_b) == sorted(t for t, _ in batch_a)
    assert repo.stats()["reschedules"] == 4
    results_b = handle_b.execute_batch(prog, [p for _, p in batch_b])
    assert repo.complete_batch(
        list(zip([t for t, _ in batch_b], results_b)), "B") == 4
    assert repo.complete_batch(
        list(zip([t for t, _ in batch_a], results_a)), "A") == 0
    assert repo.all_done
    assert [float(v) for v in repo.results()] == [0.0, 2.0, 4.0, 6.0]
    assert repo.stats()["per_service"] == {"B": 4}


@pytest.mark.parametrize("where", ["proc", "inproc"])
def test_expiry_then_release_then_duplicate_completion(where, proc_cluster):
    if where == "proc":
        _, pool = proc_cluster
        handles = [resolve_handle(w.descriptor) for w in pool.workers]
    else:
        handles = [resolve_handle(Service(None, service_id=s,
                                          device="cpu").descriptor())
                   for s in ("ia", "ib")]
    try:
        _die_mid_batch_scenario(*handles)
    finally:
        for h in handles:
            h.close()


def test_proc_remote_program_error_surfaces(proc_cluster):
    pytest.importorskip("cloudpickle")
    lookup, _ = proc_cluster

    def raiser(x):  # nested: cloudpickle ships it by value
        raise ValueError("boom from worker")

    cm = BasicClient(Program(raiser, host=True, name="boom"), None,
                     [torch.tensor(1.0)], [], lookup=lookup,
                     speculation=False)
    with pytest.raises(RemoteProgramError, match="boom from worker"):
        cm.compute(timeout=60)
    assert lookup.wait_for_services(2, timeout_s=10.0)


def test_shm_payload_rides_the_ring_not_the_socket(shm_cluster):
    _, pool = shm_cluster
    handle = resolve_handle(pool.workers[0].descriptor)
    assert isinstance(handle, ShmHandle)
    try:
        prog = Program(INC, name="inc")
        payload = torch.arange(65536, dtype=torch.float32)  # 256 KiB
        nbytes = 65536 * 4
        result = handle.execute(prog, payload)
        assert torch.equal(result, payload + 1.0)
        assert handle.shm_bytes_out >= nbytes
        assert handle.payload_bytes_out < nbytes // 100
        assert handle.payload_bytes_in < nbytes // 100
        results = handle.execute_batch(prog, [payload, payload])
        assert len(results) == 2 and torch.equal(results[1], payload + 1.0)
        assert handle.payload_bytes_in < nbytes // 10
    finally:
        handle.close()
        detach_all()


def test_shm_oversized_payload_degrades_to_inline(shm_cluster):
    _, pool = shm_cluster
    address = pool.workers[1].descriptor.endpoint.split("://", 1)[1]
    handle = ShmHandle(address, ring_bytes=1 << 12)  # 4 KiB ring
    try:
        payload = torch.arange(8192, dtype=torch.float32)  # 32 KiB > ring
        result = handle.execute(Program(DOUBLE, name="dbl"), payload)
        assert torch.equal(result, payload * 2.0)
        assert handle._ring.inline_fallbacks >= 1
        assert handle.payload_bytes_out >= 8192 * 4
    finally:
        handle.close()
        detach_all()


def test_ring_small_leaves_inline_and_wraparound_stays_correct():
    ring = ShmRing(1 << 14)  # 16 KiB: wraps every ~4 messages
    try:
        small = torch.arange(4, dtype=torch.float32)
        assert small.numel() * 4 < MIN_SHM_BYTES
        out = load_pytree(dump_pytree_shm({"s": small}, ring))
        assert torch.equal(out["s"], small) and ring.bytes_written == 0
        for i in range(100):
            arr = torch.full((1024,), float(i))  # 4 KiB
            assert torch.equal(load_pytree(dump_pytree_shm([arr], ring))[0],
                               arr)
    finally:
        ring.close(unlink=True)
        detach_all()


# --------------------------------------------------------------------- #
# SIGKILL mid-run, on the route a bare install takes
# --------------------------------------------------------------------- #
@pytest.fixture
def bare_install(tmp_path, monkeypatch):
    """Neither msgpack nor cloudpickle, in this process and in workers
    started from here (the card's machine has neither)."""
    for name in ("msgpack", "cloudpickle"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f'raise ImportError("{name} is not installed here")\n')
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    monkeypatch.setattr(wire, "_msgpack", None)
    monkeypatch.setattr(wire, "_cloudpickle", None)


def _open_fds() -> int | None:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


@pytest.mark.parametrize("transport", ["proc", "shm"])
def test_sigkill_mid_run_all_tasks_complete(transport, bare_install):
    lookup = LookupService()
    n_tasks = 40 if transport == "proc" else 24
    gc.collect()
    fds_before = _open_fds()
    with NowPool(2, lookup, task_delay_s=0.02, service_prefix=f"k{transport}",
                 transport=transport, device="cpu") as pool:
        victim = pool.workers[0].service_id
        shape = () if transport == "proc" else (1024,)
        tasks = [torch.full(shape, float(i)) for i in range(n_tasks)]
        out: list = []
        cm = BasicClient(Program(INC, name="inc"), None, tasks, out,
                         lookup=lookup, lease_s=5.0, speculation=False,
                         max_batch=4, max_inflight=2)
        killed = threading.Event()

        def killer():
            if cm.repository.wait_until(
                    lambda s: s["per_service"].get(victim, 0) >= 1,
                    timeout=60.0):
                pool.kill(0)  # SIGKILL: no goodbye frames
                killed.set()

        threading.Thread(target=killer, daemon=True).start()
        cm.compute(timeout=120)
        assert killed.is_set(), "victim finished before the kill fired"
        assert not pool.workers[0].alive
        assert len(out) == n_tasks
        for i, got in enumerate(out):
            assert torch.equal(got, torch.full(shape, i + 1.0))
        # the survivor really is a bare install: it cannot import msgpack
        handle = resolve_handle(pool.workers[1].descriptor)
        try:
            probe = Program(functools.partial(importlib.import_module,
                                              "msgpack"), host=True)
            with pytest.raises(RemoteProgramError, match="not installed"):
                handle.execute(probe, None)
        finally:
            handle.close()
    detach_all()
    if fds_before is not None:  # a declared death leaks no socket
        gc.collect()
        deadline = time.monotonic() + 5.0
        while _open_fds() > fds_before + 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert _open_fds() <= fds_before + 3, "socket fds leaked"


# --------------------------------------------------------------------- #
# socket bytes per task: BENCH_wire.json's scenario, reference and port
# --------------------------------------------------------------------- #
def _socket_bytes(handle_cls, address, program, payload, n=3) -> float:
    handle = handle_cls(address)
    try:
        handle.execute(program, payload)  # warm-up, ships the program
        b0, b1 = handle.payload_bytes_out, handle.payload_bytes_in
        for _ in range(n):
            handle.execute(program, payload)
        return (handle.payload_bytes_out - b0
                + handle.payload_bytes_in - b1) / n
    finally:
        handle.close()


def test_socket_bytes_per_task_match_the_references(proc_cluster):
    """The identity task on a 1 MiB fp32 payload (``BENCH_wire.json``:
    proc 2,097,430 and shm 189.63 socket bytes a task).  A worker
    negotiates shm per connection, so one worker of each package serves
    both handles."""
    from repro.core.transport.proc import ProcHandle as RefProcHandle
    from repro.core.transport.shm import ShmHandle as RefShmHandle
    from repro.core.transport.shm import detach_all as ref_detach_all
    from repro.launch.now import NowPool as RefNowPool

    payload = np.arange(262144, dtype=np.float32)
    ref_prog = ref_core.Program(lambda x: x, jit=False, name="ident")
    port_prog = Program(lambda x: x, host=True, name="ident")
    with RefNowPool(1, service_prefix="wire-ref") as ref_pool:
        ref_addr = ref_pool.workers[0].address.split("://", 1)[1]
        ref = {name: _socket_bytes(cls, ref_addr, ref_prog, payload)
               for name, cls in (("proc", RefProcHandle),
                                 ("shm", RefShmHandle))}
    ref_detach_all()
    _, pool = proc_cluster
    addr = pool.workers[0].address.split("://", 1)[1]
    tensor = torch.from_numpy(payload)
    port = {name: _socket_bytes(cls, addr, port_prog, payload)
            for name, cls in (("proc", ProcHandle), ("shm", ShmHandle))}
    port_tensor = {name: _socket_bytes(cls, addr, port_prog, tensor)
                   for name, cls in (("proc", ProcHandle),
                                     ("shm", ShmHandle))}
    detach_all()
    # a numpy payload pickles to the same bytes in both packages, and to
    # the reference's recorded figure
    bench = json.loads((ROOT / "BENCH_wire.json").read_text())["backends"]
    assert port["proc"] == ref["proc"] == \
        bench["proc"]["socket_payload_bytes_per_task"]
    # the shm descriptor names its loader: repro_torch.core.transport.shm
    # is 6 characters longer than repro.core.transport.shm, once each way
    assert port["shm"] - ref["shm"] == 2 * len("_torch")
    # a tensor payload: torch's storage pickling adds a few hundred bytes
    # a direction; on the ring a torch dtype name ("torch.float32")
    # replaces numpy's "<f4", once each way
    assert abs(port_tensor["proc"] - ref["proc"]) <= 0.01 * ref["proc"]
    assert port_tensor["shm"] - port["shm"] == 2 * (len("torch.float32")
                                                    - len("<f4"))


# --------------------------------------------------------------------- #
# the device rule, and imports
# --------------------------------------------------------------------- #
def test_card_worker_without_a_card_exits_instead_of_serving():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is legitimate there")
    with NowPool(1, service_prefix="nocard") as pool:
        assert pool.workers[0].proc.wait(timeout=60) != 0
        assert resolve_handle(pool.workers[0].descriptor) is None


NEW_MODULES = [
    "repro_torch.core.contracts", "repro_torch.core.futures",
    "repro_torch.sim", "repro_torch.sim.clock", "repro_torch.sim.cluster",
    "repro_torch.sim.faults", "repro_torch.core.transport.sim",
    "repro_torch.launch.sim", "repro_torch.obs", "repro_torch.obs.metrics",
    "repro_torch.obs.recorder", "repro_torch.obs.export",
    "repro_torch.core.transport.wire", "repro_torch.core.transport.proc",
    "repro_torch.core.transport.shm", "repro_torch.launch.now",
]


def test_new_modules_import_no_jax_repro_msgpack_or_cloudpickle(tmp_path):
    for name in ("msgpack", "cloudpickle"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f'raise ImportError("{name} is not installed here")\n')
    code = ("import importlib, sys\n"
            f"for name in {NEW_MODULES + ['chip_smoke']!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'msgpack', 'cloudpickle'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
