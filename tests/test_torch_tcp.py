"""The port's ``tcp://`` transport held to the reference's ``test_tcp.py``.

- The eight scenarios of the reference's file, run through the port on
  the same inputs: the four Jini verbs (plus ``wait_for_services`` and
  ``__len__``) over the wire, a live object refused, owned registrations
  replayed after a lookup restart, a subscription resynced after dropped
  connections, a tcp farm equal to ``interpret()`` per task and batched,
  a reconnect that invalidates prepared programs, workers re-registering
  after a lookup restart, and a SIGKILL mid-run with every task complete.
- The lookup protocol is the reference's byte for byte: a relay between
  a ``RemoteLookup`` and a ``LookupServer`` records every frame, and the
  port's client and server exchange the reference's frames; a client of
  either package speaks to a server of the other.
- Socket bytes per task on ``BENCH_wire.json``'s 1 MiB fp32 payload
  equal its ``tcp`` row.
- A pool asked for the card on a machine without one fails; it never
  serves on the CPU.
- No text of the port names a module of the reference that the port has
  its own counterpart of.

Worker processes: one module-scoped pool of 2 CPU workers (the SIGKILL
scenario runs last on it) and one worker that is asked for the card.
"""

from __future__ import annotations

import json
import re
import socket
import struct
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.discovery as ref_discovery
import repro.core.transport.tcp as ref_tcp
from repro_torch.core import (BasicClient, Farm, Program, Seq, Service,
                              interpret, resolve_handle)
from repro_torch.core.discovery import ServiceDescriptor
from repro_torch.core.errors import TransportError
from repro_torch.core.transport import tcp
from repro_torch.core.transport.tcp import (LookupServer, RemoteLookup,
                                            TcpHandle, descriptor_to_wire)
from repro_torch.launch.tcp import TcpPool

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"port": (tcp, ServiceDescriptor),
            "ref": (ref_tcp, ref_discovery.ServiceDescriptor)}


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards (set per test, not at import: every xdist worker imports
    every test file)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --------------------------------------------------------------------- #
# the lookup protocol over the wire (no workers)
# --------------------------------------------------------------------- #
@pytest.fixture()
def lookup_server():
    server = LookupServer()
    yield server
    server.close()


def _four_verbs(mod, desc_cls, address):
    """The reference's four-verb scenario, with the given package's
    ``RemoteLookup`` against the server at ``address``."""
    lk = mod.RemoteLookup(address)
    try:
        joined, left = [], []
        two, gone = threading.Event(), threading.Event()

        def on_join(d):
            joined.append(d.service_id)
            if len(joined) >= 2:
                two.set()

        def on_leave(sid):
            left.append(sid)
            gone.set()

        lk.subscribe(on_join, on_unregister=on_leave)
        lk.register(desc_cls("a", "tcp://h:1", {"rev": 1}))
        lk.register(desc_cls("b", "tcp://h:2"))
        assert lk.wait_for_services(2, timeout_s=10.0)
        assert len(lk) == 2
        assert {d.service_id for d in lk.query()} == {"a", "b"}
        (got,) = lk.query(lambda d: d.service_id == "a")
        assert got.endpoint == "tcp://h:1" and got.capabilities["rev"] == 1
        assert two.wait(10.0)  # register events arrived over the socket
        lk.unregister("a")
        assert not lk.wait_for_services(2, timeout_s=0.2)
        assert gone.wait(10.0) and left == ["a"]
    finally:
        lk.close()


@pytest.mark.parametrize("client, server", [("port", "port"),
                                            ("port", "ref"), ("ref", "port")])
def test_remote_lookup_speaks_the_four_jini_verbs(client, server):
    """Client and server of either package: the wire is one protocol."""
    srv = PACKAGES[server][0].LookupServer()
    try:
        _four_verbs(*PACKAGES[client], srv.address)
        assert len(srv.lookup) == 1
    finally:
        srv.close()


def test_live_object_descriptor_cannot_cross_the_network(lookup_server):
    lk = RemoteLookup(lookup_server.address)
    try:
        svc = Service(None, service_id="local", device="cpu")
        with pytest.raises(TransportError, match="non-address endpoint"):
            descriptor_to_wire(ServiceDescriptor("local", svc))
        with pytest.raises(TransportError, match="non-address endpoint"):
            lk.register(ServiceDescriptor("local", svc))
        assert len(lk) == 0  # the bad descriptor was never owned or sent
    finally:
        lk.close()


def test_owned_registrations_replay_after_lookup_restart(lookup_server):
    """A lookup crash+restart forgets every registration; a RemoteLookup
    that owns descriptors replays them on its next reconnect — here
    driven by the keepalive, as an idle worker would notice."""
    lk = RemoteLookup(lookup_server.address, keepalive_s=0.05)
    watcher = RemoteLookup(lookup_server.address)
    try:
        lk.register(ServiceDescriptor("w", "tcp://h:9"))
        assert watcher.wait_for_services(1, timeout_s=10.0)
        lookup_server.restart()  # connections die, registry wiped
        assert watcher.wait_for_services(1, timeout_s=30.0)
        (got,) = watcher.query()
        assert got.service_id == "w"
        assert lk.reconnects >= 1
        assert lk.replayed_registrations >= 1
    finally:
        lk.close()
        watcher.close()


def test_subscription_resyncs_after_drop(lookup_server):
    """Events lost during an outage are replaced by a registry replay on
    reconnect."""
    owner = RemoteLookup(lookup_server.address, keepalive_s=0.05)
    sub = RemoteLookup(lookup_server.address)
    try:
        owner.register(ServiceDescriptor("w1", "tcp://h:1"))
        seen, first = [], threading.Event()
        resynced = threading.Event()

        def on_join(d):
            seen.append(d.service_id)
            first.set()
            if seen.count("w1") >= 2:
                resynced.set()  # the replay after reconnect

        sub.subscribe(on_join)
        assert first.wait(10.0)
        lookup_server.drop_connections()  # registry intact, conns dead
        assert resynced.wait(30.0)
    finally:
        owner.close()
        sub.close()


def test_advertised_service_registers_its_network_address(lookup_server):
    """``advertise=``: the descriptor carries the address and pins no
    object, and recruit/release unregister and re-register it through
    the RemoteLookup."""
    lk = RemoteLookup(lookup_server.address)
    try:
        svc = Service(lk, service_id="adv", device="cpu",
                      advertise="tcp://h:7")
        desc = svc.descriptor()
        assert desc.endpoint == "tcp://h:7" and desc.keepalive is None
        assert desc.capabilities["device"] == "cpu"  # a string: it crosses
        svc.start()
        (got,) = lk.query()
        assert (got.endpoint, got.capabilities) == (desc.endpoint,
                                                    desc.capabilities)
        assert svc.recruit("client") and len(lk) == 0
        svc.release()
        assert [d.endpoint for d in lk.query()] == ["tcp://h:7"]
    finally:
        lk.close()


# --------------------------------------------------------------------- #
# the frames themselves, against the reference's
# --------------------------------------------------------------------- #
def _read_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class _Relay:
    """A TCP relay in front of a lookup server that records every frame,
    by connection (in the order they open) and direction."""

    def __init__(self, upstream: str):
        host, _, port = upstream.rpartition(":")
        self._up = (host, int(port))
        self._srv = socket.create_server(("127.0.0.1", 0))
        self.address = f"127.0.0.1:{self._srv.getsockname()[1]}"
        self.conns: list[dict] = []
        self._socks: list[socket.socket] = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self) -> None:
        while True:
            try:
                a, _ = self._srv.accept()
            except OSError:
                return
            b = socket.create_connection(self._up)
            rec = {"up": [], "down": [], "closed": threading.Event()}
            self.conns.append(rec)
            self._socks += [a, b]
            threading.Thread(target=self._pump, args=(a, b, rec["up"]),
                             daemon=True).start()
            threading.Thread(target=self._pump,
                             args=(b, a, rec["down"], rec["closed"]),
                             daemon=True).start()

    @staticmethod
    def _pump(src, dst, frames, closed=None) -> None:
        try:
            while True:
                head = _read_exact(src, 4)
                if head is None:
                    break
                frame = head + _read_exact(src, struct.unpack(">I", head)[0])
                frames.append(frame)
                dst.sendall(frame)
        except (OSError, TypeError):
            pass
        finally:
            try:
                dst.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            if closed is not None:
                closed.set()

    def close(self) -> None:
        self._srv.close()
        for s in self._socks:
            s.close()


def _record_session(name, monkeypatch) -> list[tuple]:
    """Every verb of the given package's RemoteLookup against its own
    LookupServer through a relay: (frames sent, frames received) per
    connection.  ``time.monotonic`` is pinned so that ``wait`` sends the
    same timeout from both packages."""
    mod, desc_cls = PACKAGES[name]
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=lambda: 100.0))
    server = mod.LookupServer()
    relay = _Relay(server.address)
    try:
        lk = mod.RemoteLookup(relay.address)
        try:
            lk.register(desc_cls("a", "tcp://h:1", {"rev": 1, "pid": 7}))
            seen, left = threading.Event(), threading.Event()
            lk.subscribe(lambda d: seen.set(),
                         on_unregister=lambda sid: left.set())
            assert seen.wait(10.0)  # the subscription's resync replayed "a"
            lk.register(desc_cls("b", "tcp://h:2"))
            assert [d.service_id for d in lk.query()] == ["a", "b"]
            assert len(lk) == 2
            assert lk.wait_for_services(2, timeout_s=5.0)
            lk.unregister("a")
            assert left.wait(10.0)
        finally:
            lk.close()
        owner = mod.RemoteLookup(relay.address)
        try:  # a dropped connection: the owned descriptor is replayed
            owner.register(desc_cls("c", "tcp://h:3"))
            n_conns = len(relay.conns)
            server.drop_connections()
            assert relay.conns[-1]["closed"].wait(10.0)
            assert len(owner) == 2
            assert len(relay.conns) == n_conns + 1
            assert owner.replayed_registrations == 2  # first dial, re-dial
        finally:
            owner.close()
    finally:
        relay.close()
        server.close()
    return [(tuple(c["up"]), tuple(c["down"])) for c in relay.conns]


def test_lookup_frames_equal_the_references(monkeypatch):
    port = _record_session("port", monkeypatch)
    ref = _record_session("ref", monkeypatch)
    # the verbs' connection (a first dial replays what the proxy owns, so
    # "register a" goes twice), the subscription's, and the owner's two:
    # "register c" twice, then "count" into the dropped connection, and
    # after the re-dial the replayed "register c" and "count"
    assert [len(up) for up, _ in port] == [8, 1, 3, 2]
    assert port == ref


# --------------------------------------------------------------------- #
# the full farm across the (local) machine boundary
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tcp_cluster():
    # a task delay, as the reference's SIGKILL pool has (0.02 s there):
    # the kill must land while tasks remain, also on a loaded host
    with TcpPool(2, task_delay_s=0.05, service_prefix="tw",
                 device="cpu") as pool:
        yield pool


def test_tcp_farm_matches_interpret(tcp_cluster):
    pool = tcp_cluster
    assert pool.workers[0].address.startswith("tcp://")
    assert {d.capabilities["device"] for d in pool.lookup.query()} == {"cpu"}
    prog = Program(lambda x: x * x - 1.0, name="sqm1")
    tasks = [torch.tensor(float(i)) for i in range(10)]
    reference = interpret(Farm(Seq(prog)), tasks)
    for kwargs in ({}, {"max_batch": 4, "max_inflight": 2}):
        out: list = []
        BasicClient(prog, None, tasks, out, lookup=pool.lookup,
                    speculation=False, **kwargs).compute(timeout=120)
        assert len(out) == len(reference)
        for got, want in zip(out, reference):
            assert got.device.type == "cpu" and torch.equal(got, want)
    # released workers re-register THEMSELVES through their RemoteLookup
    assert pool.lookup.wait_for_services(2, timeout_s=15.0)


def test_tcp_reconnect_invalidates_prepared_programs(tcp_cluster):
    """Worker program tables are per connection, so a reconnected handle
    must re-ship programs."""
    pool = tcp_cluster
    sid = pool.workers[0].service_id
    (desc,) = pool.lookup.query(lambda d: d.service_id == sid)
    handle = resolve_handle(desc)
    assert isinstance(handle, TcpHandle)
    try:
        prog = Program(lambda x: x * 3.0, name="tri")
        assert float(handle.execute(prog, torch.tensor(2.0))) == 6.0
        assert prog.uid in handle._prepared
        handle.reconnect()
        assert handle.reconnects == 1
        assert prog.uid not in handle._prepared
        assert float(handle.execute(prog, torch.tensor(3.0))) == 9.0
    finally:
        handle.close()


def test_socket_bytes_per_task_match_bench_wire(tcp_cluster):
    """The identity task on a 1 MiB fp32 payload costs ``BENCH_wire.json``'s
    ``tcp`` row in socket bytes, measured on the handle's counters as
    ``test_torch_transport.py`` measures ``proc://``."""
    (desc,) = tcp_cluster.lookup.query(
        lambda d: d.service_id == tcp_cluster.workers[1].service_id)
    handle = resolve_handle(desc)
    try:
        prog = Program(lambda x: x, host=True, name="ident")
        payload = np.arange(262144, dtype=np.float32)
        np.testing.assert_array_equal(handle.execute(prog, payload), payload)
        b0, b1 = handle.payload_bytes_out, handle.payload_bytes_in
        for _ in range(3):
            handle.execute(prog, payload)
        per_task = (handle.payload_bytes_out - b0
                    + handle.payload_bytes_in - b1) / 3
    finally:
        handle.close()
    bench = json.loads((ROOT / "BENCH_wire.json").read_text())["backends"]
    assert per_task == bench["tcp"]["socket_payload_bytes_per_task"] \
        == 2097430


def test_tcp_workers_reregister_after_lookup_restart(tcp_cluster):
    """The lookup restarts empty, both workers notice via keepalive and
    replay their registrations, and the farm computes again afterwards."""
    pool = tcp_cluster
    assert pool.lookup.wait_for_services(2, timeout_s=15.0)
    reconnects = pool.lookup.reconnects
    pool.server.restart()
    assert pool.lookup.wait_for_services(2, timeout_s=30.0)
    assert pool.lookup.reconnects == reconnects + 1
    assert ({d.service_id for d in pool.lookup.query()}
            == {w.service_id for w in pool.workers})
    out: list = []
    prog = Program(lambda x: x + 0.5, name="half")
    BasicClient(prog, None, [torch.tensor(float(i)) for i in range(4)], out,
                lookup=pool.lookup, speculation=False).compute(timeout=120)
    assert [float(v) for v in out] == [0.5, 1.5, 2.5, 3.5]
    assert pool.lookup.wait_for_services(2, timeout_s=15.0)


def test_tcp_sigkill_mid_run_all_tasks_complete(tcp_cluster):
    """Worker SIGKILLed mid-batch → heartbeat expires its leases → tasks
    re-lease to the survivor → 100% completion.  Last on the module's
    pool: it leaves one worker."""
    n_tasks = 40
    pool = tcp_cluster
    assert pool.lookup.wait_for_services(2, timeout_s=15.0)
    victim = pool.workers[0].service_id
    prog = Program(lambda x: x + 1.0, name="inc")
    tasks = [torch.tensor(float(i)) for i in range(n_tasks)]
    out: list = []
    cm = BasicClient(prog, None, tasks, out, lookup=pool.lookup,
                     lease_s=5.0, speculation=False, max_batch=4,
                     max_inflight=2)
    killed = threading.Event()

    def killer():
        if cm.repository.wait_until(
                lambda s: s["per_service"].get(victim, 0) >= 1,
                timeout=60.0):
            pool.kill(0)  # SIGKILL: no unregister, no goodbye frames
            killed.set()

    threading.Thread(target=killer, daemon=True).start()
    cm.compute(timeout=120)
    assert killed.is_set(), "victim finished before the kill fired"
    pool.workers[0].proc.wait(timeout=10)
    assert not pool.workers[0].alive
    assert [float(v) for v in out] == [i + 1.0 for i in range(n_tasks)]


# --------------------------------------------------------------------- #
# the device rule, and the port's texts
# --------------------------------------------------------------------- #
def test_card_pool_without_a_card_fails_instead_of_serving():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is legitimate there")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"only 0 of 1 tcp workers.*exited"):
        TcpPool(1, service_prefix="nocard")  # device=None: the card
    # the worker exited with resolve_device's error: the pool failed at
    # once instead of waiting out its start-up timeout
    assert time.monotonic() - t0 < 60.0


def test_port_texts_name_the_ports_own_modules():
    """No text under ``src/repro_torch`` names a ``repro.<module>`` that
    has a ``repro_torch.<module>`` counterpart: a reader who follows it
    would land in the JAX package."""
    src = ROOT / "src" / "repro_torch"
    name = re.compile(r"(?<![\w.])repro((?:\.\w+)+)")
    bad = []
    for path in sorted(p for p in src.rglob("*") if p.is_file()):
        if path.suffix not in (".py", ".cu", ".cuh", ".md", ".txt"):
            continue
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            for m in name.finditer(line):
                parts = m.group(1)[1:].split(".")
                if any(src.joinpath(*parts[:k]).with_suffix(".py").is_file()
                       or src.joinpath(*parts[:k]).is_dir()
                       for k in range(1, len(parts) + 1)):
                    bad.append(f"{path.relative_to(ROOT)}:{lineno}: "
                               f"repro{m.group(1)}")
    assert not bad, bad
