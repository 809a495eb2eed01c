"""Multi-host NoW transport: discovery itself crosses the network.

``proc://`` already put *services* behind sockets, but its
``LookupService`` stayed an in-process object — every farm stopped at
one host.  ``tcp://`` completes the paper's Network-of-Workstations
premise with two pieces:

:class:`LookupServer`
    Serves a real :class:`~repro_torch.core.discovery.LookupService` over the
    wire protocol (``wire.py`` frames).  Workers on *other hosts*
    register/unregister through it; clients query, block in
    ``wait_for_services``, and subscribe — subscriptions are server-push
    ``event`` frames on a dedicated connection.

:class:`RemoteLookup`
    The client-side proxy implementing the four ``LookupService``
    methods (register / unregister / query / subscribe) plus
    ``wait_for_services`` and ``__len__``, so ``ServicePool``,
    ``FarmScheduler`` and ``BasicClient`` run over it unchanged.  It
    owns the liveness story of the *control plane*: every request
    retries through reconnect-with-backoff, a keepalive thread notices a
    dropped connection even when the owner is idle, and after any
    reconnect the proxy **re-registers every descriptor it owns** — a
    lookup-server restart flows through the same flaky-registration
    fault path the scheduler already absorbs (idempotent re-register,
    subscribe-driven re-recruitment).  The subscription reader similarly
    reconnects and replays the current registry as register events
    (recruitment is idempotent, so replay is safe).

The *data* plane is the proven ``proc://`` machinery: a
:class:`TcpHandle` is a ``ProcHandle`` that never touches the client's
lookup on recruit/release, because a tcp worker owns its own
registration (its ``Service`` holds a ``RemoteLookup`` and an advertised
``tcp://host:port`` endpoint).  Heartbeat-driven ``expire_service`` is
unchanged — a SIGKILLed remote worker's leases re-enqueue exactly as
they do for ``proc://``.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Callable

from ..discovery import LookupService, ServiceDescriptor
from ..errors import ServiceFailure, TransportError
from .base import Transport, register_transport
from .proc import CONNECT_TIMEOUT_S, ProcHandle
from .wire import recv_frame, send_frame


def descriptor_to_wire(desc: ServiceDescriptor) -> dict:
    """Descriptor -> msgpack-able dict.  ``keepalive`` never crosses the
    network (a tcp endpoint has nothing to pin) and the endpoint must
    already be an address string."""
    if not isinstance(desc.endpoint, str):
        raise TransportError(
            f"descriptor {desc.service_id!r} has a non-address endpoint "
            f"({type(desc.endpoint).__name__}); only string endpoints can "
            f"cross the network")
    return {"service_id": desc.service_id, "endpoint": desc.endpoint,
            "capabilities": dict(desc.capabilities)}


def descriptor_from_wire(msg: dict) -> ServiceDescriptor:
    return ServiceDescriptor(msg["service_id"], msg["endpoint"],
                             dict(msg.get("capabilities") or {}))


# --------------------------------------------------------------------- #
# server side
# --------------------------------------------------------------------- #
class LookupServer:
    """A network-reachable lookup: frames in, LookupService verbs out.

    One thread per connection (blocking ``wait`` requests park their own
    thread, never the registry).  ``drop_connections`` and ``restart``
    are fault hooks for the reconnection tests: the former severs every
    live connection (clients must re-dial), the latter additionally
    forgets all registrations — a crashed-and-restarted lookup, which
    workers must absorb by re-registering."""

    def __init__(self, lookup: LookupService | None = None, *,
                 host: str = "127.0.0.1", port: int = 0):
        self.lookup = lookup if lookup is not None else LookupService()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.host, self.port = self._srv.getsockname()
        self._lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._closed = False
        self.connections_served = 0
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="lookup-server-accept").start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns.add(conn)
                self.connections_served += 1
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name="lookup-server-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()  # event pushes race request replies
        unsubscribe = None

        def push_event(kind: str, **fields) -> None:
            try:
                with send_lock:
                    send_frame(conn, {"op": "event", "kind": kind,
                                      **fields})
            except OSError:
                pass  # reader side will notice the dead conn and clean up

        try:
            while True:
                try:
                    msg = recv_frame(conn)
                except (OSError, TransportError):
                    break
                if msg is None:
                    break
                try:
                    reply = self._handle(msg, push_event)
                    if msg.get("op") == "subscribe" and unsubscribe is None:
                        unsubscribe = reply.pop("_unsubscribe")
                except TransportError as e:
                    reply = {"op": "error", "message": str(e)}
                except Exception as e:
                    reply = {"op": "error",
                             "message": f"{type(e).__name__}: {e}"}
                try:
                    with send_lock:
                        send_frame(conn, reply)
                except OSError:
                    break
        finally:
            if unsubscribe is not None:
                unsubscribe()
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, msg: dict, push_event) -> dict:
        op = msg.get("op")
        if op == "register":
            self.lookup.register(descriptor_from_wire(msg["descriptor"]))
            return {"op": "result", "ok": True}
        if op == "unregister":
            self.lookup.unregister(msg["service_id"])
            return {"op": "result", "ok": True}
        if op == "query":
            return {"op": "result",
                    "services": [descriptor_to_wire(d)
                                 for d in self.lookup.query()]}
        if op == "count":
            return {"op": "result", "n": len(self.lookup)}
        if op == "wait":
            ok = self.lookup.wait_for_services(
                int(msg["n"]), timeout_s=float(msg.get("timeout_s", 10.0)))
            return {"op": "result", "ok": ok}
        if op == "subscribe":
            unsub = self.lookup.subscribe(
                lambda d: push_event("register",
                                     descriptor=descriptor_to_wire(d)),
                on_unregister=lambda sid: push_event("unregister",
                                                     service_id=sid))
            return {"op": "result", "ok": True, "_unsubscribe": unsub}
        if op == "ping":
            return {"op": "result", "ok": True}
        raise TransportError(f"unknown lookup op {op!r}")

    # ---------------- fault hooks ---------------------------------- #
    def drop_connections(self) -> None:
        """Sever every live connection (the listener stays up): clients
        and workers must reconnect with backoff."""
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def restart(self) -> None:
        """Simulate a lookup-server crash + restart on the same address:
        all connections die AND all registrations are forgotten.  Workers
        must re-register (RemoteLookup's owned-descriptor replay)."""
        self.drop_connections()
        for desc in self.lookup.query():
            self.lookup.unregister(desc.service_id)

    def close(self) -> None:
        with self._lock:
            self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass
        self.drop_connections()


# --------------------------------------------------------------------- #
# client side
# --------------------------------------------------------------------- #
class RemoteLookup:
    """LookupService proxy over one LookupServer address.

    Implements the Jini four (register/unregister/query/subscribe) plus
    ``wait_for_services``/``__len__`` so every existing consumer —
    ``ServicePool.open``, ``FarmScheduler``, ``BasicClient``, the
    transports' stale-registration cleanup — works unchanged across the
    machine boundary.
    """

    def __init__(self, address: str, *,
                 connect_timeout_s: float = CONNECT_TIMEOUT_S,
                 retry_attempts: int = 8,
                 backoff_s: float = 0.05, backoff_max_s: float = 1.0,
                 keepalive_s: float = 0.0):
        host, _, port = address.rpartition(":")
        self.address = address
        self._addr = (host, int(port))
        self._connect_timeout_s = connect_timeout_s
        self._retry_attempts = retry_attempts
        self._backoff_s = backoff_s
        self._backoff_max_s = backoff_max_s
        self._lock = threading.RLock()
        self._sock: socket.socket | None = None
        self._ever_connected = False
        self._closed = threading.Event()
        # descriptors registered THROUGH this proxy: replayed after every
        # reconnect, so a lookup restart cannot silently forget us
        self._owned: dict[str, ServiceDescriptor] = {}
        self._subscribers: list[tuple[Callable, Callable | None]] = []
        self._sub_thread: threading.Thread | None = None
        self.reconnects = 0
        self.replayed_registrations = 0
        # optional telemetry bundle (repro_torch.obs.Observability); attach
        # post-construction to trace lookup-connection reconnects
        self.obs = None
        if keepalive_s > 0:
            threading.Thread(target=self._keepalive_loop,
                             args=(keepalive_s,), daemon=True,
                             name="remote-lookup-keepalive").start()

    # ---------------- connection machinery -------------------------- #
    def _dial_locked(self) -> None:
        sock = socket.create_connection(self._addr,
                                        timeout=self._connect_timeout_s)
        sock.settimeout(None)
        if self._ever_connected:
            self.reconnects += 1
            if self.obs is not None:
                self.obs.event("reconnect", None, "lookup")
        self._ever_connected = True
        self._sock = sock
        # flaky-registration fault path: whatever we own must be
        # registered on the (possibly restarted) server before any other
        # verb runs on this connection
        for desc in self._owned.values():
            send_frame(sock, {"op": "register",
                              "descriptor": descriptor_to_wire(desc)})
            reply = recv_frame(sock)
            if reply is None or reply.get("op") == "error":
                raise TransportError(
                    f"re-registration of {desc.service_id} rejected: "
                    f"{(reply or {}).get('message', 'connection closed')}")
            self.replayed_registrations += 1

    def _drop_sock_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _request(self, msg: dict, *, timeout_s: float | None = None) -> dict:
        last: Exception | None = None
        backoff = self._backoff_s
        with self._lock:
            for _ in range(self._retry_attempts):
                if self._closed.is_set():
                    raise TransportError(
                        f"RemoteLookup({self.address}) is closed")
                try:
                    if self._sock is None:
                        self._dial_locked()
                    if timeout_s is not None:
                        self._sock.settimeout(timeout_s)
                    try:
                        send_frame(self._sock, msg)
                        reply = recv_frame(self._sock)
                    finally:
                        if timeout_s is not None and self._sock is not None:
                            self._sock.settimeout(None)
                    if reply is None:
                        raise TransportError(
                            "lookup server closed the connection")
                    if reply.get("op") == "error":
                        raise TransportError(reply.get("message", "error"))
                    return reply
                except (OSError, TransportError) as e:
                    last = e
                    self._drop_sock_locked()
                    if self._closed.wait(backoff):
                        break
                    backoff = min(backoff * 2, self._backoff_max_s)
        raise TransportError(
            f"lookup server at {self.address} unreachable: {last}")

    def _keepalive_loop(self, interval_s: float) -> None:
        # an idle worker never issues lookup verbs, so without this it
        # would only discover a lookup restart at its next release —
        # long after recruiters stopped seeing it.  The ping itself
        # triggers reconnect + owned-descriptor replay on failure.
        while not self._closed.wait(interval_s):
            try:
                self._request({"op": "ping"})
            except TransportError:
                pass  # retries exhausted; next tick tries again

    # ---------------- the LookupService surface ---------------------- #
    def register(self, descriptor: ServiceDescriptor) -> None:
        wire_desc = descriptor_to_wire(descriptor)  # validate before owning
        with self._lock:
            self._owned[descriptor.service_id] = descriptor
        self._request({"op": "register", "descriptor": wire_desc})

    def unregister(self, service_id: str) -> None:
        with self._lock:
            self._owned.pop(service_id, None)
        self._request({"op": "unregister", "service_id": service_id})

    def query(self, predicate=None) -> list[ServiceDescriptor]:
        reply = self._request({"op": "query"})
        descs = [descriptor_from_wire(m) for m in reply["services"]]
        if predicate:
            descs = [d for d in descs if predicate(d)]
        return descs

    def wait_for_services(self, n: int, timeout_s: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            try:
                reply = self._request(
                    {"op": "wait", "n": n, "timeout_s": remaining},
                    timeout_s=remaining + 5.0)
                if reply.get("ok"):
                    return True
            except TransportError:
                pass  # server flapped mid-wait: retry with what's left

    def subscribe(self, callback: Callable[[ServiceDescriptor], None],
                  on_unregister: Callable[[str], None] | None = None
                  ) -> Callable:
        entry = (callback, on_unregister)
        with self._lock:
            self._subscribers.append(entry)
            if self._sub_thread is None:
                self._sub_thread = threading.Thread(
                    target=self._subscription_loop, daemon=True,
                    name="remote-lookup-subscription")
                self._sub_thread.start()

        def unsubscribe():
            with self._lock:
                if entry in self._subscribers:
                    self._subscribers.remove(entry)

        return unsubscribe

    def _subscription_loop(self) -> None:
        backoff = self._backoff_s
        while not self._closed.is_set():
            sock = None
            try:
                sock = socket.create_connection(
                    self._addr, timeout=self._connect_timeout_s)
                sock.settimeout(None)
                send_frame(sock, {"op": "subscribe"})
                ack = recv_frame(sock)
                if ack is None or not ack.get("ok"):
                    raise TransportError("subscribe rejected")
                backoff = self._backoff_s
                # resync: events during an outage are gone — replay the
                # current registry as register events (recruitment is
                # idempotent, and the duplicate-registration guard keeps
                # local lookups from double-notifying anyway)
                for desc in self.query():
                    self._fire_register(desc)
                while True:
                    msg = recv_frame(sock)
                    if msg is None:
                        raise TransportError("subscription closed")
                    if msg.get("op") != "event":
                        continue
                    if msg.get("kind") == "register":
                        self._fire_register(
                            descriptor_from_wire(msg["descriptor"]))
                    elif msg.get("kind") == "unregister":
                        self._fire_unregister(msg["service_id"])
            except (OSError, TransportError):
                if self._closed.wait(backoff):
                    break
                backoff = min(backoff * 2, self._backoff_max_s)
            finally:
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass

    def _fire_register(self, desc: ServiceDescriptor) -> None:
        with self._lock:
            subs = [cb for cb, _ in self._subscribers]
        for cb in subs:
            try:
                cb(desc)
            except Exception:
                pass

    def _fire_unregister(self, service_id: str) -> None:
        with self._lock:
            subs = [uncb for _, uncb in self._subscribers
                    if uncb is not None]
        for uncb in subs:
            try:
                uncb(service_id)
            except Exception:
                pass

    def __len__(self) -> int:
        return int(self._request({"op": "count"})["n"])

    def close(self) -> None:
        self._closed.set()
        with self._lock:
            self._drop_sock_locked()


# --------------------------------------------------------------------- #
# the tcp:// data plane
# --------------------------------------------------------------------- #
class TcpHandle(ProcHandle):
    """Remote-worker handle: proc's wire protocol, but registration is
    the *worker's* job (its Service holds a RemoteLookup and an
    advertised ``tcp://`` endpoint), so recruit/release never touch the
    client-side lookup — the unregister/re-register events arrive
    through the subscription instead."""

    scheme = "tcp"
    needs_heartbeat = True

    def __init__(self, address: str, *, descriptor=None, lookup=None):
        # deliberately drop the lookup: the remote worker re-registers
        # itself on release; a client-side register would race it with a
        # stale descriptor
        super().__init__(address, descriptor=descriptor, lookup=None)


class TcpTransport(Transport):
    scheme = "tcp"

    def resolve(self, descriptor, lookup=None) -> TcpHandle | None:
        address = descriptor.endpoint.split("://", 1)[1]
        try:
            return TcpHandle(address, descriptor=descriptor, lookup=lookup)
        except (OSError, ServiceFailure):
            # stale registration (worker died without unregistering):
            # drop it so recruiters stop tripping over it
            if lookup is not None:
                try:
                    lookup.unregister(descriptor.service_id)
                except TransportError:
                    pass  # the lookup itself is unreachable right now
            return None


register_transport(TcpTransport())
