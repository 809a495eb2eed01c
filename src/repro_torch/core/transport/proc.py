"""Multiprocess NoW transport: each service is a separate OS process.

Client side, :class:`ProcHandle` speaks the wire protocol (``wire.py``)
over one TCP connection per recruited service.  Worker side,
:class:`ServiceWorker` is the frame-serving loop around the same
``Service`` execution engine the in-process backend uses — Algorithm 2's
"wait for requests", finally waiting on a real socket.  Workers are
launched (and SIGKILLed, for the fault-tolerance experiments) by
:class:`repro_torch.launch.now.NowPool`.

Protocol (every request gets exactly one reply frame):

    hello                       -> {service_id, capabilities}
    recruit {client_id}         -> {ok}
    release                     -> {ok}
    prepare {program}           -> {ok}            (cloudpickled fn)
    execute {uid, payload}      -> {result, cache_hits, cache_misses}
    execute_batch {uid, payloads, pad_to}
                                -> {results, cache_hits, cache_misses}
    ping                        -> {ok, tasks_executed}
    shutdown                    -> {ok}, then the worker exits

Errors come back as ``{op: "error", kind, message, traceback}``; kind
``ServiceFailure`` re-raises as :class:`ServiceFailure` on the client (the
node is gone / fault-injected), anything else as
:class:`RemoteProgramError` (the *program* is buggy — surfaced, never
retried silently).  A dropped connection is a ``ServiceFailure``: exactly
the event the repository's lease machinery reschedules around.
"""

from __future__ import annotations

import os
import socket
import threading
import traceback as _traceback
from typing import Any

from ..batching import BatchResults
from ..errors import RemoteProgramError, ServiceFailure, TransportError
from .base import ServiceHandle, Transport, register_transport
from .wire import (dump_program, dump_pytree, load_program, load_pytree,
                   recv_frame, send_frame)

CONNECT_TIMEOUT_S = 10.0


class ProcHandle(ServiceHandle):
    scheme = "proc"
    needs_heartbeat = True  # a SIGKILLed process sends no goodbye

    def __init__(self, address: str, *, descriptor=None, lookup=None):
        host, _, port = address.rpartition(":")
        self._addr = (host, int(port))
        self._descriptor = descriptor
        self._lookup = lookup
        self._sock = socket.create_connection(self._addr,
                                              timeout=CONNECT_TIMEOUT_S)
        self._sock.settimeout(None)  # requests block for as long as tasks run
        self._lock = threading.Lock()
        self._prepared: set[int] = set()
        self._cache_hits = 0
        self._cache_misses = 0
        # payload bytes that actually crossed the socket (the wire
        # benchmark's currency; shm descriptors count, ring bytes do not)
        self.payload_bytes_out = 0
        self.payload_bytes_in = 0
        self.reconnects = 0
        try:
            hello = self._request(self._hello_msg())
        except ServiceFailure:
            self.close()
            raise
        self.service_id = hello["service_id"]
        self.capabilities = dict(hello["capabilities"])

    # payload codec seam: ShmHandle swaps the dump side for the ring
    def _hello_msg(self) -> dict:
        return {"op": "hello"}

    def _dump(self, tree) -> bytes:
        return dump_pytree(tree)

    def _load(self, data: bytes):
        return load_pytree(data)

    # ------------------------------------------------------------- #
    def _request(self, msg: dict) -> dict:
        with self._lock:
            return self._request_locked(msg)

    def _request_locked(self, msg: dict) -> dict:
        try:
            send_frame(self._sock, msg)
            reply = recv_frame(self._sock)
        except (OSError, TransportError) as e:
            raise ServiceFailure(
                f"service {getattr(self, 'service_id', '?')} unreachable: "
                f"{e}") from e
        if reply is None:
            raise ServiceFailure(
                f"service {getattr(self, 'service_id', '?')} closed the "
                f"connection")
        if reply.get("op") == "error":
            if reply.get("kind") == "ServiceFailure":
                raise ServiceFailure(reply.get("message", "remote failure"))
            raise RemoteProgramError(reply.get("message", "remote error"),
                                     reply.get("traceback", ""))
        self._cache_hits = reply.get("cache_hits", self._cache_hits)
        self._cache_misses = reply.get("cache_misses", self._cache_misses)
        return reply

    # ------------------------------------------------------------- #
    def recruit(self, client_id: str) -> bool:
        ok = bool(self._request({"op": "recruit",
                                 "client_id": client_id}).get("ok"))
        if ok and self._lookup is not None:
            # mirror the in-process Service: a recruited service leaves
            # the lookup until released (single-client discipline)
            self._lookup.unregister(self.service_id)
        return ok

    def release(self) -> None:
        try:
            self._request({"op": "release"})
        except ServiceFailure:
            return  # dead worker: nothing to hand back, don't re-register
        if self._lookup is not None and self._descriptor is not None:
            from ..discovery import ServiceDescriptor

            self._lookup.register(ServiceDescriptor(
                self.service_id, self._descriptor.endpoint,
                dict(self.capabilities)))

    def prepare(self, program) -> None:
        if program.uid in self._prepared:
            return
        self._request({"op": "prepare", "program": dump_program(program)})
        self._prepared.add(program.uid)

    def execute(self, program, payload) -> Any:
        self.prepare(program)
        data = self._dump(payload)
        self.payload_bytes_out += len(data)
        reply = self._request({"op": "execute", "uid": program.uid,
                               "payload": data})
        self.payload_bytes_in += len(reply["result"])
        if self.obs is not None:
            self.obs.event("frame", None, self.service_id, len(data),
                           len(reply["result"]))
        return self._load(reply["result"])

    def execute_batch(self, program, payloads: list, *, block: bool = True,
                      pad_to: int | None = None) -> list:
        # `block` is advisory: results come back serialized, so a proc
        # batch is always materialized — that round-trip cost is the
        # honest price the in-process backend hides (BatchResults with no
        # event: ready on return).
        self.prepare(program)
        data = self._dump(list(payloads))
        self.payload_bytes_out += len(data)
        reply = self._request({"op": "execute_batch", "uid": program.uid,
                               "payloads": data,
                               "pad_to": pad_to})
        self.payload_bytes_in += len(reply["results"])
        if self.obs is not None:
            self.obs.event("frame", None, self.service_id, len(data),
                           len(reply["results"]))
        return BatchResults(self._load(reply["results"]))

    def reconnect(self) -> None:
        """Tear down and re-dial the connection (tcp:// fault recovery).

        The worker's program table is *per connection*, so `_prepared`
        must be invalidated — programs re-ship on first use — or every
        post-reconnect execute would die with "program not prepared".
        Raises ServiceFailure if the endpoint is gone or now hosts a
        different service."""
        with self._lock:
            try:
                self._sock.close()
            except OSError:
                pass
            try:
                self._sock = socket.create_connection(
                    self._addr, timeout=CONNECT_TIMEOUT_S)
                self._sock.settimeout(None)
            except OSError as e:
                raise ServiceFailure(
                    f"service {getattr(self, 'service_id', '?')} "
                    f"unreachable on reconnect: {e}") from e
            self._prepared.clear()
            self.reconnects += 1
            if self.obs is not None:
                self.obs.event("reconnect", None,
                               getattr(self, "service_id", "?"))
            hello = self._request_locked(self._hello_msg())
        if hello["service_id"] != self.service_id:
            self.close()
            raise ServiceFailure(
                f"endpoint {self._addr} now hosts "
                f"{hello['service_id']!r}, expected {self.service_id!r}")

    def ping(self, timeout_s: float = 1.0) -> bool:
        if not self._lock.acquire(blocking=False):
            return True  # mid-request: the socket is demonstrably in use
        try:
            self._sock.settimeout(timeout_s)
            try:
                return bool(self._request_locked({"op": "ping"}).get("ok"))
            finally:
                self._sock.settimeout(None)
        except (ServiceFailure, OSError):
            # The stream is now desynchronized (a late ping reply may still
            # be in flight and would be read as some other request's
            # reply), so the connection is unusable: close it.  The next
            # control-thread request fails fast as a ServiceFailure and
            # the lease machinery reschedules — a false positive on a
            # merely-slow worker is safe, completion is idempotent.
            self.close()
            return False
        finally:
            self._lock.release()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    @property
    def cache_hits(self) -> int:
        return self._cache_hits

    @property
    def cache_misses(self) -> int:
        return self._cache_misses


class ProcTransport(Transport):
    scheme = "proc"

    def resolve(self, descriptor, lookup=None) -> ProcHandle | None:
        address = descriptor.endpoint.split("://", 1)[1]
        try:
            return ProcHandle(address, descriptor=descriptor, lookup=lookup)
        except (OSError, ServiceFailure):
            # stale registration: the worker died while still advertised.
            # Drop it from the lookup so recruiters stop tripping over it.
            if lookup is not None:
                lookup.unregister(descriptor.service_id)
            return None


register_transport(ProcTransport())


# --------------------------------------------------------------------- #
# worker side
# --------------------------------------------------------------------- #
class ServiceWorker:
    """Frame-serving loop around a ``Service`` — Algorithm 2 on a socket.

    One thread per client connection; programs are tracked per connection
    (a reconnecting client re-``prepare``s, so two client processes can
    never collide on program uids).  A client that drops its connection
    without ``release`` implicitly releases the worker."""

    def __init__(self, service, server_sock: socket.socket):
        self.service = service
        self._srv = server_sock

    def serve_forever(self) -> None:
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        programs: dict[int, Any] = {}  # client program uid -> local Program
        state = {"reply_ring": None}  # per-connection shm negotiation
        recruited_here = False
        try:
            while True:
                try:
                    msg = recv_frame(conn)
                except (OSError, TransportError):
                    break
                if msg is None:
                    break
                op = msg.get("op")
                try:
                    reply = self._dispatch(op, msg, programs, state)
                    if op == "recruit":
                        recruited_here = bool(reply.get("ok"))
                    elif op == "release":
                        recruited_here = False
                except ServiceFailure as e:
                    reply = {"op": "error", "kind": "ServiceFailure",
                             "message": str(e)}
                except Exception as e:  # program bug: ship the traceback
                    reply = {"op": "error", "kind": type(e).__name__,
                             "message": f"{type(e).__name__}: {e}",
                             "traceback": _traceback.format_exc()}
                try:
                    send_frame(conn, reply)
                except OSError:
                    break
                if op == "shutdown":
                    os._exit(0)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            if state["reply_ring"] is not None:
                state["reply_ring"].close(unlink=True)
            if recruited_here:
                # client vanished mid-recruitment: free the worker for the
                # next client instead of wedging it forever
                self.service.release()

    @staticmethod
    def _dump_result(tree, state: dict) -> bytes:
        ring = state["reply_ring"]
        if ring is not None:
            from .shm import dump_pytree_shm
            return dump_pytree_shm(tree, ring)
        return dump_pytree(tree)

    def _dispatch(self, op: str, msg: dict, programs: dict,
                  state: dict) -> dict:
        service = self.service
        if op == "hello":
            reply = {"op": "result", "service_id": service.service_id,
                     "capabilities": dict(service.capabilities)}
            if msg.get("shm"):
                # shm:// negotiation: results ride a per-connection reply
                # ring instead of the frame (requests need no negotiation —
                # their descriptors resolve transparently at unpickle)
                from .shm import DEFAULT_RING_BYTES, ShmRing
                if state["reply_ring"] is not None:
                    state["reply_ring"].close(unlink=True)
                state["reply_ring"] = ShmRing(
                    int(msg.get("shm_bytes", DEFAULT_RING_BYTES)))
                reply["shm_ring"] = state["reply_ring"].name
            return reply
        if op == "recruit":
            return {"op": "result",
                    "ok": service.recruit(msg["client_id"])}
        if op == "release":
            service.release()
            return {"op": "result", "ok": True}
        if op == "prepare":
            desc = msg["program"]
            if desc["uid"] not in programs:
                programs[desc["uid"]] = load_program(desc)
            service.prepare(programs[desc["uid"]])
            return {"op": "result", "ok": True}
        if op == "execute":
            program = self._program(programs, msg)
            result = service.execute(program, load_pytree(msg["payload"]))
            return {"op": "result",
                    "result": self._dump_result(result, state),
                    "cache_hits": service.cache_hits,
                    "cache_misses": service.cache_misses}
        if op == "execute_batch":
            program = self._program(programs, msg)
            results = list(service.execute_batch(
                program, load_pytree(msg["payloads"]), block=True,
                pad_to=msg.get("pad_to")))
            return {"op": "result",
                    "results": self._dump_result(results, state),
                    "cache_hits": service.cache_hits,
                    "cache_misses": service.cache_misses}
        if op == "ping":
            return {"op": "result", "ok": service.alive,
                    "tasks_executed": service.tasks_executed}
        if op == "shutdown":
            return {"op": "result", "ok": True}
        raise TransportError(f"unknown op {op!r}")

    @staticmethod
    def _program(programs: dict, msg: dict):
        program = programs.get(msg.get("uid"))
        if program is None:
            raise TransportError(
                f"program uid {msg.get('uid')} not prepared on this "
                f"connection")
        return program
