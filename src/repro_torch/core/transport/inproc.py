"""In-process transport: today's zero-copy behavior, now behind the facade.

A ``Service`` registers itself in a process-local endpoint table under a
per-instance token and advertises ``inproc://<token>`` as its endpoint.
Resolution is a dict lookup; the handle delegates every verb to the live
object, so payloads and results never cross a serialization boundary —
this is the default backend and the baseline the ``proc`` backend's costs
are measured against.

Tokens are per-*instance* (uuid-suffixed), not per-service-id: benchmarks
re-use ids like ``"s0"`` across runs, and a stale descriptor must not
resolve to a newer, unrelated service object.
"""

from __future__ import annotations

import threading
import uuid
import weakref
from typing import Any

from .base import ServiceHandle, Transport, register_transport

# endpoint token -> live Service.  Weak values: the table must never be
# the thing keeping a service alive, or every Service ever constructed
# (with its cache of prepared programs) leaks for the process
# lifetime.  What pins a registered service is its descriptor's
# ``keepalive`` field sitting in a LookupService — exactly Jini, where the
# lookup held the service proxy — and a recruited service is pinned by the
# client's InProcHandle.
_SERVICES: "weakref.WeakValueDictionary[str, Any]" = (
    weakref.WeakValueDictionary())
_SERVICES_LOCK = threading.Lock()


def register_local(service) -> str:
    """Enter a live service into the endpoint table; returns its token."""
    token = f"{service.service_id}-{uuid.uuid4().hex[:8]}"
    with _SERVICES_LOCK:
        _SERVICES[token] = service
    return token


def lookup_local(token: str):
    with _SERVICES_LOCK:
        return _SERVICES.get(token)


class InProcHandle(ServiceHandle):
    scheme = "inproc"
    needs_heartbeat = False  # an object in our own process can't vanish

    def __init__(self, service):
        self._service = service
        self.service_id = service.service_id
        self.capabilities = dict(service.capabilities)

    def recruit(self, client_id: str) -> bool:
        return self._service.recruit(client_id)

    def release(self) -> None:
        self._service.release()

    def prepare(self, program) -> None:
        self._service.prepare(program)

    def execute(self, program, payload) -> Any:
        return self._service.execute(program, payload)

    def execute_batch(self, program, payloads: list, *, block: bool = True,
                      pad_to: int | None = None) -> list:
        return self._service.execute_batch(program, payloads, block=block,
                                           pad_to=pad_to)

    def ping(self) -> bool:
        return self._service.alive

    @property
    def cache_hits(self) -> int:
        return self._service.cache_hits

    @property
    def cache_misses(self) -> int:
        return self._service.cache_misses


class InProcessTransport(Transport):
    scheme = "inproc"

    def resolve(self, descriptor, lookup=None) -> InProcHandle | None:
        token = descriptor.endpoint.split("://", 1)[1]
        service = lookup_local(token)
        return None if service is None else InProcHandle(service)


register_transport(InProcessTransport())
