"""``sim://`` transport: deterministic simulated services behind the facade.

The third backend.  A ``repro_torch.sim.SimService`` registers itself here under
a per-instance token and advertises ``sim://<token>``; resolution is a
dict lookup, exactly like ``inproc://``.  The difference is *when* things
happen: a sim service charges every verb to its cluster's
:class:`repro_torch.sim.VirtualClock` (dispatch latency, per-task compute scaled
by its speed factor, scripted stalls and deaths), while the actual
result computation — the same ``Service`` execution engine the other
backends use — runs instantly in virtual time.

``needs_heartbeat`` is True: simulated nodes can die *silently* on their
fault schedule (the call that was in flight hangs in virtual time instead
of raising), which is precisely the case the ``LivenessMonitor`` →
``TaskRepository.expire_service`` path exists for — so the sim drives the
real liveness machinery, deterministically.

This module deliberately knows nothing about the simulation package; it
holds duck-typed endpoint objects, so importing the transport registry
never drags the simulator in.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any

from .base import ServiceHandle, Transport, register_transport

# endpoint token -> live SimService.  Strong references: a simulation owns
# its services for the cluster's lifetime and unregisters them at close
# (there is no GC-driven lifecycle like inproc's weak table).
_ENDPOINTS: dict[str, Any] = {}
_ENDPOINTS_LOCK = threading.Lock()


def register_sim(service) -> str:
    """Enter a simulated service into the endpoint table; returns its
    per-instance token (stale descriptors must never resolve to a newer
    service that reused the same service_id)."""
    token = f"{service.service_id}-{uuid.uuid4().hex[:8]}"
    with _ENDPOINTS_LOCK:
        _ENDPOINTS[token] = service
    return token


def unregister_sim(token: str) -> None:
    with _ENDPOINTS_LOCK:
        _ENDPOINTS.pop(token, None)


def lookup_sim(token: str):
    with _ENDPOINTS_LOCK:
        return _ENDPOINTS.get(token)


class SimHandle(ServiceHandle):
    scheme = "sim"
    #: sim nodes die silently on their fault schedule — heartbeat them so
    #: the monitor → expire_service path runs under the virtual clock
    needs_heartbeat = True

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
        return self._service.ping()

    @property
    def cache_hits(self) -> int:
        return self._service.engine.cache_hits

    @property
    def cache_misses(self) -> int:
        return self._service.engine.cache_misses


class SimTransport(Transport):
    scheme = "sim"

    def resolve(self, descriptor, lookup=None) -> SimHandle | None:
        token = descriptor.endpoint.split("://", 1)[1]
        service = lookup_sim(token)
        return None if service is None else SimHandle(service)


register_transport(SimTransport())
