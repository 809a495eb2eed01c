"""Transport abstraction: the ServiceHandle facade and the scheme registry.

Everything above this layer (``ControlThread``, ``BasicClient``,
``FarmExecutor``) talks to a :class:`ServiceHandle`; everything below it is
a backend.  A ``ServiceDescriptor.endpoint`` is an **address string**
(``"inproc://<token>"``, ``"proc://host:port"``) and
:func:`resolve_handle` dispatches on the scheme through the registry —
adding a backend (gRPC, SSH, k8s pod) means registering one
:class:`Transport` and never touching the client or repository code.

Liveness is heartbeat-based and unified with the repository's lease
machinery: a :class:`LivenessMonitor` pings recruited handles, feeds a
:class:`repro_torch.runtime.elastic.PodFailureDetector`, and when the detector
declares a service dead the monitor's callback expires that service's
leases immediately (``TaskRepository.expire_service``) instead of waiting
out the lease deadline.
"""

from __future__ import annotations

import abc
import threading
from typing import Any, Callable

from ..errors import TransportError


class ServiceHandle(abc.ABC):
    """Client-side facade over one service, whatever its transport.

    The contract mirrors the wire protocol verb for verb: ``hello`` is the
    constructor (capabilities arrive with the handle), then
    ``recruit``/``prepare``/``execute``/``execute_batch``/``release``.
    Every method may raise :class:`ServiceFailure` when the node is gone —
    control threads already treat that as "fail the lease back and exit".
    """

    scheme: str = "?"
    #: True when the backend can die silently (a real process) and the
    #: client should heartbeat it; the in-process backend cannot.
    needs_heartbeat: bool = False
    #: optional :class:`repro_torch.obs.Observability` bundle — stamped by the
    #: recruiting :class:`~repro_torch.core.pool.ServicePool` so transports can
    #: record frame/reconnect/shm-ring events; ``None`` = no telemetry.
    obs = None

    service_id: str
    capabilities: dict

    @abc.abstractmethod
    def recruit(self, client_id: str) -> bool:
        """Claim the service for one client; on success it leaves the
        lookup until :meth:`release`."""

    @abc.abstractmethod
    def release(self) -> None:
        """Hand the service back (it re-registers with the lookup)."""

    @abc.abstractmethod
    def prepare(self, program) -> None:
        """Warm the program on the service (ship + jit-wrap as needed)."""

    @abc.abstractmethod
    def execute(self, program, payload) -> Any:
        """Run one task."""

    @abc.abstractmethod
    def execute_batch(self, program, payloads: list, *, block: bool = True,
                      pad_to: int | None = None) -> list:
        """Run a batch of shape-compatible tasks in one round-trip."""

    @abc.abstractmethod
    def ping(self) -> bool:
        """Cheap liveness probe; False means the node is unreachable/dead."""

    def close(self) -> None:
        """Drop client-side resources (sockets); idempotent."""

    # compile-cache telemetry for ``BasicClient.stats()`` — backends that
    # cannot observe it cheaply report the last values seen on the wire.
    @property
    def cache_hits(self) -> int:
        return 0

    @property
    def cache_misses(self) -> int:
        return 0


class Transport(abc.ABC):
    """Resolves endpoint addresses of one scheme into handles."""

    scheme: str = "?"

    @abc.abstractmethod
    def resolve(self, descriptor, lookup=None) -> ServiceHandle | None:
        """Handle for a descriptor, or None if the endpoint is gone (a
        stale registration — callers treat it like a failed recruit)."""


_REGISTRY: dict[str, Transport] = {}
_REGISTRY_LOCK = threading.Lock()


def register_transport(transport: Transport) -> None:
    with _REGISTRY_LOCK:
        _REGISTRY[transport.scheme] = transport


def get_transport(scheme: str) -> Transport:
    with _REGISTRY_LOCK:
        t = _REGISTRY.get(scheme)
    if t is None:
        raise TransportError(f"no transport registered for scheme "
                             f"{scheme!r} (have {sorted(_REGISTRY)})")
    return t


def resolve_handle(descriptor, lookup=None) -> ServiceHandle | None:
    """Descriptor -> handle via the scheme registry.

    Returns None for unresolvable endpoints (None, or an address whose
    service is gone).  A live ``Service`` object as the endpoint is still
    accepted for backward compatibility and resolves in-process."""
    endpoint = descriptor.endpoint
    if endpoint is None:
        return None
    if isinstance(endpoint, str):
        if "://" not in endpoint:
            raise TransportError(f"malformed endpoint address {endpoint!r}")
        scheme = endpoint.split("://", 1)[0]
        return get_transport(scheme).resolve(descriptor, lookup=lookup)
    from .inproc import InProcHandle  # legacy: endpoint IS the service
    return InProcHandle(endpoint)


# --------------------------------------------------------------------- #
# heartbeat-backed liveness
# --------------------------------------------------------------------- #
class LivenessMonitor:
    """Ping watched handles; declare death through a PodFailureDetector.

    One monitor per client.  ``watch(handle, on_dead)`` starts
    heartbeating the handle; a handle that misses pings for ``timeout_s``
    is declared dead exactly once: ``on_dead(service_id)`` fires (the
    client wires this to ``TaskRepository.expire_service``, so the dead
    node's leases re-enqueue immediately) and the handle is dropped."""

    def __init__(self, *, interval_s: float = 0.25, timeout_s: float = 1.5,
                 clock=None):
        from repro_torch.core.clock import REAL_CLOCK
        from repro_torch.runtime.elastic import PodFailureDetector

        self.interval_s = interval_s
        self._clock = clock if clock is not None else REAL_CLOCK
        self._detector = PodFailureDetector([], timeout_s=timeout_s,
                                            clock=self._clock.monotonic)
        self._lock = threading.Lock()
        self._watched: dict[str, tuple[ServiceHandle, Callable[[str], None]]] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.deaths = 0

    def watch(self, handle: ServiceHandle,
              on_dead: Callable[[str], None]) -> None:
        with self._lock:
            self._watched[handle.service_id] = (handle, on_dead)
            self._detector.add_pod(handle.service_id)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="liveness-monitor")
                self._clock.thread_spawned(self._thread)
                self._thread.start()

    def unwatch(self, service_id: str) -> None:
        with self._lock:
            self._watched.pop(service_id, None)
            self._detector.remove_pod(service_id)

    def stop(self) -> None:
        self._clock.event_set(self._stop)

    def _run(self) -> None:
        self._clock.thread_attach()
        try:
            self._run_loop()
        finally:
            self._clock.thread_retire()

    def _run_loop(self) -> None:
        while not self._clock.event_wait(self._stop, self.interval_s):
            with self._lock:
                watched = list(self._watched.items())
            for sid, (handle, _) in watched:
                try:
                    ok = handle.ping()  # slow RPC: outside the lock
                except Exception:
                    ok = False
                if ok:
                    with self._lock:  # watch/unwatch mutate the detector
                        if sid in self._watched:
                            self._detector.heartbeat(sid)
            with self._lock:
                dead = self._detector.dead_pods()
            for sid in dead:
                with self._lock:
                    entry = self._watched.pop(sid, None)
                    self._detector.remove_pod(sid)
                if entry is None:
                    continue
                self.deaths += 1
                handle, on_dead = entry
                try:
                    on_dead(sid)
                except Exception:
                    pass
                # the handle is never coming back: close it (idempotent by
                # contract) or its socket fd leaks on every declared death
                try:
                    handle.close()
                except Exception:
                    pass
