"""Service discovery — the Jini lookup service, re-homed.

Keeps Jini's *protocol* exactly (paper §2): services **register** a
descriptor; clients issue a **synchronous query** for currently-available
services AND register an **asynchronous observer** that alerts them when new
services appear mid-run (elastic recruitment); a recruited service
**unregisters** (each service serves one client at a time) and re-registers
when released.

The registry is in-process here (a TPU fleet has no JVM multicast); swapping
in etcd/GCS pub-sub means re-implementing exactly these four methods.

What a registration *carries* is an endpoint **address** — an
``"<scheme>://..."`` string resolved through the transport registry
(``repro_torch.core.transport``) at recruitment time: ``inproc://<token>``
for services living in the client's process, ``proc://host:port`` for
worker processes launched by ``repro_torch.launch.now``, and
``tcp://host:port`` for workers launched by ``repro_torch.launch.tcp``,
which register themselves through a network lookup.  The lookup itself
never touches a live service object, which is what makes discovery,
death, and rescheduling real rather than simulated.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

logger = logging.getLogger(__name__)


@dataclass
class ServiceDescriptor:
    service_id: str
    endpoint: Any  # "scheme://address" string (legacy: a live Service)
    capabilities: dict = field(default_factory=dict)
    registered_at: float = field(default_factory=time.monotonic)
    # For inproc endpoints: the live service rides along so that, as in
    # Jini (where the lookup held the service proxy), a registered service
    # stays alive exactly as long as something can still discover it.  The
    # endpoint table itself holds only weak references.  Never resolved
    # through — resolution goes via the transport registry.
    keepalive: Any = field(default=None, repr=False, compare=False)

    @property
    def n_devices(self) -> int:
        return int(self.capabilities.get("n_devices", 1))

    @property
    def peak_flops(self) -> float:
        return float(self.capabilities.get("peak_flops", 0.0))

    @property
    def speed_factor(self) -> float:
        """Advertised relative per-task cost (1.0 = baseline, 4.0 = four
        times slower).  The scheduler uses it to cap the service's lease
        size (``repro_torch.core.batching.speed_capped_max_batch``); observed
        throughput then refines it at runtime."""
        return float(self.capabilities.get("speed_factor", 1.0) or 1.0)


class LookupService:
    """The lookup: register / unregister / query / subscribe.

    ``clock`` follows the farm-wide seam (``repro_torch.core.clock``): the
    blocking :meth:`wait_for_services` and its register/unregister
    wakeups go through it, so a lookup constructed for a simulation
    (``SimCluster`` passes its VirtualClock) waits in virtual time."""

    def __init__(self, clock=None):
        from .clock import REAL_CLOCK

        self._clock = clock if clock is not None else REAL_CLOCK
        self._lock = threading.Condition()
        self._services: dict[str, ServiceDescriptor] = {}
        # (on_register, on_unregister-or-None) pairs
        self._observers: list[tuple[Callable[[ServiceDescriptor], None],
                                    Callable[[str], None] | None]] = []
        #: duplicate registers absorbed without re-notifying observers — a
        #: flaky worker re-registering before its unregister lands
        self.re_registrations = 0

    # -- service side ------------------------------------------------ #
    def register(self, descriptor: ServiceDescriptor) -> None:
        """Register (or refresh) a descriptor.

        A re-register of an already-registered ``service_id`` with the
        *same* endpoint is absorbed silently: the stored descriptor is
        refreshed but ``on_register`` observers do NOT fire again — a
        flaky worker re-registering before its unregister lands must not
        make recruiters double-recruit the same endpoint.  A re-register
        with a *different* endpoint is a re-homed service (e.g. a worker
        restarted on a new port): observers see a paired
        ``on_unregister(old)`` then ``on_register(new)``.
        """
        with self._lock:
            prev = self._services.get(descriptor.service_id)
            self._services[descriptor.service_id] = descriptor
            if prev is not None and prev.endpoint == descriptor.endpoint:
                self.re_registrations += 1
                observers: list = []
                unregister_first: list = []
            elif prev is not None:  # re-homed: new endpoint for a known id
                observers = [cb for cb, _ in self._observers]
                unregister_first = [uncb for _, uncb in self._observers
                                    if uncb is not None]
            else:
                observers = [cb for cb, _ in self._observers]
                unregister_first = []
            self._clock.cond_notify_all(self._lock)
        for uncb in unregister_first:  # retire the stale endpoint first
            try:
                uncb(descriptor.service_id)
            except Exception:
                logger.exception(
                    "lookup observer %r failed while handling re-homing "
                    "of %s", uncb, descriptor.service_id)
        for cb in observers:  # async recruitment path (publish/subscribe)
            try:
                cb(descriptor)
            except Exception:
                # an observer bug must not break registration for everyone
                # else, but swallowing it silently hid real recruiter bugs
                logger.exception(
                    "lookup observer %r failed while handling registration "
                    "of %s", cb, descriptor.service_id)

    def unregister(self, service_id: str) -> None:
        with self._lock:
            known = self._services.pop(service_id, None) is not None
            observers = ([uncb for _, uncb in self._observers
                          if uncb is not None] if known else [])
            self._clock.cond_notify_all(self._lock)
        for uncb in observers:  # Jini's lease-expiry event, in spirit
            try:
                uncb(service_id)
            except Exception:
                logger.exception(
                    "lookup observer %r failed while handling "
                    "unregistration of %s", uncb, service_id)

    def wait_for_services(self, n: int, timeout_s: float = 10.0) -> bool:
        """Block until ≥ ``n`` services are registered (or the timeout
        lapses; returns False then).  Event-driven: woken by every
        register/unregister, so tests waiting for an eventually-consistent
        re-registration (e.g. a released ``proc://`` worker whose release
        RPC is still in flight) don't sleep-poll — under load the wait
        stretches, it never misses."""
        deadline = self._clock.monotonic() + timeout_s
        with self._lock:
            while len(self._services) < n:
                remaining = deadline - self._clock.monotonic()
                if remaining <= 0:
                    return False
                self._clock.cond_wait(self._lock, remaining)
            return True

    # -- client side -------------------------------------------------- #
    def query(self, predicate: Callable[[ServiceDescriptor], bool] | None = None
              ) -> list[ServiceDescriptor]:
        """Synchronous discovery (paper: 'directly queries the Lookup
        Service about the Service Ids of the available services')."""
        with self._lock:
            descs = list(self._services.values())
        if predicate:
            descs = [d for d in descs if predicate(d)]
        return descs

    def subscribe(self, callback: Callable[[ServiceDescriptor], None],
                  on_unregister: Callable[[str], None] | None = None
                  ) -> Callable:
        """Asynchronous discovery: ``callback`` fires for every service
        that registers from now on; the optional ``on_unregister`` fires
        (with the service id) whenever a *known* service leaves the
        registry — the pool-membership signal a long-lived scheduler needs
        for services it has not recruited (a recruited service's death is
        caught by its control thread / heartbeat instead).  Returns an
        unsubscribe handle covering both."""
        entry = (callback, on_unregister)
        with self._lock:
            self._observers.append(entry)

        def unsubscribe():
            with self._lock:
                if entry in self._observers:
                    self._observers.remove(entry)

        return unsubscribe

    def __len__(self) -> int:
        with self._lock:
            return len(self._services)


def new_service_id(prefix: str = "svc") -> str:
    return f"{prefix}-{uuid.uuid4().hex[:8]}"
