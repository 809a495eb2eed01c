"""The clock seam: every blocking wait and every timestamp in the farm
runtime goes through a :class:`Clock`.

The paper's scheduling claims (pull load balancing on heterogeneous NoWs,
lease-based fault recovery) are *timing* claims, and timing claims are
untestable against a wall clock — CI load turns every threshold into a
flake.  Threading one small interface through the repository, the control
threads, and the liveness monitor lets the whole farm stack run under
either clock:

- :class:`RealClock` (the default, a zero-cost passthrough to
  ``time.monotonic`` / ``Condition.wait``) — production behavior,
  bit-for-bit what the code did before this seam existed;
- :class:`repro.sim.VirtualClock` — a deterministic cooperative scheduler
  that drives the *same* code paths in virtual time (the ``sim://``
  backend), so a 90-second heterogeneous-NoW experiment runs in
  milliseconds and produces the identical task-to-service assignment
  trace on every run.

The contract that makes the virtual clock possible: farm code never calls
``time.monotonic()``, ``time.sleep()``, ``Condition.wait()``,
``Condition.notify_all()`` or ``Event.wait()/set()`` directly on a path a
simulation must control — it calls the clock's equivalents.  Threads that
participate in scheduling are announced to the clock *before* they start
(``thread_spawned``), bind themselves on their first instruction
(``thread_attach``) and sign off on their last (``thread_retire``); on a
real clock all three are no-ops.
"""

from __future__ import annotations

import threading
import time


class Clock:
    """Base interface (and the real-time implementation's shape).

    ``cond_wait``/``cond_notify_all`` MUST be used as a pair on any
    condition a simulation needs to wake: a raw ``notify_all`` would not
    mark virtual waiters ready and they would sleep out their full
    timeout in virtual time.
    """

    #: True only for virtual clocks — lets call sites assert they are not
    #: accidentally mixing managed and unmanaged threads.
    virtual: bool = False

    # -- time ---------------------------------------------------------- #
    def monotonic(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    # -- condition variables ------------------------------------------- #
    def cond_wait(self, cond: threading.Condition, timeout: float) -> None:
        """``cond.wait(timeout)``; the caller holds ``cond``."""
        raise NotImplementedError

    def cond_notify_all(self, cond: threading.Condition) -> None:
        """``cond.notify_all()``; the caller holds ``cond``."""
        raise NotImplementedError

    # -- events -------------------------------------------------------- #
    def event_wait(self, event: threading.Event, timeout: float) -> bool:
        raise NotImplementedError

    def event_set(self, event: threading.Event) -> None:
        raise NotImplementedError

    # -- thread lifecycle (no-ops outside a simulation) ---------------- #
    def thread_spawned(self, thread: threading.Thread) -> None:
        """Announce a thread BEFORE ``thread.start()`` so a simulated
        schedule is deterministic (the scheduler must know the thread
        exists before anyone else blocks)."""

    def thread_attach(self) -> None:
        """First statement of a spawned thread's ``run``."""

    def thread_retire(self) -> None:
        """Last statement (``finally``) of a spawned thread's ``run``."""

    def adopt_current(self) -> None:
        """Enroll the calling (already running) thread, e.g. the main
        thread entering a simulation context."""

    def drain(self) -> None:
        """Let every other enrolled thread run to completion (only
        meaningful on a virtual clock)."""


class RealClock(Clock):
    """Wall-clock passthrough — exactly the pre-seam behavior."""

    virtual = False

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)

    def cond_wait(self, cond: threading.Condition, timeout: float) -> None:
        cond.wait(timeout)

    def cond_notify_all(self, cond: threading.Condition) -> None:
        cond.notify_all()

    def event_wait(self, event: threading.Event, timeout: float) -> bool:
        return event.wait(timeout)

    def event_set(self, event: threading.Event) -> None:
        event.set()


#: Process-wide default; farm components that are not handed a clock use
#: this one (and therefore behave exactly as before the seam existed).
REAL_CLOCK = RealClock()
