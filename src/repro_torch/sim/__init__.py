"""Deterministic farm simulation: the ``sim://`` backend's machinery.

- :class:`VirtualClock` — cooperative deterministic scheduler; the whole
  farm stack (repository, control threads, liveness) runs under it
  unmodified through the :class:`repro_torch.core.clock.Clock` seam.
- :class:`FaultSpec` — scriptable per-service fault schedules (death,
  silent hang, stall, late/flaky registration) in virtual seconds.
- :class:`SimCluster` / :class:`SimService` — N virtual workstations with
  speed factors and latency distributions, registered as ``sim://``
  endpoints; same seed ⇒ identical task-to-service assignment trace.
- :func:`virtual_time` — enroll the current thread on a fresh clock, for
  tests that drive clocked components directly.

See ``docs/architecture.md`` ("Deterministic simulation") for the
design, which this package shares with the reference package.
"""

from .clock import VirtualClock  # noqa: F401
from .cluster import SimCluster, SimService, virtual_time  # noqa: F401
from .faults import FaultSpec  # noqa: F401
