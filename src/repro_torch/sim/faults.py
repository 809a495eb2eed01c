"""Scriptable per-service fault schedules for the ``sim://`` backend.

Every field is in **virtual seconds** on the cluster's
:class:`~repro_torch.sim.VirtualClock`.  A fault schedule plus a seed fully
determines a run: the same spec produces the same failure at the same
virtual instant, every time — which is what turns the paper's
fault-tolerance claims from "ran flaky test N times" into invariants.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FaultSpec:
    """What goes wrong with one simulated service, and when.

    die_at
        Virtual time at which the node dies.  A call in flight across
        this instant fails at exactly ``die_at``; later calls fail
        immediately (loud mode) — the analog of a TCP reset.
    silent
        Die *without a goodbye*: the in-flight call hangs for ``hang_s``
        virtual seconds before erroring (the analog of a worker that
        wedges rather than exits), while ``ping()`` already answers
        False.  This is the case only the LivenessMonitor → lease-expiry
        path can recover quickly; loud deaths are caught by the control
        thread's ServiceFailure handling directly.
    hang_s
        How long a silent-death call stays wedged before surfacing.
    stall_at / stall_s
        One-shot straggler injection: the first call whose virtual
        service window covers ``stall_at`` takes ``stall_s`` extra
        virtual seconds (a GC pause / network brown-out).  Long stalls
        exercise lease expiry plus idempotent duplicate completion; short
        ones exercise rate-straggler speculation.
    register_at
        Virtual time of the service's *first* registration (> 0 models a
        late joiner recruited by the elastic subscribe path mid-run).
    flaky_registration
        Probability (per attempt, on the service's seeded RNG) that a
        (re-)registration is dropped — the Jini "lease not renewed" case.
        Dropped attempts are retried after the cluster's
        ``rereg_delay_s``, so a flaky service eventually comes back.
    """

    die_at: float | None = None
    silent: bool = False
    hang_s: float = 30.0
    stall_at: float | None = None
    stall_s: float = 0.0
    register_at: float = 0.0
    flaky_registration: float = 0.0
