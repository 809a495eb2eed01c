"""Lease bookkeeping — who computes what, until when.

Split out of ``core/repository.py``: the repository is the *task state
machine* (pending → leased → done, streaming, cancellation, results) and
this module is everything about *leases* — ownership sets, deadline
expiry, heartbeat-declared death, and the two speculation policies
(lease-age and rate-straggler).  The split is what lets the scheduler
layer reason about leases without dragging the whole task store along:
the repository composes a :class:`LeaseTable`, and the table never
touches payloads, results, or the pending queue.

Locking contract: a ``LeaseTable`` does NOT lock for itself.  Every
method is called by its owning repository under the repository's
condition lock; the table returns plain verdicts ("these leases lapsed",
"this lease is now unowned") and the repository performs the state
transitions and wakeups they imply.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class Lease:
    """One task's active lease: every service currently computing it."""

    task_id: int
    owners: set = field(default_factory=set)
    start: float = 0.0
    deadline: float = 0.0
    straggler_hit: bool = False  # chosen via the rate-straggler arm


class LeaseTable:
    """Deadline heap + ownership sets + speculation policy.

    ``on_lease`` is the assignment-trace hook: ``(task_id, service_id,
    attempt, t)`` fired on every lease and speculative issue, under the
    repository lock — the trace order IS the lease order.  Keep it cheap
    and never call back into the repository from it.
    """

    def __init__(self, *, lease_s: float = 30.0,
                 speculation_factor: float = 3.0,
                 straggler_rate_factor: float = 0.5,
                 on_lease: Callable | None = None):
        self.lease_s = lease_s
        self.speculation_factor = speculation_factor
        self.straggler_rate_factor = straggler_rate_factor
        self.on_lease = on_lease
        self._leases: dict[int, Lease] = {}
        # (deadline, task_id) min-heap with lazy deletion: expiry scans
        # only the actually-expired prefix instead of the full table
        self._heap: list[tuple[float, int]] = []
        # service_id -> task_ids it holds a lease on: a heartbeat-declared
        # death touches only that service's leases instead of walking the
        # whole table (1,000 services sharing one farm make the full walk
        # per death the dominant recovery cost)
        self._by_owner: dict[str, set[int]] = {}
        self._service_rates: dict[str, float] = {}  # observed tasks/second
        self.speculative_issues = 0
        self.straggler_speculations = 0

    # ---------------- lease lifecycle ------------------------------ #
    def __len__(self) -> int:
        return len(self._leases)

    def _index_owner(self, service_id: str, task_id: int) -> None:
        self._by_owner.setdefault(service_id, set()).add(task_id)

    def _unindex_owner(self, service_id: str, task_id: int) -> None:
        owned = self._by_owner.get(service_id)
        if owned is not None:
            owned.discard(task_id)
            if not owned:
                del self._by_owner[service_id]

    def lease(self, task_id: int, service_id: str, attempt: int,
              now: float) -> None:
        lease = Lease(task_id, {service_id}, start=now,
                      deadline=now + self.lease_s)
        self._leases[task_id] = lease
        self._index_owner(service_id, task_id)
        heapq.heappush(self._heap, (lease.deadline, task_id))
        if self.on_lease is not None:
            self.on_lease(task_id, service_id, attempt, now)

    def issue_speculative(self, task_id: int, service_id: str, attempt: int,
                          now: float) -> None:
        """Second copy of a straggler task (the deadline is the original
        owner's problem; speculative copies never extend it)."""
        lease = self._leases[task_id]
        lease.owners.add(service_id)
        self._index_owner(service_id, task_id)
        self.speculative_issues += 1
        if lease.straggler_hit:
            lease.straggler_hit = False
            self.straggler_speculations += 1
        if self.on_lease is not None:
            self.on_lease(task_id, service_id, attempt, now)

    def _drop_locked(self, lease: Lease) -> None:
        for sid in lease.owners:
            self._unindex_owner(sid, lease.task_id)

    def finish(self, task_id: int) -> Lease | None:
        """The task completed: drop its lease (returns it, for duration
        accounting), or None if no lease was live (a late duplicate)."""
        lease = self._leases.pop(task_id, None)
        if lease is not None:
            self._drop_locked(lease)
        return lease

    def fail(self, task_id: int, service_id: str) -> bool:
        """``service_id`` failed the task back.  Returns True when the
        lease existed and is now unowned (the repository re-enqueues);
        a surviving speculative owner keeps the lease alive."""
        lease = self._leases.get(task_id)
        if lease is None:
            return False
        if service_id in lease.owners:
            lease.owners.discard(service_id)
            self._unindex_owner(service_id, task_id)
        if lease.owners:
            return False
        del self._leases[task_id]
        return True

    def expired(self, now: float) -> list[int]:
        """Leases past their deadline, dropped from the table — the
        repository re-enqueues them.  Pops only the expired prefix of the
        deadline heap, O(k log n) per call; entries are lazily deleted
        (a lease completed, failed back, or re-issued since its entry was
        pushed no longer matches on deadline and is skipped)."""
        lapsed: list[int] = []
        while self._heap and self._heap[0][0] <= now:
            deadline, tid = heapq.heappop(self._heap)
            lease = self._leases.get(tid)
            if lease is None or lease.deadline != deadline:
                continue  # stale entry
            del self._leases[tid]
            self._drop_locked(lease)
            lapsed.append(tid)
        return lapsed

    def expire_service(self, service_id: str) -> list[int]:
        """Heartbeat-declared death: drop every lease held *solely* by
        ``service_id`` (returned for immediate re-enqueue, in task-id
        order) and remove it from shared speculative leases.  Touches
        only the dead service's leases via the owner index — O(owned),
        not O(table)."""
        sole: list[int] = []
        for tid in sorted(self._by_owner.pop(service_id, ())):
            lease = self._leases[tid]
            lease.owners.discard(service_id)
            if not lease.owners:
                del self._leases[tid]
                sole.append(tid)
        return sole

    def clear(self) -> None:
        """Terminal (repository cancelled): no lease may outlive it."""
        self._leases.clear()
        self._heap.clear()
        self._by_owner.clear()

    def next_deadline(self) -> float | None:
        """Earliest live deadline — the cap on repository waits that
        makes expiry event-driven (the waiter that wakes at the deadline
        re-enqueues the lapsed lease itself)."""
        return self._heap[0][0] if self._heap else None

    def owners(self, task_id: int) -> set:
        lease = self._leases.get(task_id)
        return set() if lease is None else lease.owners

    # ---------------- speculation policy ---------------------------- #
    def report_rate(self, service_id: str, tasks_per_s: float) -> bool:
        """Observed per-service throughput (the AIMD controller's EWMA);
        feeds rate-straggler detection.  Returns True when the straggler
        set changed (the repository wakes waiters then — an unconditional
        notify would double every batch's wakeup storm)."""
        before = self._stragglers()
        self._service_rates[service_id] = tasks_per_s
        return self._stragglers() != before

    def _stragglers(self) -> set:
        """Services whose observed completion rate has fallen below
        ``straggler_rate_factor`` × the median across reporting services
        (needs ≥ 2 reporters for a median to mean anything)."""
        if len(self._service_rates) < 2:
            return set()
        rates = sorted(self._service_rates.values())
        med = rates[len(rates) // 2]
        cutoff = self.straggler_rate_factor * med
        return {s for s, r in self._service_rates.items() if r < cutoff}

    def speculation_candidate(self, service_id: str, durations: list[float],
                              now: float) -> int | None:
        """A re-executable straggler task: leased for ≥ speculation_factor
        × the median completion time, OR held solely by a service whose
        reported throughput marks it a rate straggler.  Never a task this
        service already owns, never a third copy."""
        age_ok = len(durations) >= 3
        med = sorted(durations)[len(durations) // 2] if age_ok else 0.0
        stragglers = self._stragglers()
        if service_id in stragglers:
            return None  # a slow node must not duplicate others' work
        for tid in sorted(self._leases):
            lease = self._leases[tid]
            if service_id in lease.owners or len(lease.owners) >= 2:
                continue
            if (age_ok and now - lease.start
                    > self.speculation_factor * max(med, 1e-3)):
                return tid
            if lease.owners and lease.owners <= stragglers:
                lease.straggler_hit = True
                return tid
        return None

    # ---------------- introspection --------------------------------- #
    def stats(self) -> dict:
        return {
            "speculative_issues": self.speculative_issues,
            "straggler_speculations": self.straggler_speculations,
            "service_rates": dict(self._service_rates),
        }
