"""Performance contracts — the muskel application-manager concept.

The paper (§3, inherited design): *"the concept of application manager that
binds computational resource discovery with autonomic application control in
such a way that optimal resource allocation can be dynamically maintained
upon specification by the user of a performance contract."*

``ParDegreeContract(n)`` asks for n services; the ``ApplicationManager``
thread keeps the farm at the contract by re-querying the lookup (recruiting
replacements after faults, releasing surplus) while the client runs.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass


@dataclass
class ParDegreeContract:
    """Maintain a target parallelism degree."""

    parallelism: int

    def wants_more(self, client) -> bool:
        return client.n_active_services < self.parallelism


class ApplicationManager(threading.Thread):
    """Autonomic control loop: keep the client at its contract."""

    def __init__(self, client, *, interval_s: float = 0.05):
        super().__init__(daemon=True, name="app-manager")
        self.client = client
        self.interval_s = interval_s
        self._stop = threading.Event()
        self.recruit_events = 0

    def run(self) -> None:
        contract = self.client.contract
        while not self._stop.is_set() and not self.client.repository.all_done:
            if contract is None or contract.wants_more(self.client):
                for desc in self.client.lookup.query():
                    if (contract is not None
                            and not contract.wants_more(self.client)):
                        break
                    if self.client.recruit(desc):
                        self.recruit_events += 1
            time.sleep(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
