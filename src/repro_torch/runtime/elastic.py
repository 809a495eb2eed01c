"""Heartbeat liveness for services.

Only :class:`PodFailureDetector` is ported: the farm transport's
:class:`~repro_torch.core.transport.base.LivenessMonitor` feeds it.  The
SPMD re-meshing half of the reference module has no counterpart yet.
"""

from __future__ import annotations


class PodFailureDetector:
    """Heartbeat-based liveness for pods (services).  In-process stand-in
    for a fleet health service: pods publish heartbeats; the controller
    declares a pod dead after ``timeout_s`` silence and triggers re-meshing."""

    def __init__(self, pod_ids, *, timeout_s: float = 5.0, clock=None):
        import time

        self._clock = clock or time.monotonic
        self.timeout_s = timeout_s
        self._last = {p: self._clock() for p in pod_ids}

    def add_pod(self, pod_id) -> None:
        """Start tracking a pod (counts as a fresh heartbeat).  Used by the
        farm transport's LivenessMonitor, which watches a changing set of
        recruited services rather than a fixed fleet."""
        self._last[pod_id] = self._clock()

    def remove_pod(self, pod_id) -> None:
        self._last.pop(pod_id, None)

    def heartbeat(self, pod_id) -> None:
        self._last[pod_id] = self._clock()

    def dead_pods(self) -> list:
        now = self._clock()
        return [p for p, t in self._last.items() if now - t > self.timeout_s]

    def alive_pods(self) -> list:
        now = self._clock()
        return [p for p, t in self._last.items() if now - t <= self.timeout_s]
