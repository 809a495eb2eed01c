"""Elastic re-meshing, and heartbeat liveness for services.

JJPF handles task-level faults by rescheduling; re-meshing handles the
SPMD-level fault "a pod (or a slice of it) disappeared": rebuild the
largest viable mesh from the surviving ranks and resume from the latest
checkpoint.  Policy: keep the "model" axis as requested if enough ranks
survive (the tensor-parallel degree is a property of the weights'
layout), shrink the "data"/"pod" axes.

:class:`PodFailureDetector` is fed by the farm transport's
:class:`~repro_torch.core.transport.base.LivenessMonitor`.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..sharding.specs import AXES


def viable_mesh_shape(n_devices: int, *, model: int, prefer_pods: int = 1
                      ) -> tuple[int, ...]:
    """Largest (pod, data, model) with pod*data*model <= n_devices, model
    fixed; the pod axis is kept at ``prefer_pods`` when the survivors still
    divide into that many pods (pod-level fault domains are preserved),
    otherwise it collapses; data shrinks to the largest power of 2."""
    if n_devices < model:
        raise ValueError(
            f"cannot keep model={model} with only {n_devices} devices")
    rest = n_devices // model
    pods = prefer_pods
    while pods > 1 and rest % pods:
        pods -= 1
    data = rest // pods
    # shrink data to a power of two for clean batch splits
    d = 1
    while d * 2 <= data:
        d *= 2
    return (pods, d, model) if pods > 1 else (d, model)


def make_elastic_mesh(shape: tuple[int, ...], ranks=None, *,
                      device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the first prod(shape) of
    ``ranks`` (default: the world's), axes the last ``len(shape)`` of
    ("pod", "data", "model").  Every rank of the world calls it."""
    import torch.distributed as dist

    ranks = list(ranks if ranks is not None else range(dist.get_world_size()))
    n = math.prod(shape)
    if n > len(ranks):
        raise ValueError(f"need {n} devices, have {len(ranks)}")
    axes = AXES[-len(shape):]
    return DeviceMesh(device_type, torch.tensor(ranks[:n]).reshape(shape),
                      mesh_dim_names=axes)


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
