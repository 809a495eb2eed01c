"""A JJPF service: the distributed slave, re-homed to one PyTorch device.

Paper Algorithm 2:
    1 network discovery of the LookupService;
    2 while not terminated do
    3    register into lookup;
    4    wait for requests;
    5    unregister from the lookup;   (serve exactly one client)
    6 end

A service owns one device (``cuda:0`` by default, the CPU when asked for)
and executes programs on task payloads.  On a CUDA device it owns a
``torch.cuda.Stream`` of its own: a task runs under that stream, so two
services on one card overlap their work, and completes when the stream is
synchronised.  Fault injection (``kill``, ``fail_after``) and a speed
factor (heterogeneous clusters) are built in for the paper's
fault-tolerance and load-balancing experiments.

Clients never hold this object directly: they hold a ``ServiceHandle``
resolved from the registered endpoint address (``inproc://``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable

import torch

from ..device import resolve_device
from .batching import (BatchResults, pad_stacked, payload_signature,
                       stack_payloads, unstack_results)
from .discovery import LookupService, ServiceDescriptor, new_service_id
from .errors import ServiceFailure  # noqa: F401  (re-exported)
from .skeletons import Program
from .transport.inproc import register_local


class Service:
    def __init__(self, lookup: LookupService | None, *,
                 device: str | torch.device | None = None,
                 service_id: str | None = None, speed_factor: float = 1.0,
                 capabilities: dict | None = None,
                 task_delay_s: float = 0.0):
        self.lookup = lookup
        self.device = resolve_device(device)
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)
        self.service_id = service_id or new_service_id()
        self.speed_factor = speed_factor
        self.task_delay_s = task_delay_s
        caps = {"n_devices": 1, "device": str(self.device),
                "speed_factor": speed_factor}
        caps.update(capabilities or {})
        self.capabilities = caps

        # endpoint token is per-instance: stale descriptors must never
        # resolve to a newer service that reused the same service_id
        self._endpoint_token = register_local(self)

        self._lock = threading.Lock()
        self._alive = True
        self._recruited_by: str | None = None
        self._fail_after: int | None = None
        self._tasks_executed = 0
        # Program cache keyed by (program uid+name, payload signature,
        # batch size); batch_size is None for the per-task path.
        self._compiled: dict[tuple, Callable] = {}
        self._prepared: dict[int, Callable] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self.last_heartbeat = time.monotonic()

    # ---------------- lifecycle (Algorithm 2) ------------------------ #
    def start(self) -> None:
        """Register into the lookup and wait for requests."""
        if self.lookup is not None:
            self.lookup.register(self.descriptor())

    def descriptor(self) -> ServiceDescriptor:
        """Endpoint is an *address*, resolved through the transport
        registry at recruitment — never the live object.  ``keepalive``
        pins this service while it sits in a lookup (the endpoint table is
        weak; see ``transport/inproc.py``)."""
        return ServiceDescriptor(self.service_id,
                                 f"inproc://{self._endpoint_token}",
                                 dict(self.capabilities),
                                 keepalive=self)

    def recruit(self, client_id: str) -> bool:
        """A client claims this service; it unregisters (single-client)."""
        with self._lock:
            if not self._alive or self._recruited_by is not None:
                return False
            self._recruited_by = client_id
        if self.lookup is not None:
            self.lookup.unregister(self.service_id)
        return True

    def release(self) -> None:
        """Client done: re-register for the next one (the while-loop)."""
        with self._lock:
            self._recruited_by = None
            if not self._alive:
                return
        if self.lookup is not None:
            self.lookup.register(self.descriptor())

    # ---------------- execution -------------------------------------- #
    def prepare(self, program: Program) -> None:
        """Bind the program to this service's device (shape-agnostic; the
        shape-keyed cache entries are created at first execution)."""
        with self._lock:
            if program.uid not in self._prepared:
                self._prepared[program.uid] = program.prepare(self.device)

    def drop_programs(self) -> None:
        """Forget every prepared program.  A model program closes over its
        weights, so a long-lived service that moves on to another model
        drops the old programs to free the device memory they hold."""
        with self._lock:
            self._compiled.clear()
            self._prepared.clear()

    def _get_compiled(self, program: Program, payload,
                      batch_size: int | None) -> Callable:
        """Shape-keyed program-cache lookup.  ``batch_size=None`` is the
        per-task path; an integer selects the vmap callable for that batch
        size.  Host programs are shape-agnostic — one entry per path."""
        if program.host:
            key = (program.uid, program.name, None,
                   None if batch_size is None else "host_loop")
        else:
            key = (program.uid, program.name, payload_signature(payload),
                   batch_size)
        with self._lock:
            fn = self._compiled.get(key)
            if fn is not None:
                self.cache_hits += 1
                return fn
            self.cache_misses += 1
        if batch_size is None:
            fn = self._prepared.get(program.uid) or program.prepare(self.device)
        else:
            fn = program.prepare_batched(self.device)
        with self._lock:
            if batch_size is None:
                self._prepared.setdefault(program.uid, fn)
            return self._compiled.setdefault(key, fn)

    @contextlib.contextmanager
    def _on_stream(self):
        """Run the enclosed work on this service's stream.  The stream
        first waits for the device's default stream, so parameters (and
        anything else the caller enqueued there) are complete before a
        task reads them."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self.stream.wait_stream(torch.cuda.default_stream(self.device))
            yield

    def _check_dispatchable(self) -> None:
        """Locked check of liveness + fault injection at batch start (the
        paper's natural descheduling point is the task start)."""
        if not self._alive:
            raise ServiceFailure(f"{self.service_id} is dead")
        if (self._fail_after is not None
                and self._tasks_executed >= self._fail_after):
            self._alive = False
            raise ServiceFailure(f"{self.service_id} failed (injected)")

    def _finish_tasks(self, n: int) -> None:
        with self._lock:
            if not self._alive:  # killed mid-task
                raise ServiceFailure(f"{self.service_id} died mid-task")
            self._tasks_executed += n
            self.last_heartbeat = time.monotonic()

    def execute(self, program: Program, payload) -> Any:
        """Run one task to completion.  Raises ServiceFailure if the node
        is dead or its fault-injection counter fires."""
        with self._lock:
            self._check_dispatchable()
        fn = self._get_compiled(program, payload, None)
        if self.task_delay_s:
            time.sleep(self.task_delay_s)  # network/serialization stand-in
        with self._on_stream():
            result = fn(payload)
        if self.stream is not None:
            self.stream.synchronize()
        if self.speed_factor != 1.0:
            # heterogeneity simulation: slower nodes take proportionally longer
            time.sleep(max(0.0, (self.speed_factor - 1.0)) * 0.002)
        self._finish_tasks(1)
        return result

    def execute_batch(self, program: Program, payloads: list, *,
                      block: bool = True, pad_to: int | None = None) -> list:
        """Run a batch of shape-compatible tasks as ONE call.

        Payloads are stacked along a new leading axis and computed by the
        ``torch.func.vmap`` callable for this (signature, batch size).  With
        ``block=False`` the work may still be running on the service's
        stream: the returned :class:`BatchResults` carries the CUDA event
        recorded after it, and the caller waits on that event later.

        The dispatch round-trip stand-in (``task_delay_s``) is paid once
        per batch — that is the point of batching — while the
        heterogeneity stand-in (``speed_factor``) scales with the number
        of tasks, like real compute would."""
        n = len(payloads)
        if n == 0:
            return []
        with self._lock:
            self._check_dispatchable()
        if self.task_delay_s:
            time.sleep(self.task_delay_s)  # one round-trip per *batch*
        if program.host:
            host_loop = self._get_compiled(program, payloads[0], n)
            results = BatchResults(host_loop(payloads))
        else:
            m = pad_to if pad_to is not None and pad_to > n else n
            fn = self._get_compiled(program, payloads[0], m)
            ready = None
            with self._on_stream():
                stacked = pad_stacked(stack_payloads(payloads), n, m)
                out = fn(stacked)
                per_task = unstack_results(out, n)  # padding rows dropped
                if self.stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(self.stream)
            results = BatchResults(per_task, ready)
            if block:
                results.wait()
        if self.speed_factor != 1.0:
            time.sleep(max(0.0, (self.speed_factor - 1.0)) * 0.002 * n)
        self._finish_tasks(n)
        return results

    # ---------------- fault injection -------------------------------- #
    def kill(self) -> None:
        with self._lock:
            self._alive = False
        if self.lookup is not None:
            self.lookup.unregister(self.service_id)

    def revive(self) -> None:
        with self._lock:
            self._alive = True
            self._fail_after = None
            self._recruited_by = None
        if self.lookup is not None:
            self.lookup.register(self.descriptor())

    def fail_after(self, n_tasks: int) -> None:
        with self._lock:
            self._fail_after = self._tasks_executed + n_tasks

    @property
    def alive(self) -> bool:
        with self._lock:
            return self._alive

    @property
    def tasks_executed(self) -> int:
        with self._lock:
            return self._tasks_executed

    def heartbeat_age(self) -> float:
        return time.monotonic() - self.last_heartbeat
