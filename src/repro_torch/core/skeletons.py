"""Skeleton AST: the composition language of JJPF.

The paper: *"Programmers must write their applications as an arbitrary
composition of task farm and pipeline computation patterns."*  A ``Program``
is the PyTorch analogue of the paper's ``ProcessIf`` (setData / run /
getData): a function from task payload to result, plus a ``prepare`` step
that binds it to a service's device.  Programs run eagerly: there is no
compile step.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Sequence

import torch
from torch.utils import _pytree as pytree


def to_device(payload, device: torch.device):
    """Move every tensor leaf of a payload pytree onto ``device``."""
    return pytree.tree_map(
        lambda a: a.to(device) if isinstance(a, torch.Tensor) else a, payload)


class Program:
    """ProcessIf analogue.  ``fn`` must be a pure function (pytree -> pytree).

    ``prepare(device)`` returns an eager callable bound to a service's
    device: payload tensors are moved there before ``fn`` runs.  Set
    ``host=True`` for host-side tasks (e.g. I/O simulation in tests):
    payloads are passed through untouched and a batch runs as a host loop.
    """

    _uid_counter = itertools.count()

    def __init__(self, fn: Callable, *, name: str | None = None,
                 host: bool = False):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "program")
        # Stable identity for the services' program caches.  ``id(program)``
        # is unsafe as a cache key: CPython reuses addresses after GC.
        self.uid = next(Program._uid_counter)
        self.host = host

    def prepare(self, device: torch.device | None = None) -> Callable:
        if self.host or device is None:
            return self.fn

        def bound(payload):
            return self.fn(to_device(payload, device))
        return bound

    def prepare_batched(self, device: torch.device | None = None) -> Callable:
        """Callable over a stacked batch: ``torch.func.vmap`` of ``fn``
        computes N tasks (payloads stacked along a new leading axis).
        Host programs run a loop over the list of payloads instead."""
        if self.host:
            def host_loop(payloads):
                return [self.fn(p) for p in payloads]
            return host_loop
        batched = torch.func.vmap(self.fn)
        if device is None:
            return batched

        def bound(stacked):
            return batched(to_device(stacked, device))
        return bound

    def __call__(self, task):
        return self.fn(task)

    def __repr__(self):
        return f"Program({self.name})"


class _Fused:
    """The stages' functions applied in order.  A module-level class, not
    a closure, so that a composed program reaches a ``proc`` or ``tcp``
    worker by reference, as its stages do, where ``cloudpickle`` is not
    installed."""

    def __init__(self, fns):
        self.fns = tuple(fns)

    def __call__(self, task):
        for fn in self.fns:
            task = fn(task)
        return task


def compose_programs(programs: Sequence[Program], name=None) -> Program:
    """Sequential composition g_n ∘ ... ∘ g_1 as ONE program (the payoff
    of the normal form: no host round-trips between stages)."""
    progs = list(programs)
    return Program(_Fused(p.fn for p in progs), name=name or "∘".join(p.name for p in progs),
                   host=any(p.host for p in progs))


# ----------------------------- AST ----------------------------------- #
@dataclass(frozen=True)
class Skeleton:
    def pretty(self) -> str:
        raise NotImplementedError


@dataclass(frozen=True)
class Seq(Skeleton):
    program: Program

    def pretty(self) -> str:
        return f"seq({self.program.name})"


@dataclass(frozen=True)
class Pipe(Skeleton):
    stages: tuple

    def __init__(self, *stages):
        stages = tuple(s if isinstance(s, Skeleton) else Seq(_as_program(s))
                       for s in stages)
        object.__setattr__(self, "stages", stages)

    def pretty(self) -> str:
        return "pipe(" + ", ".join(s.pretty() for s in self.stages) + ")"


@dataclass(frozen=True)
class Farm(Skeleton):
    worker: Skeleton

    def __init__(self, worker):
        if not isinstance(worker, Skeleton):
            worker = Seq(_as_program(worker))
        object.__setattr__(self, "worker", worker)

    def pretty(self) -> str:
        return f"farm({self.worker.pretty()})"


def _as_program(x) -> Program:
    return x if isinstance(x, Program) else Program(x)


# ------------------- reference (sequential) semantics ----------------- #
def interpret(skel: Skeleton, tasks: list) -> list:
    """Denotational reference: what the skeleton means on a task stream.
    Used by tests to check the normal form preserves semantics."""
    if isinstance(skel, Seq):
        return [skel.program(t) for t in tasks]
    if isinstance(skel, Pipe):
        for s in skel.stages:
            tasks = interpret(s, tasks)
        return tasks
    if isinstance(skel, Farm):
        return interpret(skel.worker, tasks)
    raise TypeError(skel)
