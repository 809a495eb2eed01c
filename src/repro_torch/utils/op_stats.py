"""Per-device FLOPs, bytes, collectives and peak memory from the ops a
step dispatches: the reference package's ``repro/utils/hlo.py``, which
reads them from a compiled module's HLO text.

The port runs eagerly, so there is no module to read.  ``OpStatsMode`` is
a ``TorchDispatchMode`` that sees every op the step dispatches on its
local tensors (a DTensor's op reaches it as the local op on this rank's
shard: the mode hands the DTensor-level op back, ``NotImplemented``, as
``FakeTensorMode`` does), and records, per device:

  * ``dot_flops``: each op's count from ``torch.utils.flop_counter``'s
    registry, as ``FlopCounterMode`` counts it (an op the registry lacks is
    decomposed first; ``addmm_`` is counted as ``addmm``, by a mapping of
    this module's own, ``EXTRA_FLOPS``, which a ``FlopCounterMode`` that
    is to count alike takes as its ``custom_mapping``); the hand-written
    kernels' ops carry formulas of their own (``repro_torch.kernels``:
    their plain versions' products, the full grid);
  * ``bytes_accessed``: result bytes plus operand bytes of each op, as the
    reference counts each HLO instruction's; views, allocations, metadata
    ops and the collectives' waits are skipped, as the reference skips
    ``tuple``, ``parameter``, ``constant``, ``bitcast`` and the like;
  * ``collectives``: count, result bytes and ring-model wire bytes per
    kind, from the ``_c10d_functional`` ops (and DTensor's Shard -> Shard
    ``_dtensor::shard_dim_alltoall``, an all-to-all) and their group's
    size, with the reference's formulas: all-reduce 2(g-1)/g, all-gather
    (g-1)/g, reduce-scatter (g-1)x, all-to-all (g-1)/g, anything else 1x;
    an all-to-all that sends to one rank and takes from one is the
    reference's collective-permute (1x);
  * ``peak_bytes``: the most bytes of local storages alive at once, from
    the resident arguments the caller names and every storage an op
    makes, each freed when its last tensor dies;
  * ``kernel_ops``: calls of each kernel op (``repro_torch::...``), and
    the FLOPs they hold (``kernel_flops``).

Eager loops are unrolled, so the reference's trip-count weighting is
implicit: a loop of 7 products dispatches 7.  DTensor's sharding
propagation runs each op once more on global shapes to infer its output
(``_sharding_prop.py``); those ops reach the mode too and are not
counted: ``FlopCounterMode`` counts them, and reads a (2, 4)-sharded
product at 9x its per-device FLOPs.
"""

from __future__ import annotations

import sys
import weakref
from collections import Counter, defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode, is_traceable_wrapper_subclass
from torch.utils._pytree import tree_flatten, tree_leaves
from torch.utils.flop_counter import flop_registry

KERNEL_NAMESPACE = "repro_torch"
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
_DTENSOR_NAMESPACE = "_dtensor"
# op name -> the reference's collective kind (its HLO opcode)
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    # DTensor's Shard -> Shard redistribution (``_dtensor`` namespace)
    "shard_dim_alltoall": "all-to-all",
}
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}
# the ops FlopCounterMode hands back unseen (metadata queries)
_METADATA = {
    torch.ops.aten.sym_is_contiguous.default, torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format, torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default, torch.ops.aten.size.default,
    torch.ops.aten.sym_size.default, torch.ops.aten.stride.default,
    torch.ops.aten.sym_stride.default, torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default, torch.ops.aten.numel.default,
    torch.ops.aten.sym_numel.default, torch.ops.aten.dim.default, torch.ops.prim.layout.default,
}
# allocations: no bytes are read, and what they write is the next op's
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                "empty_permuted", "lift_fresh"}
_SHARDING_PROP = "distributed/tensor/_sharding_prop.py"
# the registry counts addmm and not its in-place form, which the loss's
# table gradient runs (models/loss.py): the same product, counted alike.
# torch's registry is left as it is
def _addmm_flops(*args, **kwargs):
    return flop_registry[torch.ops.aten.addmm](*args, **kwargs)


# already shape-wrapped, as the registry's entries: FlopCounterMode is not to wrap it again
_addmm_flops._get_raw = True
EXTRA_FLOPS = {torch.ops.aten.addmm_: _addmm_flops}


def _formula(packet):
    """The FLOP formula of an op packet, or None."""
    return EXTRA_FLOPS.get(packet) or flop_registry.get(packet)


def wire_bytes(kind: str, size: float, g: int) -> float:
    """Ring-model bytes a device sends for one collective of ``size``
    result bytes over a group of ``g``: the reference's formulas."""
    if kind == "all-reduce":
        return 2 * size * max(g - 1, 0) / max(g, 1)
    if kind in ("all-gather", "all-to-all"):
        return size * max(g - 1, 0) / max(g, 1)
    if kind == "reduce-scatter":
        return size * max(g - 1, 0)
    return size


@dataclass
class CollectiveStats:
    count: dict = field(default_factory=lambda: defaultdict(float))
    result_bytes: dict = field(default_factory=lambda: defaultdict(float))
    wire_bytes: dict = field(default_factory=lambda: defaultdict(float))

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(self.wire_bytes.values()))

    @property
    def total_count(self) -> float:
        return float(sum(self.count.values()))

    def as_dict(self) -> dict:
        return {"count": {k: float(v) for k, v in self.count.items()},
                "result_bytes": {k: float(v) for k, v in self.result_bytes.items()},
                "wire_bytes": {k: float(v) for k, v in self.wire_bytes.items()},
                "total_wire_bytes": self.total_wire_bytes}


@dataclass
class OpAnalysis:
    dot_flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: CollectiveStats = field(default_factory=CollectiveStats)
    peak_bytes: int = 0
    kernel_ops: Counter = field(default_factory=Counter)
    kernel_flops: float = 0.0
    collective_groups: Counter = field(default_factory=Counter)  # "kind@group": count

    def as_dict(self) -> dict:
        return {"dot_flops": self.dot_flops, "bytes_accessed": self.bytes_accessed,
                "collectives": self.collectives.as_dict(),
                "collective_groups": dict(self.collective_groups), "peak_bytes": self.peak_bytes,
                "kernel_ops": dict(self.kernel_ops), "kernel_flops": self.kernel_flops}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _local(t):
    while is_traceable_wrapper_subclass(t) and hasattr(t, "_local_tensor"):
        t = t._local_tensor
    return t


def _a_permute(name: str, args) -> bool:
    """Whether an ``all_to_all_single`` sends to one rank and takes from
    one: the reference's collective-permute (``funcol.permute_tensor``)."""
    if name != "all_to_all_single" or len(args) < 3:
        return False
    return all(sum(1 for n in splits if n) <= 1 for splits in args[1:3])


def _inferring_shapes() -> bool:
    """Whether the op being dispatched is DTensor's shape inference."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_filename.endswith(_SHARDING_PROP):
            return True
        f = f.f_back
    return False


def _group(args, kwargs) -> tuple[int, str]:
    """(size, description) of a collective's process group: a mesh dim's
    group is described by the dims it spans (``mesh_pod``, ...)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a for a in tree_leaves((args, kwargs)) if isinstance(a, str)]
    if not names:
        return 1, ""
    pg = _resolve_process_group(names[-1])
    return pg.size(), getattr(pg, "group_desc", "")


class OpStatsMode(TorchDispatchMode):
    """Records an :class:`OpAnalysis` (``.result``) of the ops dispatched
    while it is entered.  ``resident``: a tree of the tensors that live
    through the step (weights, optimizer state, batch, caches), counted
    alive from the start.  ``last_op``: the op dispatched last (where a
    step that raised stopped)."""

    def __init__(self, resident=()):
        super().__init__()
        self.result = OpAnalysis()
        self.last_op = None
        self._live = 0
        self._storages: set[int] = set()  # ids of the live storages seen
        for t in tree_leaves(resident):
            if isinstance(t, torch.Tensor):
                self._track(_local(t))
        self.result.peak_bytes = self._live

    def _track(self, t) -> None:
        s = t.untyped_storage()
        if id(s) in self._storages:
            return
        n = s.nbytes()
        self._storages.add(id(s))
        self._live += n
        weakref.finalize(s, self._free, id(s), n)

    def _free(self, key: int, n: int) -> None:
        self._storages.discard(key)
        self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        self.last_op = func
        flat, _ = tree_flatten((args, kwargs))
        if any(is_traceable_wrapper_subclass(a) for a in flat):
            return NotImplemented  # the subclass runs its local ops, which come back here
        packet = func._overloadpacket
        if _formula(packet) is None and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if _inferring_shapes():
            return out
        self._count(func, packet, out, args, kwargs, flat)
        return out

    def _count(self, func, packet, out, args, kwargs, flat) -> None:
        res = self.result
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        res.peak_bytes = max(res.peak_bytes, self._live)
        formula = _formula(packet)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
            res.dot_flops += flops
            if func.namespace == KERNEL_NAMESPACE:
                res.kernel_flops += flops
        name = func._opname
        if func.namespace == KERNEL_NAMESPACE:
            res.kernel_ops[name] += 1
        if func.namespace in _COLLECTIVE_NAMESPACES or (
                func.namespace == _DTENSOR_NAMESPACE and name in _KINDS):
            if name in _NOT_COLLECTIVES:
                return
            kind = "collective-permute" if _a_permute(name, args) else _KINDS.get(name, name)
            size = sum(_nbytes(t) for t in outs)
            st = res.collectives
            st.count[kind] += 1
            st.result_bytes[kind] += size
            g, desc = _group(args, kwargs)
            st.wire_bytes[kind] += wire_bytes(kind, size, g)
            res.collective_groups[f"{kind}@{desc}"] += 1
        if func.is_view or name in _ALLOCATIONS or not outs:
            return
        res.bytes_accessed += sum(_nbytes(t) for t in outs) + sum(
            _nbytes(a) for a in flat if isinstance(a, torch.Tensor))


def analyze(fn, *args, resident=(), **kwargs):
    """(``fn(*args, **kwargs)``, its :class:`OpAnalysis`), the
    counterpart of the reference's ``analyze_hlo``."""
    with OpStatsMode(resident) as mode:
        out = fn(*args, **kwargs)
    return out, mode.result


def collective_stats(fn, *args, **kwargs) -> CollectiveStats:
    return analyze(fn, *args, **kwargs)[1].collectives
