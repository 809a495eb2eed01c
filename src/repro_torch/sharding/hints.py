"""Sharding hints that models can emit without knowing the mesh.

Model code calls ``shard_hint(x, kind)``.  If the runtime has announced
mesh axes (``with mesh_axes(("pod", "data", "model")):``) and ``x`` is a
DTensor, ``x`` is redistributed to the hint's layout (the reference's
``with_sharding_constraint``); otherwise (one device, plain tensors) the
hint returns ``x`` itself.  This keeps the model definitions mesh-agnostic
while letting the launcher pin the layouts that matter (vocab-sharded
logits, the MoE's expert batches).

``current_mesh`` is the ambient ``DeviceMesh``: the one set by
``with use_mesh(mesh):``, as ``with mesh:`` sets jax's.  The
tensor-parallel attention (``kernels/{flash,decode}_attention/sharded.py``)
runs under it.  Both the axes and the mesh are per thread.

``implicit_replication`` sets one flag of DTensor's op dispatcher for the
whole process and clears it on exit, so ``use_mesh`` enters it only at
the outermost ``use_mesh`` of the process (a count under a lock): a nested
one, or one that another thread leaves, does not clear it under a mesh
that is still in use.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map
from torch.utils._python_dispatch import _disable_current_modes

from .specs import (AXES, P, _dp, cache_partition_specs, distribute, mesh_sizes, placements,
                    sanitize_spec)

# all_gather_tensor under its newer name, where torch has it
_all_gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
_ctx = threading.local()
_replication_lock = threading.Lock()
_replication_users = 0
_replication = None  # the process's implicit_replication context, while entered


def current_axes() -> tuple[str, ...] | None:
    return getattr(_ctx, "axes", None)


def current_mesh():
    """The ambient ``DeviceMesh`` (``with use_mesh(mesh):``), or None."""
    return getattr(_ctx, "mesh", None)


@contextlib.contextmanager
def mesh_axes(axes):
    prev = getattr(_ctx, "axes", None)
    _ctx.axes = tuple(axes) if axes else None
    try:
        yield
    finally:
        _ctx.axes = prev


@contextlib.contextmanager
def use_mesh(mesh):
    """Makes ``mesh`` the ambient mesh of this thread (None: no mesh).
    Inside it a plain tensor that meets a DTensor in an op (a position
    range, a mask) is taken as replicated on the mesh
    (``implicit_replication``), as jax takes a constant."""
    global _replication, _replication_users
    prev = getattr(_ctx, "mesh", None)
    with _replication_lock:
        if _replication_users == 0:
            _replication = implicit_replication()
            _replication.__enter__()
        _replication_users += 1
    _ctx.mesh = mesh
    try:
        yield mesh
    finally:
        _ctx.mesh = prev
        with _replication_lock:
            _replication_users -= 1
            if _replication_users == 0:
                _replication.__exit__(None, None, None)
                _replication = None


def spec_for(kind: str, axes, ndim: int) -> P:
    dp = _dp(axes)
    model = "model" if "model" in axes else None
    if kind == "activations":  # (B, S, d) — sequence-parallel over "model"
        return P(dp, model, None)
    if kind == "logits":  # (B, S, V) or (B, V)
        if ndim == 2:
            return P(dp, model)
        return P(dp, None, model)
    if kind == "batch_tokens":  # (B, S)
        return P(dp, None)
    if kind == "batch_rows":  # (B, ...): batch over dp, whole over "model"
        return P(dp)
    if kind == "mamba_channels":  # (B, S, d_inner): d_inner over "model" (the
        # reference's _pin_d / _pin_xs in its chunked scan)
        return P(dp, None, model)
    if kind == "moe_dispatch":  # (groups, G, E, C): groups over dp, EP over model
        return P(dp, None, model, None)
    if kind == "moe_expert_batch":  # (E, groups, C, d): EP over model
        return P(model, dp, None, None)
    raise KeyError(kind)


def shard_hint(x, kind: str):
    """``x`` redistributed to ``kind``'s layout on its mesh (sanitized for
    the mesh's sizes); ``x`` itself when no axes are announced or ``x`` is
    not a DTensor."""
    axes = current_axes()
    if not axes or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    spec = sanitize_spec(spec_for(kind, axes, x.ndim), x.shape, mesh_sizes(mesh))
    return x.redistribute(mesh, placements(spec, mesh))


def _reduced(x):
    """``x`` with each ``Partial`` placement over more than one rank made
    ``Replicate`` (a sum over one rank is already whole)."""
    mesh = x.device_mesh
    place = [Replicate() if p.is_partial() and mesh.size(i) > 1 else p
             for i, p in enumerate(x.placements)]
    return x if place == list(x.placements) else x.redistribute(mesh, place)


class _ReducePartial(torch.autograd.Function):
    """The identity, with partial sums reduced both ways: in the forward
    on ``x``, in the backward on its gradient (which a column-parallel
    product's input gradient leaves partial)."""

    @staticmethod
    def forward(ctx, x):
        return _reduced(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g) if isinstance(g, DTensor) else g


def reduce_partial(x):
    """``x`` with its partial sums reduced (each ``Partial`` placement made
    ``Replicate``: an all-reduce), and its gradient's too; ``x`` itself
    when it is not a DTensor.  For a norm's input, the residual stream
    after a row-parallel product: DTensor would carry the partial sum
    through the norm's last factor and into the next product, which then
    gathers its weight whole on every rank, and the backward would carry
    the column-parallel products' partial input gradients down the stream
    into the row-parallel products' gradients alike.  GSPMD reduces
    first, Megatron-style, and keeps the products tensor-parallel.  On a
    one-rank mesh it is ``x`` itself: nothing there is partial."""
    if not isinstance(x, DTensor) or x.device_mesh.size() == 1:
        return x
    return _ReducePartial.apply(x)


def contraction_layout(x, w):
    """``x`` (..., d) laid out as ``x @ w`` takes it where ``w``'s rows
    (``x``'s last dim) and ``x``'s rows are split over the same mesh dim:
    its last dim moved there, by one all-to-all.  A one-token serving step
    contracts over "data" so (its weights' rows are over "data"); DTensor
    makes that move for each product it meets, and made once, the products
    of one input (q, k and v; an MLP's first two) share it, as the
    reference's partitioner does.  ``x`` itself where neither is a DTensor
    or nothing moves."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x
    last = x.ndim - 1
    place = [Shard(last) if p.is_shard(0) and q.is_shard(0) else p
             for p, q in zip(x.placements, w.placements)]
    return x if place == list(x.placements) else x.redistribute(x.device_mesh, place)


def _waited(y):
    return y.wait() if isinstance(y, funcol.AsyncCollectiveTensor) else y


def _all_to_all(t: torch.Tensor, outs: list, ins: list, group) -> torch.Tensor:
    """``t`` flattened through ``all_to_all_single`` over ``group``: ``ins``
    elements to each rank, ``outs`` from each."""
    return _waited(funcol.all_to_all_single(t.contiguous().view(-1), outs, ins, group))


def _part_peers(k: int, group) -> tuple[list, list]:
    """(to, fro) of ``_SplitLast`` on this rank of ``group`` (M ranks):
    its block's i-th sub-block goes to ``to[i]``, part p's sub-block comes
    from ``fro[p]``.  Rank m's block is part m // (M / k)'s sub-blocks
    (m % (M / k)) k ... + k - 1, one for each of those ranks."""
    M, m = group.size(), group.get_local_rank()
    per = M // k
    return [(m % per) * k + i for i in range(k)], [p * per + m // k for p in range(k)]


def _exchange(parts: torch.Tensor, to: list, fro: list, group) -> torch.Tensor:
    """``parts`` (k, ...): part i sent to rank ``to[i]``, and what rank
    ``fro[i]`` sends this rank in its place, as (k, ...); each list in
    increasing order (``all_to_all_single`` lays its buffers out by rank)."""
    n, size = parts[0].numel(), group.size()
    ins, outs = [0] * size, [0] * size
    for i in range(len(to)):
        ins[to[i]], outs[fro[i]] = n, n
    return _all_to_all(parts, outs, ins, group).view(parts.shape)


class _SplitLast(torch.autograd.Function):
    """A rank's contiguous block (..., k w) of a last dim of k parts, laid
    out in ``group``'s blocks, -> its own sub-block (..., w) of each part,
    by one all-to-all over ``group``; the backward sends the gradients
    back the same way."""

    @staticmethod
    def forward(ctx, block, k, group):
        to, fro = _part_peers(k, group)
        w = block.shape[-1] // k
        chunks = torch.stack([block[..., i * w:(i + 1) * w] for i in range(k)])
        ctx.k, ctx.group = k, group
        return tuple(_exchange(chunks, to, fro, group).unbind(0))

    @staticmethod
    def backward(ctx, *grads):
        to, fro = _part_peers(ctx.k, ctx.group)
        like = next(g for g in grads if g is not None)
        parts = torch.stack([torch.zeros_like(like) if g is None else g for g in grads])
        return torch.cat(_exchange(parts, fro, to, ctx.group).unbind(0), -1), None, None


def split_channels(x, k: int) -> tuple:
    """``x`` (..., k n) -> its k parts (..., n), each laid out on its own
    channels (``mamba_channels``: the last dim over "model").  Where ``x``
    is a DTensor whose last dim is over "model" alone, M contiguous blocks
    (a column-parallel product's output), with M a multiple of k and n of
    M, one all-to-all over "model" hands each rank its channels of every
    part: the reference's partitioner moves the same blocks (with
    collective-permutes).  Otherwise ``x`` is gathered whole over "model"
    and each part sliced."""
    n = x.shape[-1] // k
    if current_axes() and isinstance(x, DTensor):
        mesh, last = x.device_mesh, x.ndim - 1
        names = tuple(mesh.mesh_dim_names)
        cut = [i for i, p in enumerate(x.placements) if p.is_shard(last)]
        M = mesh_sizes(mesh).get("model", 1)
        model = names.index("model") if "model" in names else None
        if cut == [model] and M % k == 0 and n % M == 0 and not any(
                p.is_partial() for p in x.placements):
            place = list(x.placements)
            group = mesh["model"]
            parts = local_map(lambda t: _SplitLast.apply(t, k, group),
                              out_placements=(place,) * k, in_placements=(place,),
                              device_mesh=mesh)(x)
            return tuple(shard_hint(t, "mamba_channels") for t in parts)
    x = shard_hint(x, "batch_rows")
    return tuple(shard_hint(x[..., i * n:(i + 1) * n], "mamba_channels") for i in range(k))


def _zip_tree(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_tree(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_zip_tree(fn, t, s) for t, s in zip(tree, specs)]
    return fn(tree, specs)


def place_caches(caches, batch: int):
    """A model's caches (``make_caches``' tree) laid out on the current
    mesh by ``cache_partition_specs``, the reference's cache
    ``in_shardings``: once, at the end of prefill, so that each decode
    step finds its sequence chunks in place.  Leaves that are not DTensors,
    and every leaf with no mesh or no announced axes, stay as they are."""
    mesh = current_mesh()
    if mesh is None or current_axes() is None:
        return caches
    sizes = mesh_sizes(mesh)
    dp = math.prod(sizes[a] for a in AXES[:2] if a in sizes)
    specs = cache_partition_specs(caches, mesh.mesh_dim_names, global_batch=batch,
                                  dp_size=dp, axis_sizes=sizes)
    return _zip_tree(lambda t, spec: t.redistribute(mesh, placements(spec, mesh))
                     if isinstance(t, DTensor) else t, caches, specs)


def write_slot(cache, index: int, new) -> None:
    """``cache[:, index] = new`` in place (``new`` (B, ...) as the cache
    without its sequence dim).  For a DTensor cache whose sequence is
    sharded, the rank whose chunk holds ``index`` writes ``new``, laid out
    as the cache's other dims, into its local shard: DTensor writes no
    slice in place across a sharded dim."""
    if not isinstance(cache, DTensor):
        cache[:, index] = new.to(cache.dtype)
        return
    mesh, place = cache.device_mesh, cache.placements
    row = [Replicate() if p.is_shard(1) else Shard(p.dim - 1) if p.is_shard() and p.dim > 1
           else p for p in place]
    new = new.redistribute(mesh, row).to_local()
    coord, chunk, n = mesh.get_coordinate(), 0, 1
    for i, p in enumerate(place):  # this rank's chunk of the sequence, major axis first
        if p.is_shard(1):
            chunk, n = chunk * mesh.size(i) + coord[i], n * mesh.size(i)
    size = -(-cache.shape[1] // n)  # torch.chunk's sizes
    local = cache.to_local()
    if chunk * size <= index < (chunk + 1) * size:
        local[:, index - chunk * size] = new.to(local.dtype)


def _whole_heads(x, n: int):
    """``x`` (..., n * hd); where it is a DTensor whose last dim is sharded
    into pieces that cut through a head, those mesh dims gathered."""
    if isinstance(x, DTensor):
        mesh, last = x.device_mesh, x.ndim - 1
        cut = [i for i, p in enumerate(x.placements) if p.is_shard(last)]
        if n % math.prod(mesh.size(i) for i in cut):
            x = x.redistribute(mesh, [Replicate() if i in cut else p
                                      for i, p in enumerate(x.placements)])
    return x


def split_heads(x, n: int, hd: int):
    """``x`` (..., n * hd) -> (..., n, hd).  Where ``x`` is a DTensor whose
    last dim is sharded into pieces that cut through a head, those mesh
    dims are gathered first: DTensor's view rule mis-sizes such a split
    (GSPMD reshards it by itself), and torch 2.11's refuses it."""
    return _whole_heads(x, n).reshape(*x.shape[:-1], n, hd)


class _WholeHeadsGrad(torch.autograd.Function):
    """The identity on merged heads (..., n * hd) whose backward gives the
    gradient to the merge's backward, a split into (n, hd), with whole
    heads (``_whole_heads``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, n):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _whole_heads(g, ctx.n), None


def merge_heads(x):
    """``x`` (..., n, hd) -> (..., n * hd), the inverse of ``split_heads``.
    A DTensor's gradient comes back through ``split_heads``' gather, so
    that its backward's split never cuts a head."""
    merged = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if isinstance(x, DTensor) and torch.is_grad_enabled():
        return _WholeHeadsGrad.apply(merged, x.shape[-2])
    return merged


def _by_rows(rows: tuple, others: tuple):
    """(mesh, rows, others, split): the DTensors' mesh, every argument a
    DTensor (a plain tensor, the same on every rank, replicated), and the
    rows' placements with dim 0 split over the data axes where it divides."""
    mesh = next(t.device_mesh for t in rows + others if isinstance(t, DTensor))
    rows, others = (tuple(t if isinstance(t, DTensor) else distribute(t, P(), mesh)
                          for t in ts) for ts in (rows, others))
    dp = P(_dp(mesh.mesh_dim_names))
    return mesh, rows, others, placements(sanitize_spec(dp, rows[0].shape, mesh_sizes(mesh)),
                                          mesh)


def data_parallel(fn, rows: tuple, whole: tuple = ()):
    """``fn(*rows, *whole)`` under ``local_map``: each rank takes its batch
    rows of ``rows`` (dim 0 split over the data axes where it divides) and
    the whole of ``whole`` (replicated; an all-gather where sharded), and
    the result is laid out by rows; a ``whole`` tensor's gradient is the
    ranks' sum (Partial over the data axes).  For an op DTensor has no
    working rule for (the embedding lookup's backward; the loss, where
    "model" does not divide the vocabulary).  Plain tensors among the
    arguments are the same on every rank and enter replicated."""
    mesh, rows, whole, split = _by_rows(rows, whole)
    summed = [Partial() if p.is_shard() else Replicate() for p in split]
    rep = [Replicate()] * mesh.ndim
    n, m = len(rows), len(whole)
    return local_map(fn, out_placements=split, in_placements=(split,) * n + (rep,) * m,
                     in_grad_placements=(split,) * n + (summed,) * m, device_mesh=mesh,
                     redistribute_inputs=True)(*rows, *whole)


@dataclass(frozen=True)
class ColumnSplit:
    """One rank's part in a loss over the whole of a table (V, d) laid out
    P(None, "data") (the reference's P("model", "data") where "model" does
    not divide V), whose gradient it splits as the reference's partitioner
    does.  The rank gathers the table's columns over "data" (``whole``);
    it computes the gradient's columns ``cols``, d / data of them, from
    its own batch rows: the "model" ranks of a data row take the data
    axis's pieces in turn, M / D ranks each (rank m takes piece
    m // (M / D)).  The sum over the rows is an all-reduce over ``reduce``
    (the data axes the rows are split over), after which the rank holds
    piece m // (M / D) whole; ``permute`` swaps it with the rank whose
    shard of the table holds it and which holds the rank's own piece,
    within the rank's (data, model) plane."""
    cols: slice
    gather: Any  # the "data" group
    reduce: tuple  # process groups
    plane: Any  # the (data, model) plane, flattened: a 1-D DeviceMesh
    peer: int  # a rank in ``plane``

    def whole(self, shard: torch.Tensor) -> torch.Tensor:
        """The table (V, d) from the rank's shard (V, d / data)."""
        return _waited(_all_gather(shard.contiguous(), 1, self.gather))

    def permute(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` swapped with ``peer``'s: one collective-permute (an
        all-to-all with one peer each way)."""
        sizes = [0] * self.plane.size()
        sizes[self.peer] = t.numel()
        return _all_to_all(t, sizes, sizes, self.plane).view(t.shape)


def column_split(mesh, table, rows_split) -> ColumnSplit | None:
    """This rank's ``ColumnSplit`` of ``table``, where ``table`` (a
    DTensor) is laid out P(None, "data") on a mesh whose "model" axis (M
    ranks) is a multiple of "data" (D > 1); else None (the whole gradient
    on every rank, a sum over the data axes).  ``rows_split``: the
    placements of the batch rows."""
    sizes = mesh_sizes(mesh)
    D, M = sizes.get("data", 1), sizes.get("model", 1)
    names = tuple(mesh.mesh_dim_names)
    if not isinstance(table, DTensor) or D == 1 or M % D or list(
            table.placements) != placements(P(None, "data"), mesh):
        return None
    data = names.index("data")
    i, m = mesh.get_local_rank(data), mesh.get_local_rank(names.index("model"))
    per = M // D  # "model" ranks a piece
    width = table.shape[1] // D
    piece = m // per
    with _disable_current_modes():  # the mesh's index arithmetic, on real tensors
        plane = mesh["data", "model"]._flatten()
    return ColumnSplit(
        cols=slice(piece * width, (piece + 1) * width), gather=mesh.get_group(data),
        reduce=tuple(mesh.get_group(k) for k, a in enumerate(names)
                     if a in AXES[:2] and rows_split[k].is_shard()),
        plane=plane,
        # piece m // per goes to data row m // per, "model" rank
        # i * per + m % per, whose piece is i: the ranks swap
        peer=piece * M + i * per + m % per)


def vocab_parallel(fn, whole_fn, rows: tuple, table):
    """``fn(*rows, table, group)`` under ``local_map``, vocabulary-parallel:
    each rank takes its batch rows of ``rows`` (as ``data_parallel``) and
    its own rows of ``table`` (V, d) (dim 0 over "model", gathered over
    the other axes), and ``group`` is the "model" sub-mesh, over which
    ``fn`` all-reduces what it needs; the result is laid out by rows,
    whole over "model".  ``fn``'s gradients: the rows' whole over "model"
    (``fn`` reduces them), the table's on the rank's own rows, the ranks'
    sum over the data axes.  Where the mesh has no "model" axis of more
    than one rank, or it does not divide V (the reference's
    ``sanitize_spec`` leaves such a table's rows unsharded),
    ``whole_fn(*rows, table, split)``: each rank takes the whole table.
    ``split`` is None under ``data_parallel`` (the whole table given, its
    gradient the ranks' sum), or, where the table is laid out
    P(None, "data"), the rank's ``ColumnSplit``, with the rank's shard of
    the table given, which ``whole_fn`` gathers, and whose gradient it
    computes, reduces and hands back laid out as the shard."""
    mesh, rows, (table,), split = _by_rows(rows, (table,))
    tp = mesh_sizes(mesh).get("model", 1)
    n = len(rows)
    if tp == 1 or table.shape[0] % tp:
        cols = None if tp == 1 else column_split(mesh, table, split)
        if cols is None:
            return data_parallel(lambda *ts: whole_fn(*ts, None), rows, (table,))
        own = list(table.placements)  # the rank's shard in, its gradient's shard out
        return local_map(lambda *ts: whole_fn(*ts, cols), out_placements=split,
                         in_placements=(split,) * n + (own,),
                         in_grad_placements=(split,) * n + (own,), device_mesh=mesh,
                         redistribute_inputs=True)(*rows, table)
    own = placements(P("model"), mesh)
    summed = [Partial() if p.is_shard() else q for p, q in zip(split, own)]
    group = mesh["model"]
    return local_map(lambda *ts: fn(*ts, group), out_placements=split,
                     in_placements=(split,) * n + (own,),
                     in_grad_placements=(split,) * n + (summed,), device_mesh=mesh,
                     redistribute_inputs=True)(*rows, table)
