"""Tensor-parallel flash attention under ``local_map``: the reference
package's ``shard_map``'d ``flash_attention_tp``
(``repro/kernels/flash_attention/sharded.py``).

Attention is embarrassingly parallel over (batch, heads).  Under a mesh
with a "model" axis, each device runs the port's own per-device attention
on its (batch shard, head shard) with no collective inside: q, k and v
are placed (dp, None, "model", None) (batch over the ("pod", "data")
axes, heads over "model") and the local body is
``torch.distributed.tensor.experimental.local_map``'s function.  The
local body is the unsharded dispatch: for an unwindowed call on the card
the hand-written flash kernel (and, when differentiated, its dq and dk/dv
kernels), for a windowed call the chunked flash with its manual backward
(``chunked.py``), for CPU tensors the plain versions.

GQA head alignment with tp devices on the head axis:
  * K >= tp and K % tp == 0: shard kv heads directly;
  * K < tp and tp % K == 0: duplicate each kv head tp/K times and permute
    the q heads so that every duplicate serves a contiguous slice of its
    own kv head's queries, padding q with zero heads up to the slice size
    (zero heads attend uniformly to zero values: zero output, zero
    gradient, dropped on the way out);
  * MHA with a head count tp does not divide: pad both with zero heads.

The permutation (``_take_heads``) runs under ``local_map`` too, on heads
replicated over "model" (an all-gather where they arrive sharded), and
its inverse on the way out.  Inputs that are not DTensors run the
unsharded dispatch, as with no mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from ...sharding.hints import current_axes, current_mesh
from ...sharding.specs import P, mesh_sizes, placements
from .. import local_attention


@dataclass(frozen=True)
class HeadPlan:
    tp: int
    Hp: int  # padded/permuted q heads
    Kp: int  # replicated/padded kv heads
    q_src: tuple  # (Hp,) index into original q heads, -1 = zero pad
    kv_src: tuple  # (Kp,) index into original kv heads, -1 = zero pad
    inv: tuple  # (H,) position of original head h in the padded layout


def plan_heads(H: int, K: int, tp: int) -> HeadPlan | None:
    """None if no rearrangement is needed (already divisible) or none
    exists."""
    if H % tp == 0 and K % tp == 0:
        return None
    G = H // K
    if K >= tp:
        if K % tp and H == K:
            # MHA with awkward head count: pad BOTH (zero kv heads are safe)
            Kp = math.ceil(K / tp) * tp
            q_src = tuple(list(range(H)) + [-1] * (Kp - H))
            kv_src = tuple(list(range(K)) + [-1] * (Kp - K))
            inv = tuple(range(H))
            return HeadPlan(tp, Kp, Kp, q_src, kv_src, inv)
        return None
    if tp % K:
        return None
    dup = tp // K
    Gp = math.ceil(G / dup)
    q_src, inv = [], [0] * H
    for j in range(K * dup):
        kv = j // dup
        base = kv * G + (j % dup) * Gp
        for t in range(Gp):
            h = base + t
            if h < (kv + 1) * G and h < H:
                inv[h] = len(q_src)
                q_src.append(h)
            else:
                q_src.append(-1)
    kv_src = tuple(j // dup for j in range(K * dup))
    return HeadPlan(tp, K * dup * Gp, K * dup, tuple(q_src), kv_src,
                    tuple(inv))


def _take_heads(x, src):
    """Heads of ``x`` (B,S,heads,D) gathered along axis 2, -1 giving zeros."""
    idx = torch.tensor([max(s, 0) for s in src], device=x.device)
    mask = torch.tensor([1.0 if s >= 0 else 0.0 for s in src], dtype=x.dtype,
                        device=x.device)
    return x.index_select(2, idx) * mask[None, None, :, None]


def _run(fn, mesh, place, out_place, *xs):
    """``fn`` on each rank's local pieces of ``xs`` redistributed to
    ``place``; returns a DTensor placed ``out_place``."""
    return local_map(fn, out_placements=out_place, in_placements=(place,) * len(xs),
                     device_mesh=mesh, redistribute_inputs=True)(*xs)


def flash_attention_tp(q, k, v, *, causal=True, window=None, q_chunk=None,
                       kv_chunk=None, train=True):
    """Attention under ``local_map`` over the current mesh's "model" axis;
    with no mesh, no announced axes, no "model" axis or inputs that are
    not DTensors, the unsharded dispatch.  Where the batch does not divide
    over the data axes, or the heads over "model" with no plan, each rank
    runs the unsharded dispatch on the whole of that dim.  A windowed
    call's chunks are ``q_chunk`` and ``kv_chunk``, by default the tuning
    cache's at the shape each rank runs."""
    body = partial(local_attention, causal=causal, window=window,
                   q_chunk=q_chunk, kv_chunk=kv_chunk, train=train)
    mesh, axes = current_mesh(), current_axes()
    if (mesh is None or axes is None or "model" not in mesh.mesh_dim_names
            or not isinstance(q, DTensor)):
        return body(q, k, v)
    B, _, H, _ = q.shape
    K = k.shape[2]
    sizes = mesh_sizes(mesh)
    tp = sizes["model"]
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = math.prod(sizes[a] for a in dp_axes)
    bspec = (dp_axes or None) if B % dp == 0 else None
    plan = plan_heads(H, K, tp)
    heads = "model" if plan is not None or (H % tp == 0 and K % tp == 0) else None
    if bspec is None or heads is None:  # the reference's fallbacks
        return _run(body, mesh, placements(P(bspec), mesh), placements(P(bspec), mesh),
                    q, k, v)
    gathered = placements(P(bspec), mesh)
    if plan is not None:
        q = _run(partial(_take_heads, src=plan.q_src), mesh, gathered, gathered, q)
        k, v = (_run(partial(_take_heads, src=plan.kv_src), mesh, gathered, gathered, x)
                for x in (k, v))
    place = placements(P(bspec, None, heads, None), mesh)
    out = _run(body, mesh, place, place, q, k, v)
    if plan is not None:
        out = _run(partial(_take_heads, src=plan.inv), mesh, gathered, gathered, out)
        if H % tp == 0:  # each rank's heads again (a local slice): the output
            # projection and its weight's gradient stay tensor-parallel
            out = out.redistribute(mesh, place)
    return out
