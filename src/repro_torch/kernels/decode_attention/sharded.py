"""Sequence-parallel flash-decode under ``local_map``: the reference
package's ``shard_map``'d ``decode_attention_tp``
(``repro/kernels/decode_attention/sharded.py``).

The decode cache is laid out (batch over dp, SEQUENCE over "model"), as
``sharding.specs.cache_partition_specs`` places it.  Each device runs the
unsharded decode on its local cache chunk: the decode kernel on the card
(its plain version on the CPU), which also returns each q-head's
log-sum-exp, at the chunk's own last valid position; a chunk wholly past
``cache_index`` launches nothing and weighs 0.  A windowed call takes the
reference's plain partials (``_local_partials``), as the unsharded
dispatch sends every windowed decode to a plain path.  The chunks' outputs
merge by their log-sum-exp over the "model" axis, functional collectives
on (B, H[, Dv]) tensors, the reference's online-softmax merge:

    m_g   = all_reduce_max(lse_loc)
    w     = exp(lse_loc - m_g)          (l_loc exp(m_loc - m_g))
    out   = all_reduce_sum(out_loc * w) / max(all_reduce_sum(w), 1e-37)

With a "model" axis of one device there is nothing to merge: each rank
runs the unsharded decode on its batch rows.  With no mesh, no announced
axes, no "model" axis or inputs that are not DTensors, the call is the
unsharded dispatch; where the batch does not divide over the data axes or
the cache over "model", each rank runs it on the whole of both.
"""

from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from ...sharding.hints import current_axes, current_mesh
from ...sharding.specs import P, mesh_sizes, placements
from .. import local_decode
from .decode_attention import decode_attention_fwd

NEG_INF = -2.0e38


def _local_partials(q, k, v, *, start, cache_index, window):
    """q: (B,1,H,D); k/v: (B,Sl,K,D) local chunk beginning at ``start``.
    Returns (acc (B,H,Dv), m (B,H), l (B,H)) fp32 partials."""
    B, Sl, K, D = k.shape
    H = q.shape[2]
    G = H // K
    Dv = v.shape[-1]
    qg = q.reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * (D ** -0.5)
    pos = start + torch.arange(Sl, device=q.device)
    mask = pos <= cache_index
    if window is not None:
        mask = mask & (pos > cache_index - window)
    s = torch.where(mask[None, None, None, :], s, NEG_INF)
    m = s.amax(-1)  # (B,K,G)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bkgs,bskv->bkgv", p.to(v.dtype).float(), v.float())
    return acc.reshape(B, H, Dv), m.reshape(B, H), l.reshape(B, H)


def chunk_decode(q, k, v, *, start: int, cache_index: int, window=None):
    """(out (B,1,H,Dv), lse (B,H) fp32) of q against the cache chunk k/v
    (B,Sl,K,D) that begins at position ``start``: the decode kernel at the
    chunk's last valid position, launched only where the chunk holds one
    (else out 0 and lse NEG_INF); ``_local_partials`` for a windowed call."""
    B, Sl = k.shape[:2]
    H, Dv = q.shape[2], v.shape[-1]
    if window is not None:
        acc, m, l = _local_partials(q, k, v, start=start, cache_index=cache_index,
                                    window=window)
        return (acc / l[..., None])[:, None], m + torch.log(l)
    if cache_index < start:
        return (q.new_zeros((B, 1, H, Dv), dtype=v.dtype),
                q.new_full((B, H), NEG_INF, dtype=torch.float32))
    return decode_attention_fwd(q, k, v, cache_index=min(cache_index - start, Sl - 1),
                                return_lse=True)


def merge_chunks(out, lse, reduce):
    """The chunks' outputs ``out`` (..., B,1,H,Dv) merged by their
    log-sum-exps ``lse`` (..., B,H): ``reduce(x, "max" | "sum")`` reduces
    over the chunks (all-reduces over "model", or a sum over a leading
    axis of stacked chunks).  Returns fp32 (B,1,H,Dv)."""
    m_g = reduce(lse, "max")
    w = torch.exp(lse - m_g)
    l_g = reduce(w, "sum")
    acc = reduce(out.float() * w[..., None, :, None], "sum")
    return acc / l_g.clamp_min(1e-37)[..., None, :, None]


def decode_attention_tp(q, k_cache, v_cache, *, cache_index: int, window=None):
    """(B,1,H,D) against (B,S,K,D) caches -> (B,1,H,Dv), the cache's
    sequence split over the current mesh's "model" axis."""
    mesh, axes = current_mesh(), current_axes()
    if (mesh is None or axes is None or "model" not in mesh.mesh_dim_names
            or not isinstance(q, DTensor)):
        return local_decode(q, k_cache, v_cache, cache_index=cache_index, window=window)
    B, S = k_cache.shape[:2]
    sizes = mesh_sizes(mesh)
    tp = sizes["model"]
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = math.prod(sizes[a] for a in dp_axes)
    if B % dp or S % tp:  # the reference's fallbacks, on every rank
        whole = placements(P(), mesh)
        return local_map(lambda q_, k_, v_: local_decode(q_, k_, v_, cache_index=cache_index,
                                                       window=window),
                         out_placements=whole, in_placements=(whole,) * 3,
                         device_mesh=mesh, redistribute_inputs=True)(q, k_cache, v_cache)
    S_loc = S // tp
    group = mesh["model"]

    def local(q_, k_, v_):
        q_ = q_.contiguous()  # gathered heads may arrive strided; the kernel takes rows
        if tp == 1:  # the whole sequence: nothing to merge
            return local_decode(q_, k_, v_, cache_index=cache_index, window=window)
        out, lse = chunk_decode(q_, k_, v_, start=group.get_local_rank() * S_loc,
                                cache_index=cache_index, window=window)
        return merge_chunks(out, lse, lambda x, op: funcol.all_reduce(x, op, group)
                            ).to(v_.dtype)

    bspec = dp_axes or None
    q_place = placements(P(bspec, None, None, None), mesh)
    kv_place = placements(P(bspec, "model", None, None), mesh)
    return local_map(local, out_placements=q_place, in_placements=(q_place, kv_place, kv_place),
                     device_mesh=mesh, redistribute_inputs=True)(q, k_cache, v_cache)
