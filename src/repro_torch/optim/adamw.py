"""AdamW with configurable moment dtypes: fp32 | bf16 | int8-blockwise.

The reference package's ``repro/optim/adamw.py``, over dicts of tensors
(parameter name -> tensor) instead of pytrees.  bf16 moments halve the
optimizer state; blockwise int8 (int8 codes plus an fp32 scale and offset
per 256-element block of the last axis) quarters it, with the second
moment coded in the log domain.  Also here: global-norm gradient clipping
and decoupled weight decay.

Unlike the reference, which returns new arrays, ``adamw_update`` works
in place (under ``torch.no_grad``): it clips the caller's gradients, and
writes the new parameters and moments into the tensors it was given, one
slice of a tensor's leading axis at a time (``SLICE`` elements), so a
step holds no second copy of the weights or gradients and only a slice's
fp32 temporaries.  The arithmetic is elementwise (int8 moments blockwise
along the last axis), so the slices give the whole-tensor values bit for
bit; only the gradient norm's summation order depends on the slicing.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

BLOCK = 256
_LOG_EPS = 1e-30


# ----------------------- int8 blockwise codec -------------------------- #
def _pad_to_block(x: torch.Tensor) -> torch.Tensor:
    pad = (-x.shape[-1]) % BLOCK
    return F.pad(x, (0, pad)) if pad else x


def _blocks(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (x.shape[-1] // BLOCK, BLOCK))


def quantize_blockwise(x: torch.Tensor, *, log_domain: bool = False):
    """fp32 -> (int8 codes, fp32 scale, fp32 offset) per 256-elem block.

    ``log_domain=True`` quantizes log(x) with a per-block [lo, hi] range —
    needed for Adam's second moment, where linear absmax codes collapse the
    small entries in a block to zero and m/sqrt(v) explodes."""
    xp = _pad_to_block(x.float())
    xb = _blocks(xp)
    if log_domain:
        u = torch.log(xb.clamp_min(_LOG_EPS))
        lo = u.amin(-1)
        hi = u.amax(-1)
        scale = (hi - lo).clamp_min(1e-6) / 254.0
        codes = (torch.round((u - lo[..., None]) / scale[..., None]) - 127
                 ).clamp(-127, 127).to(torch.int8)
        return codes.reshape(xp.shape), scale, lo
    absmax = xb.abs().amax(-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    codes = torch.round(xb / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return codes.reshape(xp.shape), scale, torch.zeros_like(scale)


def dequantize_blockwise(codes: torch.Tensor, scale: torch.Tensor,
                         offset: torch.Tensor, orig_last: int, *,
                         log_domain: bool = False) -> torch.Tensor:
    cb = _blocks(codes).float()
    if log_domain:
        xb = torch.exp((cb + 127.0) * scale[..., None] + offset[..., None])
        xb = torch.where(xb <= 2 * _LOG_EPS, torch.zeros_like(xb), xb)
    else:
        xb = cb * scale[..., None]
    return xb.reshape(codes.shape)[..., :orig_last]


# ----------------------------- state ---------------------------------- #
def _zeros_like_moment(p: torch.Tensor, dtype: str):
    """A zero moment of ``p``, made from ``p`` itself (``new_zeros``), so
    that under ``torch.func.vmap`` each task's parameter gets its own."""
    if dtype == "int8":
        last = p.shape[-1] + (-p.shape[-1]) % BLOCK
        codes = p.new_zeros(p.shape[:-1] + (last,), dtype=torch.int8)
        scale = p.new_zeros(p.shape[:-1] + (last // BLOCK,), dtype=torch.float32)
        offset = torch.full_like(scale, math.log(_LOG_EPS))
        return {"codes": codes, "scale": scale, "offset": offset}
    return p.new_zeros(p.shape, dtype=getattr(torch, dtype))


def _cuts_blocks(p: DTensor) -> bool:
    """Whether a shard of ``p``'s last dim holds a part of a 256-element
    block (the dim split into pieces that are not whole blocks)."""
    cut = [p.device_mesh.size(i) for i, pl in enumerate(p.placements) if pl.is_shard(p.ndim - 1)]
    return bool(cut) and p.shape[-1] % (math.prod(cut) * BLOCK) != 0


def _whole_last(p: DTensor) -> list:
    """``p``'s placements with its last dim whole."""
    return [Replicate() if pl.is_shard(p.ndim - 1) else pl for pl in p.placements]


def _spec_of(p: DTensor):
    """The partition spec that ``p``'s placements lay it out by."""
    from ..sharding.specs import P

    names = p.device_mesh.mesh_dim_names
    dims = [tuple(n for n, pl in zip(names, p.placements) if pl.is_shard(j))
            for j in range(p.ndim)]
    return P(*(e[0] if len(e) == 1 else (e or None) for e in dims))


def _moment_spec(spec, leaf, axis_sizes):
    """The spec of a moment (``leaf``, or its shape) of a parameter laid
    out by ``spec``: ``spec`` sanitized for the moment's shape; of an int8
    moment's {codes, scale, offset}, for each piece's own shape (the
    blocked last dim usually cannot divide the mesh), as the reference's
    moment specs."""
    from ..sharding.specs import sanitize_spec

    if isinstance(leaf, Mapping):
        return {k: _moment_spec(spec, leaf[k], axis_sizes) for k in ("codes", "scale", "offset")}
    return sanitize_spec(spec, getattr(leaf, "shape", leaf), axis_sizes)


def _update_placements(p: DTensor, dtype: str) -> list:
    """The placements a DTensor parameter's update runs on: its own, but
    with the last dim whole where int8 moments' blocks would be cut by its
    shards, so that the blocks quantized are the whole dim's, as the
    reference quantizes them, not a shard's."""
    return _whole_last(p) if dtype == "int8" and _cuts_blocks(p) else list(p.placements)


def _moment_of(p: torch.Tensor, dtype: str):
    """A zero moment of ``p``; of a DTensor, a DTensor placed like ``p``,
    made from its local shard.  An int8 moment of a parameter whose shards
    cut a block has each of codes, scale and offset laid out by the
    reference's sanitized moment spec (the parameter's, sanitized for
    that piece's own shape; arctic's 7168-wide table over 16 ranks: codes
    448 a rank, scale and offset whole)."""
    if not isinstance(p, DTensor):
        return _zeros_like_moment(p, dtype)
    mesh, local = p.device_mesh, p.to_local()
    if dtype != "int8" or not _cuts_blocks(p):
        mom = _zeros_like_moment(local, dtype)
        wrap = lambda t: DTensor.from_local(t, mesh, p.placements,  # noqa: E731
                                            run_check=False)
        return {k: wrap(t) for k, t in mom.items()} if dtype == "int8" else wrap(mom)
    from ..sharding.specs import mesh_sizes, placements

    whole = _zeros_like_moment(local.new_empty(local.shape[:-1] + (p.shape[-1],)), dtype)
    specs = _moment_spec(_spec_of(p), {k: p.shape[:-1] + t.shape[-1:] for k, t in whole.items()},
                         mesh_sizes(mesh))
    return {k: DTensor.from_local(t, mesh, _whole_last(p), run_check=False).redistribute(
        mesh, placements(specs[k], mesh)) for k, t in whole.items()}


def init_opt_state(params: Mapping[str, torch.Tensor], *,
                   moment_dtype: str = "float32",
                   master_fp32: bool = False) -> dict:
    """{"step": 0-d int32, "m": {name: moment}, "v": {...}
    [, "master": {name: fp32 copy}]}; an int8 moment is
    {"codes", "scale", "offset"}.  Moments and masters are made from the
    parameters, so a task's parameters batched under ``torch.func.vmap``
    give it a batched state of its own; the step is shared."""
    device = next(iter(params.values())).device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": {k: _moment_of(p, moment_dtype) for k, p in params.items()},
        "v": {k: _moment_of(p, moment_dtype) for k, p in params.items()},
    }
    if master_fp32:
        state["master"] = {k: p.detach().float().clone()
                           for k, p in params.items()}
    return state


def _read_moment(mom, p, dtype: str, *, log_domain: bool = False):
    if dtype == "int8":
        return dequantize_blockwise(mom["codes"], mom["scale"], mom["offset"],
                                    p.shape[-1], log_domain=log_domain)
    return mom.float()


def _write_moment(val, dtype: str, *, log_domain: bool = False):
    if dtype == "int8":
        codes, scale, offset = quantize_blockwise(val, log_domain=log_domain)
        return {"codes": codes, "scale": scale, "offset": offset}
    return val.to(getattr(torch, dtype))


# ----------------------------- update --------------------------------- #
# The largest slice of a tensor's leading axis that the norm, the clip and
# the update hold fp32 temporaries of at once, in elements: an expert stack
# (E, d, ff) goes one expert at a time, an embedding table in row blocks.
SLICE = 1 << 26


def _slices(t: torch.Tensor) -> list:
    """Indices of ``t``'s pieces along its leading axis, each at most SLICE
    elements (a leading row beyond it stays whole): ``...`` (the whole
    tensor) for a tensor of at most SLICE elements and for a 1-D tensor,
    whose int8 moment blocks run along that axis."""
    if t.dim() < 2 or t.numel() <= SLICE:
        return [...]
    rows = max(SLICE // math.prod(t.shape[1:]), 1)
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def global_norm(tensors, placed=None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (a mapping's values or
    an iterable), in fp32, summed SLICE elements at a time.  With
    ``placed`` (one (mesh, placements) a tensor) the tensors are local
    shards laid out so, and each one's sums are added up over the mesh
    dims that shard it."""
    ts = list(tensors.values() if isinstance(tensors, Mapping) else tensors)
    sums = [torch.stack([torch.sum(torch.square(t[i].float())) for i in _slices(t)])
            for t in ts]
    if placed is not None:
        sums = [DTensor.from_local(s, mesh, [Partial() if p.is_shard() else Replicate()
                                             for p in place]).full_tensor()
                for s, (mesh, place) in zip(sums, placed)]
    return torch.sqrt(torch.cat(sums).sum())


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float,
                        placed=None):
    """Returns (clipped grads, the norm before clipping).  The caller's
    gradient tensors are scaled in place, SLICE elements at a time, so no
    second set is made; a gradient autograd handed out as a broadcast view
    (stride 0), which cannot be written, is replaced by a scaled copy.
    ``placed``: as ``global_norm``'s."""
    norm = global_norm(grads, placed)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    out, done = {}, {}  # done: autograd may hand one tensor to two parameters
    with torch.no_grad():
        for k, g in grads.items():
            if id(g) not in done:
                if g.is_contiguous():
                    for i in _slices(g):
                        g[i].copy_(g[i].float() * factor)
                    done[id(g)] = g
                else:
                    done[id(g)] = (g.float() * factor).to(g.dtype)
            out[k] = done[id(g)]
    return out, norm


def _moment_part(mom, dtype: str, i):
    if dtype == "int8":
        return {k: a[i] for k, a in mom.items()}
    return mom[i]


def _store_moment(dst, val, dtype: str, *, log_domain: bool = False):
    """Writes ``val`` (fp32) into the moment slice ``dst`` in place."""
    new = _write_moment(val, dtype, log_domain=log_domain)
    if dtype == "int8":
        for k, a in dst.items():
            a.copy_(new[k])
    else:
        dst.copy_(new)


def _local(tree):
    """A DTensor's local shard (a view: writes reach the DTensor), through
    dicts."""
    if isinstance(tree, Mapping):
        return {k: _local(v) for k, v in tree.items()}
    return tree.to_local() if isinstance(tree, DTensor) else tree


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: dict,
                 params: Mapping[str, torch.Tensor], *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, moment_dtype="float32",
                 clip_norm: float | None = 1.0):
    """One AdamW step.  Clips ``grads`` in place, writes the new
    parameters into ``params``' tensors and the new moments (and step) into
    ``state``'s, each tensor SLICE elements of its leading axis at a time;
    returns (params, state, metrics).

    DTensor parameters (a model distributed on a mesh, its state from
    ``init_opt_state``) update shard by shard: each gradient is first
    redistributed to its update's placements (``_update_placements``: the
    parameter's own, or with the last dim whole where int8 blocks would be
    cut), the norm is reduced over the mesh, and the elementwise update
    runs on the local shards of the parameters and of their moments.
    Where the last dim is whole, the parameter, its master and its moments
    are gathered to that layout, updated there, and each rank writes back
    its own shards of them."""
    metrics, placed, work, shards, back = {}, None, state, params, []
    if isinstance(next(iter(params.values())), DTensor):
        lay = {k: _update_placements(p, moment_dtype) for k, p in params.items()}
        placed = [(params[k].device_mesh, lay[k]) for k in grads]
        grads = {k: g.redistribute(params[k].device_mesh, lay[k]).to_local()
                 for k, g in grads.items()}
        work, shards = _local(state), _local(params)
        for k, p in params.items():
            if lay[k] == list(p.placements):
                continue
            gather = [(params, shards, k)]
            if "master" in state:
                gather.append((state["master"], work["master"], k))
            for n in ("m", "v"):  # codes, scale, offset
                gather += [(state[n][k], work[n][k], j) for j in state[n][k]]
            for src, dst, j in gather:
                dst[j] = src[j].redistribute(p.device_mesh, lay[k]).to_local()
                back.append((src[j], dst[j], lay[k]))
    if clip_norm is not None:
        grads, metrics["grad_norm"] = clip_by_global_norm(grads, clip_norm, placed)
    step = state["step"] + 1
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=step.device), step.float())
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=step.device), step.float())
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    masters = work.get("master", shards)
    for k, p in shards.items():
        for i in _slices(p):
            ps = p[i]
            m_s = _moment_part(work["m"][k], moment_dtype, i)
            v_s = _moment_part(work["v"][k], moment_dtype, i)
            g32 = grads[k][i].float()
            m32 = _read_moment(m_s, ps, moment_dtype)
            v32 = _read_moment(v_s, ps, moment_dtype, log_domain=True)
            m32 = b1 * m32 + (1 - b1) * g32
            v32 = b2 * v32 + (1 - b2) * g32 * g32
            del g32
            mh = m32 / c1
            vh = v32 / c2
            base = masters[k][i].float()
            new = base - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * base)
            del mh, vh, base
            if "master" in work:
                work["master"][k][i].copy_(new)
            ps.copy_(new)
            _store_moment(m_s, m32, moment_dtype)
            _store_moment(v_s, v32, moment_dtype, log_domain=True)
    for dst, new, place in back:  # each rank's own shards of a whole-dim update
        dst.to_local().copy_(DTensor.from_local(new, dst.device_mesh, place, run_check=False)
                             .redistribute(dst.device_mesh, dst.placements).to_local())
    state["step"] = step
    metrics["lr"] = lr
    return params, state, metrics


def opt_state_partition_specs(state: dict, param_specs: Mapping, axes,
                              axis_sizes: Mapping[str, int] | None = None) -> dict:
    """Specs of ``init_opt_state``'s state: the moments mirror the
    parameters' specs (``tree_partition_specs``); an int8 moment's
    {codes, scale, offset} take its parameter's spec, each sanitized for
    its own shape (the blocked last dim usually cannot divide the mesh);
    ``master`` takes the parameters' specs.  ``init_opt_state`` lays a
    DTensor parameter's moments out so."""
    from ..sharding.specs import P

    out = {"step": P(),
           "m": {k: _moment_spec(param_specs[k], m, axis_sizes) for k, m in state["m"].items()},
           "v": {k: _moment_spec(param_specs[k], v, axis_sizes) for k, v in state["v"].items()}}
    if "master" in state:
        out["master"] = dict(param_specs)
    return out
