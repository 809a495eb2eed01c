"""AdamW with configurable moment dtypes: fp32 | bf16 | int8-blockwise.

The reference package's ``repro/optim/adamw.py``, over dicts of tensors
(parameter name -> tensor) instead of pytrees.  bf16 moments halve the
optimizer state; blockwise int8 (int8 codes plus an fp32 scale and offset
per 256-element block of the last axis) quarters it, with the second
moment coded in the log domain.  Also here: global-norm gradient clipping
and decoupled weight decay.

Unlike the reference, which returns new arrays, ``adamw_update`` writes
the new parameters into the given tensors in place (under
``torch.no_grad``), so a model's parameters are updated without a second
copy of the weights; the moments are replaced in the state dict.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

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
    if dtype == "int8":
        last = p.shape[-1] + (-p.shape[-1]) % BLOCK
        codes = torch.zeros(p.shape[:-1] + (last,), dtype=torch.int8,
                            device=p.device)
        scale = torch.zeros(p.shape[:-1] + (last // BLOCK,),
                            dtype=torch.float32, device=p.device)
        offset = torch.full_like(scale, math.log(_LOG_EPS))
        return {"codes": codes, "scale": scale, "offset": offset}
    return torch.zeros(p.shape, dtype=getattr(torch, dtype), device=p.device)


def init_opt_state(params: Mapping[str, torch.Tensor], *,
                   moment_dtype: str = "float32",
                   master_fp32: bool = False) -> dict:
    """{"step": 0-d int32, "m": {name: moment}, "v": {...}
    [, "master": {name: fp32 copy}]}; an int8 moment is
    {"codes", "scale", "offset"}."""
    device = next(iter(params.values())).device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": {k: _zeros_like_moment(p, moment_dtype) for k, p in params.items()},
        "v": {k: _zeros_like_moment(p, moment_dtype) for k, p in params.items()},
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
def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (a mapping's values or
    an iterable), in fp32."""
    ts = tensors.values() if isinstance(tensors, Mapping) else tensors
    return torch.sqrt(torch.stack([torch.sum(torch.square(t.float()))
                                   for t in ts]).sum())


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """Returns (clipped grads, the norm before clipping)."""
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.float() * factor).to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: dict,
                 params: Mapping[str, torch.Tensor], *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, moment_dtype="float32",
                 clip_norm: float | None = 1.0):
    """One AdamW step.  Writes the new parameters into ``params``' tensors
    and the new moments (and step) into ``state``; returns
    (params, state, metrics)."""
    metrics = {}
    if clip_norm is not None:
        grads, metrics["grad_norm"] = clip_by_global_norm(grads, clip_norm)
    step = state["step"] + 1
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=step.device), step.float())
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=step.device), step.float())
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    masters = state.get("master", params)
    for k, p in params.items():
        g32 = grads[k].float()
        m32 = _read_moment(state["m"][k], p, moment_dtype)
        v32 = _read_moment(state["v"][k], p, moment_dtype, log_domain=True)
        m32 = b1 * m32 + (1 - b1) * g32
        v32 = b2 * v32 + (1 - b2) * g32 * g32
        del g32
        mh = m32 / c1
        vh = v32 / c2
        base = masters[k].float()
        new = base - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * base)
        del mh, vh, base
        if "master" in state:
            state["master"][k] = new
        p.copy_(new)
        state["m"][k] = _write_moment(m32, moment_dtype)
        state["v"][k] = _write_moment(v32, moment_dtype, log_domain=True)
    state["step"] = step
    metrics["lr"] = lr
    return params, state, metrics
