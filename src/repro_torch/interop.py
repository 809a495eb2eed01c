"""Parameters from the reference package.

``params_from_jax`` takes the JAX package's parameter pytree — as numpy
arrays (``jax.tree.map(np.asarray, params)``), so this module needs no
JAX — and returns the port's model (an :class:`~repro_torch.models.lm.LM`,
or an :class:`~repro_torch.models.encdec.EncDec` for an encoder-decoder
config) with those weights.  Both packages keep projections as
``(d_in, d_out)`` matrices, so nothing is transposed, and both name their
weights alike: a port parameter ``a.b.c`` is the reference's ``a/b/c``,
with these exceptions.  The LM's blocks are stacked along a leading
``n_repeats`` axis per pattern position (layer ``r * len(pattern) + i``
is ``blocks/b{i}[r]``); whisper's ``encoder`` and ``decoder`` layers are
stacked along a leading layer axis (``encoder.{l}.attn.wq`` is
``encoder/attn/wq[l]``); the vision stub's ``patch_proj`` is
``patch_proj/w``.  Every parameter of the port must be found and every
leaf of the tree used, with the same shape, or this raises.  Each weight
keeps the port's dtype: a Mamba layer's ``A_log`` and ``D`` and an MoE's
router stay fp32 in every config, as in the reference.  An MoE layer's
stacked experts map whole: ``blocks.{l}.moe.experts.wi`` (E, d, ff) is
``blocks/b{i}/moe/experts/wi[r]``, its dense residual
``blocks/b{i}/moe/residual/...[r]``.  A hybrid pattern (jamba) maps the
same way: its attention, Mamba, dense and MoE leaves sit under
``blocks/b{i}`` at the pattern positions that hold them.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.common import ModelConfig
from .models.registry import build


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, prefix + (key,))
    else:
        yield prefix


def _source(name: str, cfg: ModelConfig):
    """(path in the reference tree, index along its stacked axis or None)
    of the port parameter ``name``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        r, i = divmod(int(parts[1]), len(cfg.pattern))
        return ("blocks", f"b{i}", *parts[2:]), r
    if parts[0] in ("encoder", "decoder"):
        return (parts[0], *parts[2:]), int(parts[1])
    if name == "patch_proj":
        return ("patch_proj", "w"), None
    return tuple(parts), None


def params_from_jax(np_tree: dict, cfg: ModelConfig, device=None):
    device = resolve_device(device)
    model = build(cfg).init(torch.Generator(device=device))
    used = set()
    for name, param in model.named_parameters():
        path, index = _source(name, cfg)
        a = np_tree
        try:
            for key in path:
                a = a[key]
        except (KeyError, TypeError):
            raise ValueError(f"{name}: no {'/'.join(path)} in the reference's "
                             "parameters") from None
        a = torch.tensor(np.asarray(a if index is None else a[index], dtype=np.float32))
        where = "/".join(path) + ("" if index is None else f"[{index}]")
        if tuple(a.shape) != tuple(param.shape):
            raise ValueError(f"{where}: shape {tuple(a.shape)} from the reference, "
                             f"{tuple(param.shape)} in the port ({name})")
        with torch.no_grad():
            param.copy_(a.to(param.dtype))
        used.add(path)
    unused = sorted("/".join(p) for p in _leaves(np_tree) if p not in used)
    if unused:
        raise ValueError(f"reference parameters the port has no place for: {unused}")
    model.refresh()
    return model
