"""Parameters from the reference package.

``params_from_jax`` takes the JAX package's LM parameter pytree — as
numpy arrays (``jax.tree.map(np.asarray, params)``), so this module needs
no JAX — and returns the port's :class:`~repro_torch.models.lm.LM` with
those weights.  Both packages keep projections as ``(d_in, d_out)``
matrices, so nothing is transposed; the reference stacks each pattern
position's parameters along a leading ``n_repeats`` axis, which is
unstacked here (layer ``r * len(pattern) + i`` is ``blocks/b{i}[r]``).
Each weight keeps the port's dtype: a Mamba layer's ``A_log`` and ``D``
stay fp32 in every config, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.common import ModelConfig
from .models.lm import LM


def _assign(param: torch.nn.Parameter, array, name: str) -> None:
    a = torch.tensor(np.asarray(array, dtype=np.float32))
    if tuple(a.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {tuple(a.shape)} from the reference, "
                         f"{tuple(param.shape)} in the port")
    with torch.no_grad():
        param.copy_(a.to(param.dtype))


def params_from_jax(np_tree: dict, cfg: ModelConfig, device=None) -> LM:
    device = resolve_device(device)
    model = LM(cfg, torch.Generator(device=device))
    _assign(model.embed.table, np_tree["embed"]["table"], "embed/table")
    if not cfg.tie_embeddings:
        _assign(model.lm_head.table, np_tree["lm_head"]["table"],
                "lm_head/table")
    _assign(model.final_norm.scale, np_tree["final_norm"]["scale"],
            "final_norm/scale")
    n_pat = len(cfg.pattern)
    for layer, blk in enumerate(model.blocks):
        r, i = divmod(layer, n_pat)
        src = np_tree["blocks"][f"b{i}"]

        def put(param, *path):
            a = src
            for key in path:
                a = a[key]
            _assign(param, a[r], f"blocks/b{i}/{'/'.join(path)}[{r}]")

        put(blk.mixer_norm.scale, "mixer_norm", "scale")
        if blk.spec.mixer == "mamba":
            for w in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj_w",
                      "dt_proj_b", "A_log", "D", "out_proj"):
                put(getattr(blk.mamba, w), "mamba", w)
        else:
            for w in ("wq", "wk", "wv", "wo"):
                put(getattr(blk.attn, w), "attn", w)
            if cfg.qk_norm:
                put(blk.attn.q_norm, "attn", "q_norm")
                put(blk.attn.k_norm, "attn", "k_norm")
        if blk.spec.mlp == "dense":
            put(blk.mlp_norm.scale, "mlp_norm", "scale")
            for w in ("wi", "wg", "wo"):
                put(getattr(blk.mlp, w), "mlp", w)
    model.refresh()
    return model
