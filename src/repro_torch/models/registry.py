"""Model registry: the reference package's ``ModelAPI`` names over the
port's modules.

``build(cfg)`` returns a ``ModelAPI``.  ``init(generator)`` makes the
parameters (an :class:`~repro_torch.models.lm.LM`) on the generator's
device; ``train_loss``/``prefill``/``decode`` take those parameters
first, as in the reference.  Ported families: ``dense`` (GQA decoders)
and ``ssm`` (Mamba-1, falcon-mamba).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from .common import ModelConfig
from .lm import LM


@dataclass
class ModelAPI:
    cfg: ModelConfig
    init: Callable[[torch.Generator], LM]
    train_loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    make_caches: Callable[..., Any]


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA decoders and Mamba SSMs are ported")
    return ModelAPI(
        cfg=cfg,
        init=lambda g: LM(cfg, g),
        train_loss=lambda p, b, **kw: p.train_loss(b, **kw),
        prefill=lambda p, b, **kw: p.prefill(b, **kw),
        decode=lambda p, b, c, **kw: p.decode(
            b, c, cache_index=int(b["cache_index"]), **kw),
        make_caches=lambda p, bsz, s: p.make_caches(bsz, s),
    )
