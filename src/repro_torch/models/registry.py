"""Model registry: the reference package's ``ModelAPI`` names over the
port's modules.

``build(cfg)`` returns a ``ModelAPI``.  ``init(generator)`` makes the
parameters (an :class:`~repro_torch.models.lm.LM`) on the generator's
device; ``prefill``/``decode`` take those parameters first, as in the
reference.  Only dense GQA decoders are ported.
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
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    make_caches: Callable[..., Any]


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA decoders are ported")
    return ModelAPI(
        cfg=cfg,
        init=lambda g: LM(cfg, g),
        prefill=lambda p, b, **kw: p.prefill(b, **kw),
        decode=lambda p, b, c, **kw: p.decode(
            b, c, cache_index=int(b["cache_index"]), **kw),
        make_caches=lambda p, bsz, s: p.make_caches(bsz, s),
    )
