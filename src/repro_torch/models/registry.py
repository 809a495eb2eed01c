"""Model registry: the reference package's ``ModelAPI`` names over the
port's modules.

``build(cfg)`` returns a ``ModelAPI``.  ``init(generator)`` makes the
parameters (an :class:`~repro_torch.models.lm.LM`, or for an
encoder-decoder config an :class:`~repro_torch.models.encdec.EncDec`) on
the generator's device; ``train_loss``/``prefill``/``decode`` take those
parameters first, as in the reference.  Ported families, all of the
reference's: ``dense`` (GQA, MHA and MLA decoders), ``moe``
(token-dropping MoE with a dense residual: llama4-maverick, arctic),
``ssm`` (Mamba-1, falcon-mamba), ``hybrid`` (jamba: Mamba and attention
blocks, dense and MoE MLPs), ``vlm`` (phi-3-vision's backbone with its
patch stub) and ``audio`` (whisper's encoder-decoder).  ``decode`` takes
``long_context`` as the reference's does.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

from .common import ModelConfig
from .encdec import EncDec
from .lm import LM

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass
class ModelAPI:
    cfg: ModelConfig
    init: Callable[[torch.Generator], LM | EncDec]
    train_loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    make_caches: Callable[..., Any]


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported (ported: "
            f"{', '.join(FAMILIES)})")
    model = EncDec if cfg.is_encoder_decoder else LM
    return ModelAPI(
        cfg=cfg,
        init=lambda g: model(cfg, g),
        train_loss=lambda p, b, **kw: p.train_loss(b, **kw),
        prefill=lambda p, b, **kw: p.prefill(b, **kw),
        decode=lambda p, b, c, long_context=False, **kw: p.decode(
            b, c, cache_index=int(b["cache_index"]), long_context=long_context, **kw),
        make_caches=lambda p, bsz, s: p.make_caches(bsz, s),
    )


def skeleton(model: nn.Module) -> nn.Module:
    """A copy of ``model``'s structure with every parameter on the meta
    device: what ``torch.func.functional_call`` runs a ``{name: tensor}``
    mapping of weights in, at no memory cost.  ``functional_call`` swaps
    the weights into the module while it runs, so a caller that may run on
    two threads at once takes a copy of its own each time."""
    memo = {id(p): nn.Parameter(p.detach().to("meta"), requires_grad=False)
            for p in model.parameters()}
    return copy.deepcopy(model, memo)
