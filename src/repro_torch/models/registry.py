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
``long_context`` as the reference's does.  ``SHAPES``, ``input_specs``,
``cache_specs`` and ``param_specs`` are the reference's shape stand-ins,
as tensors on the meta device.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

from .common import ModelConfig
from .encdec import EncDec
from .layers import META_INIT
from .lm import LM

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class ShapeCell:
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train", 4096, 256),
    "prefill_32k": ShapeCell("prefill", 32768, 32),
    "decode_32k": ShapeCell("decode", 32768, 128),
    "long_500k": ShapeCell("decode", 524288, 1),
}


def cell_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped), the reference's skip rules."""
    if shape_name == "long_500k":
        if not cfg.subquadratic:
            return False, ("pure full-attention arch: O(s^2) attention at "
                           "524288 has no sub-quadratic mechanism; skipped "
                           "per assignment")
    return True, ""


def _cell(shape: str | ShapeCell) -> ShapeCell:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclass
class ModelAPI:
    cfg: ModelConfig
    init: Callable[[torch.Generator], LM | EncDec]
    train_loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    make_caches: Callable[..., Any]

    # the reference's shape stand-ins, as meta tensors: nothing allocates
    def input_specs(self, shape_name: str | ShapeCell, *,
                    batch_override: int | None = None) -> dict[str, torch.Tensor]:
        """The batch of a cell (``SHAPES``, or a ``ShapeCell`` of its own),
        tokens int32 and frames or patch embeddings in the compute dtype, on
        the meta device."""
        cell = _cell(shape_name)
        B = batch_override or cell.global_batch
        S = cell.seq_len
        cfg = self.cfg
        i32, f = torch.int32, cfg.dtype
        if cell.kind == "train":
            if cfg.is_encoder_decoder:
                return {"enc_frames": _meta((B, S, cfg.d_model), f),
                        "tokens": _meta((B, S), i32),
                        "targets": _meta((B, S), i32)}
            if cfg.frontend == "vision":
                P = cfg.n_patch_tokens
                return {"tokens": _meta((B, S - P), i32),
                        "patch_embeds": _meta((B, P, cfg.d_model), f),
                        "targets": _meta((B, S - P), i32)}
            return {"tokens": _meta((B, S), i32), "targets": _meta((B, S), i32)}
        if cell.kind == "prefill":
            base = {"tokens": _meta((B, S), i32)}
            if cfg.is_encoder_decoder:
                base["enc_frames"] = _meta((B, cfg.encoder_seq_len, cfg.d_model), f)
            if cfg.frontend == "vision":
                P = cfg.n_patch_tokens
                base["tokens"] = _meta((B, S - P), i32)
                base["patch_embeds"] = _meta((B, P, cfg.d_model), f)
            return base
        # decode: one new token against a seq_len cache
        return {"tokens": _meta((B, 1), i32), "cache_index": _meta((), i32)}

    def cache_specs(self, shape_name: str | ShapeCell, *, batch_override: int | None = None):
        """A decode cell's caches (``make_caches`` of the model on the meta
        device): one dict a layer."""
        cell = _cell(shape_name)
        if cell.kind != "decode":
            raise ValueError(f"{shape_name} is a {cell.kind} cell; caches are decode's")
        B = batch_override or cell.global_batch
        return self.make_caches(self.init(META_INIT), B, cell.seq_len)

    def param_specs(self) -> dict[str, torch.Tensor]:
        """{name: parameter} of the model built on the meta device (shapes
        and dtypes, nothing allocated)."""
        return dict(self.init(META_INIT).named_parameters())


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
