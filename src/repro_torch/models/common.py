"""Model configuration for the dense GQA decoders of the port.

A model is a *block pattern* (a short tuple of ``BlockSpec``) repeated
``n_repeats`` times, as in the reference package; the port runs the
layers as a loop over an ``nn.ModuleList``.  Only dense GQA decoders
(attention mixer, RMSNorm, SwiGLU MLP) are ported so far: blocks of any
other pattern are rejected.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class BlockSpec:
    """One layer's shape: a mixer plus an MLP."""

    mixer: str = "attn"  # "attn" (the only mixer ported)
    mlp: str = "dense"  # "dense" (the only MLP ported)
    # sliding window for this block's attention (None = full/causal).
    window: int | None = None


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    pattern: tuple[BlockSpec, ...] = ()

    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # numerics: names of torch dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.pattern:
            object.__setattr__(self, "pattern", (BlockSpec(),))
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.pattern)}")

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
