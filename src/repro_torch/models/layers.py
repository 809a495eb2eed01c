"""Shared layers: RMSNorm, qk-norm, RoPE, SwiGLU MLP, embeddings.

Weights are kept in the reference package's layout — a projection is a
``(d_in, d_out)`` matrix applied as ``x @ w`` — so converted parameters
need no transposes.  Initialisers draw from an explicit
``torch.Generator`` on the generator's own device.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import ModelConfig


# --------------------------------------------------------------------- #
# initializers
# --------------------------------------------------------------------- #
def dense_init(g: torch.Generator, shape, dtype: torch.dtype) -> nn.Parameter:
    """Truncated-normal fan-in initializer (std fan_in^-0.5, cut at 2 std)."""
    t = torch.empty(shape, dtype=torch.float32, device=g.device)
    std = shape[0] ** -0.5
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=g)
    return _param(t.to(dtype))


def embed_init(g: torch.Generator, shape, dtype: torch.dtype) -> nn.Parameter:
    t = torch.randn(shape, generator=g, device=g.device) * 0.02
    return _param(t.to(dtype))


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def ones(dim: int, dtype: torch.dtype, device) -> nn.Parameter:
    return _param(torch.ones(dim, dtype=dtype, device=device))


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #
class RMSNorm(nn.Module):
    """RMSNorm computed in fp32, returned in the input's dtype."""

    def __init__(self, dim: int, dtype: torch.dtype, device):
        super().__init__()
        self.scale = ones(dim, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(self.scale, x)


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """RMSNorm over the last axis in fp32; also the head-wise qk-norm when
    ``x`` is (..., heads, head_dim) and ``scale`` is (head_dim,)."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# --------------------------------------------------------------------- #
# RoPE (split-half, not interleaved)
# --------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., seq, hd/2)
    sin = torch.sin(angles)[..., None, :]  # (..., seq, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------- #
class SwiGLU(nn.Module):
    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        d, ff, pd = cfg.d_model, cfg.d_ff, cfg.pdtype
        self.wi = dense_init(g, (d, ff), pd)
        self.wg = dense_init(g, (d, ff), pd)
        self.wo = dense_init(g, (ff, d), pd)
        self.dtype = cfg.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = nn.functional.silu(x @ self.wg.to(dt)) * (x @ self.wi.to(dt))
        return h @ self.wo.to(dt)


# --------------------------------------------------------------------- #
# embeddings / unembedding
# --------------------------------------------------------------------- #
class Embedding(nn.Module):
    """Token table (vocab, d_model).  ``unembed`` returns fp32 logits from
    an fp32 copy of the table, made once and reused while the table is
    unchanged: casting a 151936 x 2048 table on every decode step would
    allocate 1.24 GB per step."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.table = embed_init(g, (cfg.vocab_size, cfg.d_model), cfg.pdtype)
        self.dtype = cfg.dtype
        self._table_f32: tuple | None = None  # (data_ptr, version, tensor)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table.to(self.dtype)[tokens]

    def table_f32(self) -> torch.Tensor:
        t = self.table
        key = (t.data_ptr(), t._version)
        cached = self._table_f32
        if cached is None or cached[:2] != key:
            cached = (*key, t.detach().float())
            self._table_f32 = cached
        return cached[2]

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits, x.float() @ table.T in fp32."""
        return x.float() @ self.table_f32().T
