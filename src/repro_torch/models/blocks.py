"""Block assembly: one pre-norm attention + dense-MLP block, and the
layer stack as an ``nn.ModuleList`` run by a Python loop (the reference
package scans over parameters stacked along a repeats axis)."""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import AttentionOps
from .attention import Attention
from .common import BlockSpec, ModelConfig
from .layers import RMSNorm, SwiGLU


class Block(nn.Module):
    """``x + attn(norm(x))`` then ``x + mlp(norm(x))``."""

    def __init__(self, cfg: ModelConfig, spec: BlockSpec, g: torch.Generator):
        super().__init__()
        if spec.mixer != "attn" or spec.mlp != "dense":
            raise NotImplementedError(
                f"block {spec} is not ported: only attn + dense blocks")
        self.mixer_norm = RMSNorm(cfg.d_model, cfg.pdtype, g.device)
        self.attn = Attention(cfg, g)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.pdtype, g.device)
        self.mlp = SwiGLU(cfg, g)
        self.window = spec.window

    def forward_train(self, x, *, ops: AttentionOps):
        """Differentiable; returns (x, aux loss): aux is 0 for dense blocks
        (the reference's ``apply_block_train``)."""
        x = x + self.attn.forward_train(self.mixer_norm(x), window=self.window,
                                        ops=ops)
        x = x + self.mlp(self.mlp_norm(x))
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def prefill(self, x, *, seq_budget: int, ops: AttentionOps):
        """Returns (x, cache); the cache is zero-padded to ``seq_budget``
        positions, leaving slots for the decoded tokens."""
        h, kv = self.attn.prefill(self.mixer_norm(x), window=self.window,
                                  ops=ops)
        cache = {}
        for name, a in kv.items():
            c = a.new_zeros((a.shape[0], seq_budget) + tuple(a.shape[2:]))
            c[:, :a.shape[1]] = a
            cache[name] = c
        x = x + h
        x = x + self.mlp(self.mlp_norm(x))
        return x, cache

    def decode(self, x, cache, *, cache_index: int, ops: AttentionOps):
        h, cache = self.attn.decode(self.mixer_norm(x), cache,
                                    cache_index=cache_index,
                                    window=self.window, ops=ops)
        x = x + h
        x = x + self.mlp(self.mlp_norm(x))
        return x, cache


def make_blocks(cfg: ModelConfig, g: torch.Generator) -> nn.ModuleList:
    """``cfg.n_layers`` blocks, layer i shaped by ``pattern[i % len]``."""
    return nn.ModuleList(Block(cfg, cfg.pattern[i % len(cfg.pattern)], g)
                         for i in range(cfg.n_layers))
