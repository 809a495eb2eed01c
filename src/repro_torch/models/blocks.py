"""Block assembly: one pre-norm block (an attention or Mamba mixer, then
a dense MLP or none), and the layer stack as an ``nn.ModuleList`` run by
a Python loop (the reference package scans over parameters stacked along
a repeats axis)."""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import AttentionOps
from .attention import Attention, make_empty_cache
from .common import BlockSpec, ModelConfig
from .layers import RMSNorm, SwiGLU
from .mamba import Mamba


class Block(nn.Module):
    """``x + mixer(norm(x))`` then, unless the MLP is "none",
    ``x + mlp(norm(x))``.  The mixer is ``attn`` (GQA) or ``mamba``; the
    MLP ``dense`` (SwiGLU) or ``none``.  A Mamba mixer ignores
    ``cache_index`` and ``seq_budget``: its state has a fixed size."""

    def __init__(self, cfg: ModelConfig, spec: BlockSpec, g: torch.Generator):
        super().__init__()
        if (spec.mixer not in ("attn", "mamba") or spec.mlp not in ("dense", "none")
                or (spec.mixer == "attn" and cfg.attention != "gqa")):
            raise NotImplementedError(
                f"block {spec} of {cfg.name} is not ported: only attn (GQA) or "
                "mamba mixers with a dense MLP or none")
        self.mixer_norm = RMSNorm(cfg.d_model, cfg.pdtype, g.device)
        if spec.mixer == "attn":
            self.attn = Attention(cfg, g)
        else:
            self.mamba = Mamba(cfg, g)
        if spec.mlp == "dense":
            self.mlp_norm = RMSNorm(cfg.d_model, cfg.pdtype, g.device)
            self.mlp = SwiGLU(cfg, g)
        self.spec = spec
        self.cfg = cfg

    def _mlp(self, x):
        if self.spec.mlp == "none":
            return x
        return x + self.mlp(self.mlp_norm(x))

    def forward_train(self, x, *, ops: AttentionOps):
        """Differentiable; returns (x, aux loss): aux is 0 for these blocks
        (the reference's ``apply_block_train``)."""
        h = self.mixer_norm(x)
        if self.spec.mixer == "attn":
            h = self.attn.forward_train(h, window=self.spec.window, ops=ops)
        else:
            h = self.mamba.forward_train(h, ops=ops)
        x = self._mlp(x + h)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def prefill(self, x, *, seq_budget: int, ops: AttentionOps):
        """Returns (x, cache).  An attention cache is zero-padded to
        ``seq_budget`` positions, leaving slots for the decoded tokens; a
        Mamba cache is the layer's state after the prompt."""
        if self.spec.mixer == "mamba":
            h, cache = self.mamba.prefill(self.mixer_norm(x), ops=ops)
            return self._mlp(x + h), cache
        h, kv = self.attn.prefill(self.mixer_norm(x), window=self.spec.window,
                                  ops=ops)
        cache = {}
        for name, a in kv.items():
            c = a.new_zeros((a.shape[0], seq_budget) + tuple(a.shape[2:]))
            c[:, :a.shape[1]] = a
            cache[name] = c
        return self._mlp(x + h), cache

    def decode(self, x, cache, *, cache_index: int, ops: AttentionOps):
        if self.spec.mixer == "mamba":
            h, cache = self.mamba.decode(self.mixer_norm(x), cache)
        else:
            h, cache = self.attn.decode(self.mixer_norm(x), cache,
                                        cache_index=cache_index,
                                        window=self.spec.window, ops=ops)
        return self._mlp(x + h), cache

    def make_cache(self, batch: int, seq_len: int):
        """An empty cache: (B, seq_len) KV slots, or a zero Mamba state."""
        if self.spec.mixer == "mamba":
            return self.mamba.make_empty_state(batch)
        return make_empty_cache(self.cfg, batch, seq_len,
                                self.mixer_norm.scale.device)


def make_blocks(cfg: ModelConfig, g: torch.Generator) -> nn.ModuleList:
    """``cfg.n_layers`` blocks, layer i shaped by ``pattern[i % len]``."""
    return nn.ModuleList(Block(cfg, cfg.pattern[i % len(cfg.pattern)], g)
                         for i in range(cfg.n_layers))
