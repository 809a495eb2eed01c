"""Decoder-only LM built from the block stack: prefill and decode.

``LM`` is the port's parameter tree: an ``nn.Module`` whose weights live
on one device.  Its entry points take and return the reference
package's shapes:
  prefill  -> (last-token logits (B,V) fp32, caches)
  decode   -> (logits (B,V) fp32, caches)   [caches updated in place]
Both take ``ops``, the attention functions every layer calls: the
kernels' dispatch by default (see ``repro_torch.kernels``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import DISPATCH, AttentionOps
from .attention import make_empty_cache
from .blocks import make_blocks
from .common import ModelConfig
from .layers import Embedding, RMSNorm


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg, g)
        self.blocks = make_blocks(cfg, g)
        self.final_norm = RMSNorm(cfg.d_model, cfg.pdtype, g.device)
        if not cfg.tie_embeddings:
            self.lm_head = Embedding(cfg, g)
        self.refresh()

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def head(self) -> Embedding:
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def refresh(self) -> None:
        """Make the fp32 unembedding copy now, on the caller's stream,
        so services never race to build it.  Call after changing weights."""
        self.head().table_f32()

    @torch.no_grad()
    def prefill(self, batch, *, seq_budget: int | None = None,
                ops: AttentionOps = DISPATCH):
        """batch: tokens (B,S) int. Returns (last-token logits (B,V), caches)."""
        x = self.embed(batch["tokens"])
        seq_budget = max(seq_budget or 0, x.shape[1])
        caches = []
        for blk in self.blocks:
            x, c = blk.prefill(x, seq_budget=seq_budget, ops=ops)
            caches.append(c)
        x = self.final_norm(x)
        logits = self.head().unembed(x[:, -1:, :])
        return logits[:, 0], caches

    @torch.no_grad()
    def decode(self, batch, caches, *, cache_index: int,
               ops: AttentionOps = DISPATCH):
        """batch: tokens (B,1). Returns (logits (B,V), caches)."""
        x = self.embed(batch["tokens"])
        for i, blk in enumerate(self.blocks):
            x, caches[i] = blk.decode(x, caches[i], cache_index=cache_index,
                                     ops=ops)
        x = self.final_norm(x)
        return self.head().unembed(x)[:, 0], caches

    def make_caches(self, batch: int, seq_len: int):
        return [make_empty_cache(self.cfg, batch, seq_len, self.device)
                for _ in self.blocks]
