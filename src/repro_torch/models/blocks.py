"""Block assembly: one pre-norm block (an attention — GQA or MLA — or
Mamba mixer, then a dense MLP, an MoE or none), and the layer stack as an
``nn.ModuleList`` run by a Python loop (the reference package scans over
parameters stacked along a repeats axis)."""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import AttentionOps
from .attention import Attention
from .common import BlockSpec, ModelConfig
from .layers import make_mlp, make_norm
from .mamba import Mamba
from .mla import MLA
from .moe import MoE


def _window_for(cfg: ModelConfig, spec: BlockSpec, long_context: bool):
    """The attention window of a block: its own ``spec.window``, else at
    long context ``cfg.long_context_window`` for an attention mixer, else
    None (full causal attention), as the reference's ``_window_for``."""
    if spec.window is not None:
        return spec.window
    if long_context and spec.mixer == "attn" and cfg.long_context_window:
        return cfg.long_context_window
    return None


def pad_seq(a: torch.Tensor, seq_budget: int) -> torch.Tensor:
    """``a`` (B, S, ...) zero-padded along S to ``seq_budget`` positions."""
    c = a.new_zeros((a.shape[0], seq_budget) + tuple(a.shape[2:]))
    c[:, :a.shape[1]] = a
    return c


class Block(nn.Module):
    """``x + mixer(norm(x))`` then, unless the MLP is "none",
    ``x + mlp(norm(x))``.  The mixer is ``attn`` (GQA, or MLA when
    ``cfg.attention == "mla"``) or ``mamba``; the MLP ``dense`` (SwiGLU or
    GELU by ``cfg.mlp_act``), ``moe`` (``models/moe.py``, whose aux loss
    training adds up) or ``none``; the norms RMS or Layer by
    ``cfg.norm_type``.  A Mamba mixer ignores ``cache_index`` and
    ``seq_budget``: its state has a fixed size."""

    def __init__(self, cfg: ModelConfig, spec: BlockSpec, g: torch.Generator):
        super().__init__()
        if (spec.mixer not in ("attn", "mamba")
                or spec.mlp not in ("dense", "moe", "none")
                or (spec.mixer == "attn" and cfg.attention not in ("gqa", "mla"))):
            raise NotImplementedError(
                f"block {spec} of {cfg.name} is not ported: only attn (GQA or "
                "MLA) or mamba mixers with a dense MLP, an MoE or none")
        self.mixer_norm = make_norm(cfg, g.device)
        if spec.mixer == "attn":
            self.attn = MLA(cfg, g) if cfg.attention == "mla" else Attention(cfg, g)
        else:
            self.mamba = Mamba(cfg, g)
        if spec.mlp != "none":
            self.mlp_norm = make_norm(cfg, g.device)
        if spec.mlp == "dense":
            self.mlp = make_mlp(cfg, g)
        elif spec.mlp == "moe":
            self.moe = MoE(cfg, g)
        self.spec = spec
        self.cfg = cfg

    def _mlp_aux(self, x):
        """(x + mlp(norm(x)), the MLP's aux loss: the MoE's, else 0)."""
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.spec.mlp == "none":
            return x, zero
        if self.spec.mlp == "moe":
            h, aux = self.moe(self.mlp_norm(x))
            return x + h, aux
        return x + self.mlp(self.mlp_norm(x)), zero

    def _mlp(self, x):
        """Serving drops the aux loss, as the reference's prefill and
        decode do."""
        return self._mlp_aux(x)[0]

    def forward_train(self, x, *, ops: AttentionOps, long_context=False):
        """Differentiable; returns (x, aux loss): the MoE's load-balance and
        z losses, 0 for the other blocks (the reference's
        ``apply_block_train``)."""
        h = self.mixer_norm(x)
        if self.spec.mixer == "attn":
            window = _window_for(self.cfg, self.spec, long_context)
            h = self.attn.forward_train(h, window=window, ops=ops)
        else:
            h = self.mamba.forward_train(h, ops=ops)
        return self._mlp_aux(x + h)

    def prefill(self, x, *, seq_budget: int, ops: AttentionOps, long_context=False):
        """Returns (x, cache).  An attention cache (K/V, or MLA's latent)
        is zero-padded to ``seq_budget`` positions, leaving slots for the
        decoded tokens; a Mamba cache is the layer's state after the
        prompt."""
        if self.spec.mixer == "mamba":
            h, cache = self.mamba.prefill(self.mixer_norm(x), ops=ops)
            return self._mlp(x + h), cache
        window = _window_for(self.cfg, self.spec, long_context)
        h, kv = self.attn.prefill(self.mixer_norm(x), window=window, ops=ops)
        cache = {name: pad_seq(a, seq_budget) for name, a in kv.items()}
        return self._mlp(x + h), cache

    def decode(self, x, cache, *, cache_index: int, ops: AttentionOps,
               long_context=False):
        if self.spec.mixer == "mamba":
            h, cache = self.mamba.decode(self.mixer_norm(x), cache)
        else:
            h, cache = self.attn.decode(self.mixer_norm(x), cache, cache_index=cache_index,
                                        window=_window_for(self.cfg, self.spec, long_context),
                                        ops=ops)
        return self._mlp(x + h), cache

    def make_cache(self, batch: int, seq_len: int):
        """An empty cache: (B, seq_len) KV or latent slots, or a zero Mamba
        state."""
        if self.spec.mixer == "mamba":
            return self.mamba.make_empty_state(batch)
        return self.attn.make_cache(batch, seq_len)


def make_blocks(cfg: ModelConfig, g: torch.Generator) -> nn.ModuleList:
    """``cfg.n_layers`` blocks, layer i shaped by ``pattern[i % len]``."""
    return nn.ModuleList(Block(cfg, cfg.pattern[i % len(cfg.pattern)], g)
                         for i in range(cfg.n_layers))
