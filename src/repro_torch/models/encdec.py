"""Whisper-style encoder-decoder backbone: the reference package's
``repro/models/encdec.py``.

The conv/mel frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings ``enc_frames`` (B, S_enc, d_model).
Sinusoidal positions, pre-LayerNorm, GELU MLPs, a tied head.  Encoder
layers: non-causal self-attention, then the MLP.  Decoder layers: causal
self-attention (cached at decode), cross-attention over the encoder
output (a static cache made once at prefill), then the MLP.  The
encoder's and the decoder's layers are an ``nn.ModuleList`` each (the
reference stacks their parameters along a leading layer axis).

Entry points, as the LM's: ``train_loss``, ``prefill`` (last-token fp32
logits and one cache a decoder layer, ``{"self": {"k","v"}, "cross":
{"k","v"}}``) and ``decode`` (caches updated in place).  Every attention
product but the cross-attention decode goes through ``ops``: the encoder
layers, the decoder's causal self-attention and its non-causal
cross-attention at prefill through the flash kernel, the self-attention
decode through the decode kernel; the cross-attention decode is the plain
``decode_attention_xla``, as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import DISPATCH, AttentionOps
from ..sharding.hints import shard_hint
from .attention import Attention, make_empty_cache
from .blocks import pad_seq
from .common import ModelConfig, sinusoidal_positions
from .layers import Embedding, make_mlp, make_norm
from .loss import fused_cross_entropy


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.attn_norm = make_norm(cfg, g.device)
        self.attn = Attention(cfg, g)
        self.mlp_norm = make_norm(cfg, g.device)
        self.mlp = make_mlp(cfg, g)

    def forward(self, x, attend):
        x = x + attend(self.attn, self.attn_norm(x))
        return x + self.mlp(self.mlp_norm(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.self_norm = make_norm(cfg, g.device)
        self.self_attn = Attention(cfg, g)
        self.cross_norm = make_norm(cfg, g.device)
        self.cross_attn = Attention(cfg, g)
        self.mlp_norm = make_norm(cfg, g.device)
        self.mlp = make_mlp(cfg, g)

    def _mlp(self, x):
        return x + self.mlp(self.mlp_norm(x))


class EncDec(nn.Module):
    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg, g)  # decoder tokens; the tied head
        self.encoder = nn.ModuleList(EncoderLayer(cfg, g)
                                     for _ in range(cfg.n_encoder_layers))
        self.decoder = nn.ModuleList(DecoderLayer(cfg, g) for _ in range(cfg.n_layers))
        self.enc_final_norm = make_norm(cfg, g.device)
        self.dec_final_norm = make_norm(cfg, g.device)
        self.refresh()

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def head(self) -> Embedding:
        return self.embed

    def refresh(self) -> None:
        """Make the fp32 unembedding copy now (see ``LM.refresh``)."""
        self.head().table_f32()

    def _positions(self, n: int, offset: int = 0) -> torch.Tensor:
        return sinusoidal_positions(n, self.cfg.d_model, self.device,
                                    offset).to(self.cfg.dtype)

    def encode(self, frames, *, ops: AttentionOps, train: bool = False):
        """frames (B, S_enc, d) -> (B, S_enc, d): non-causal attention
        without rope, through ``ops.train`` when ``train`` else
        ``ops.prefill``."""
        x = frames.to(self.cfg.dtype)
        x = x + self._positions(x.shape[1])[None]

        def attend(attn, h):
            if train:
                return attn.forward_train(h, window=None, ops=ops, causal=False,
                                          use_rope=False)
            return attn.prefill(h, window=None, ops=ops, use_rope=False,
                                causal=False)[0]

        for layer in self.encoder:
            x = layer(x, attend)
        return self.enc_final_norm(x)

    def _dec_embed(self, tokens):
        return self.embed(tokens) + self._positions(tokens.shape[1])[None]

    def forward(self, batch, **kw):
        """``train_loss``: the module's call, which ``functional_call`` makes."""
        return self.train_loss(batch, **kw)

    def train_loss(self, batch, *, ops: AttentionOps = DISPATCH, long_context=False,
                   block_skip=False):
        """batch: enc_frames (B,S_enc,d), tokens (B,S) int, targets (B,S)
        int [, loss_mask (B,S)].  Returns (loss, {"ce_loss", "aux_loss"}),
        fp32 scalars.  ``long_context`` and ``block_skip`` are accepted and
        discarded, as the reference's encoder-decoder discards them."""
        del long_context, block_skip
        if ops.train is None:
            raise ValueError("train_loss needs AttentionOps with a train member")
        enc_out = self.encode(batch["enc_frames"], ops=ops, train=True)
        x = self._dec_embed(batch["tokens"])
        for layer in self.decoder:
            x = x + layer.self_attn.forward_train(layer.self_norm(x), window=None,
                                                  ops=ops, use_rope=False)
            x = x + layer.cross_attn.forward_train(layer.cross_norm(x), window=None,
                                                   ops=ops, kv=enc_out)
            x = layer._mlp(x)
        x = self.dec_final_norm(x)
        loss = fused_cross_entropy(x, self.embed.table, batch["targets"],
                                   batch.get("loss_mask"))
        return loss, {"ce_loss": loss,
                      "aux_loss": torch.zeros((), dtype=torch.float32, device=x.device)}

    @torch.no_grad()
    def prefill(self, batch, *, seq_budget: int | None = None,
                ops: AttentionOps = DISPATCH, long_context=False):
        """Encode ``enc_frames`` and run the decoder over ``tokens``.
        Returns (last-token logits (B,V) fp32, caches): each layer's
        self-attention K/V zero-padded to ``seq_budget`` and its static
        cross K/V of the encoder output.  ``long_context`` is ignored, as
        in the reference."""
        enc_out = self.encode(batch["enc_frames"], ops=ops)
        tokens = batch["tokens"]
        seq_budget = max(seq_budget or 0, tokens.shape[1])
        x = self._dec_embed(tokens)
        caches = []
        for layer in self.decoder:
            h, kv = layer.self_attn.prefill(layer.self_norm(x), window=None, ops=ops,
                                            use_rope=False)
            x = x + h
            kc, vc = layer.cross_attn.cross_kv(enc_out)
            x = x + layer.cross_attn.cross_prefill(layer.cross_norm(x), kc, vc, ops=ops)
            x = layer._mlp(x)
            caches.append({"self": {name: pad_seq(a, seq_budget) for name, a in kv.items()},
                           "cross": {"k": kc, "v": vc}})
        x = self.dec_final_norm(x)
        return shard_hint(self.head().unembed(x[:, -1:]), "logits")[:, 0], caches

    @torch.no_grad()
    def decode(self, batch, caches, *, cache_index: int,
               ops: AttentionOps = DISPATCH, long_context=False):
        """batch: tokens (B,1).  One decoder token at position
        ``cache_index`` against each layer's self cache (written in place)
        and its cross cache.  Returns (logits (B,V) fp32, caches).
        ``long_context`` is ignored, as in the reference."""
        x = self.embed(batch["tokens"]) + self._positions(1, cache_index)[None]
        for layer, c in zip(self.decoder, caches):
            h, c["self"] = layer.self_attn.decode(
                layer.self_norm(x), c["self"], cache_index=cache_index, window=None,
                ops=ops, use_rope=False)
            x = x + h
            x = x + layer.cross_attn.cross_decode(layer.cross_norm(x), c["cross"])
            x = layer._mlp(x)
        x = self.dec_final_norm(x)
        return shard_hint(self.head().unembed(x), "logits")[:, 0], caches

    def make_caches(self, batch: int, seq_len: int):
        """Each decoder layer's empty caches: ``seq_len`` self-attention
        slots and ``encoder_seq_len`` cross slots."""
        cfg, dev = self.cfg, self.device
        return [{"self": make_empty_cache(cfg, batch, seq_len, dev),
                 "cross": make_empty_cache(cfg, batch, cfg.encoder_seq_len, dev)}
                for _ in self.decoder]
