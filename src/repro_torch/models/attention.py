"""GQA attention: training, prefill and cached decode, self- or
cross-attention, plus the plain references.

The attention products themselves go through the ``AttentionOps`` pair
the model's entry points pass down, by default the dispatch of
``repro_torch.kernels``: on a CUDA tensor the hand-written flash-prefill
and flash-decode kernels, on a CPU tensor their plain PyTorch versions.  ``chunked_attention`` and
``decode_attention_xla`` are the plain references of the reference
package's XLA path (a chunked online softmax and a masked one-token
decode); the dispatch uses them for windowed prefill and decode on every
device (jamba's attention at long context; windowed training runs the
chunked flash with its manual backward), and
whisper's decoder uses ``decode_attention_xla`` for its cross-attention
decode on every device, as the reference does (it has no kernel there).
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import AttentionOps
from ..kernels.flash_attention.chunked import chunked_forward
from ..sharding.hints import contraction_layout, merge_heads, split_heads, write_slot
from .common import ModelConfig
from .layers import apply_rope, dense_init, ones, rms_norm

NEG_INF = -2.0e38


# --------------------------------------------------------------------- #
# plain references
# --------------------------------------------------------------------- #
def chunked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None, q_chunk: int = 512,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Chunked online-softmax attention. q (B,Sq,H,D), k (B,Sk,K,D),
    v (B,Sk,K,Dv) -> (B,Sq,H,Dv) in v's dtype; fp32 softmax.  Chunks of
    ``q_chunk`` queries and ``kv_chunk`` keys, the last of each ragged
    (the reference scans chunks of the largest divisor of the length up to
    those sizes: one position at a prime length, which a loop here would
    take ~S^2 steps over).  The forward of the chunked flash
    (``kernels/flash_attention/chunked.py``)."""
    return chunked_forward(q, k, v, causal=causal, window=window, q_chunk=q_chunk,
                           kv_chunk=kv_chunk)[0]


def decode_attention_xla(q, k_cache, v_cache, *, cache_index: int,
                         window: int | None = None) -> torch.Tensor:
    """Single-token decode against a full cache. q (B,1,H,D) ->
    (B,1,H,Dv) in the cache dtype; positions > cache_index are masked."""
    B, S, K, D = k_cache.shape
    H = q.shape[2]
    G = H // K
    Dv = v_cache.shape[-1]
    qg = q.reshape(B, K, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * (D ** -0.5)
    pos = torch.arange(S, device=q.device)
    mask = pos <= cache_index
    if window is not None:
        mask &= pos > cache_index - window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskv->bkgv", w.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, Dv).to(v_cache.dtype)


# --------------------------------------------------------------------- #
# GQA attention layer
# --------------------------------------------------------------------- #
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        d, hd, pd = cfg.d_model, cfg.head_dim, cfg.pdtype
        self.wq = dense_init(g, (d, cfg.n_heads * hd), pd)
        self.wk = dense_init(g, (d, cfg.n_kv_heads * hd), pd)
        self.wv = dense_init(g, (d, cfg.n_kv_heads * hd), pd)
        self.wo = dense_init(g, (cfg.n_heads * hd, d), pd)
        if cfg.qk_norm:
            self.q_norm = ones(hd, pd, g.device)
            self.k_norm = ones(hd, pd, g.device)
        self.cfg = cfg

    def _q(self, x):
        cfg = self.cfg
        return split_heads(x @ self.wq.to(cfg.dtype), cfg.n_heads, cfg.head_dim)

    def cross_kv(self, src):
        """(k, v) of an external source (B,Skv,d): the encoder output a
        whisper decoder layer attends to, with no qk-norm and no rope."""
        cfg = self.cfg
        dt, hd = cfg.dtype, cfg.head_dim
        k = split_heads(src @ self.wk.to(dt), cfg.n_kv_heads, hd)
        v = split_heads(src @ self.wv.to(dt), cfg.n_kv_heads, hd)
        return k, v

    def _project_qkv(self, x, positions):
        """q, k, v of ``x``; rope at ``positions``, or none when it is None
        (whisper's sinusoidal-position layers)."""
        cfg = self.cfg
        q = self._q(x)
        k, v = self.cross_kv(x)
        if cfg.qk_norm:  # qk-norm before rope
            q = rms_norm(self.q_norm, q)
            k = rms_norm(self.k_norm, k)
        if positions is not None:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    @staticmethod
    def _positions(x, use_rope):
        return torch.arange(x.shape[1], device=x.device) if use_rope else None

    def _out(self, o):
        return merge_heads(o) @ self.wo.to(self.cfg.dtype)

    def forward_train(self, x, *, window, ops: AttentionOps, causal=True,
                      use_rope=True, kv=None):
        """Differentiable attention over the whole sequence (the
        reference's ``apply_attention_train``): self-attention, or with
        ``kv`` (B,Skv,d) non-causal cross-attention with no rope."""
        if kv is None:
            q, k, v = self._project_qkv(x, self._positions(x, use_rope))
        else:
            q, (k, v), causal = self._q(x), self.cross_kv(kv), False
        return self._out(ops.train(q, k, v, causal=causal, window=window))

    def prefill(self, x, *, window, ops: AttentionOps, use_rope=True,
                causal=True):
        """Attention over the prompt (causal unless told otherwise: whisper's
        encoder); also returns its (k, v)."""
        q, k, v = self._project_qkv(x, self._positions(x, use_rope))
        out = ops.prefill(q, k, v, causal=causal, window=window)
        return self._out(out), {"k": k, "v": v}

    def cross_prefill(self, x, k, v, *, ops: AttentionOps):
        """Non-causal attention of ``x``'s queries over the cross cache
        (k, v) (``cross_kv`` of the encoder output)."""
        return self._out(ops.prefill(self._q(x), k, v, causal=False))

    def cross_decode(self, x, cache):
        """One token against the static cross cache {"k","v"}: the plain
        ``decode_attention_xla`` at cache_index Skv - 1, on every device
        (the reference's ``kv_cross`` decode has no kernel)."""
        out = decode_attention_xla(self._q(x), cache["k"], cache["v"],
                                   cache_index=cache["k"].shape[1] - 1)
        return self._out(out)

    def decode(self, x, cache, *, cache_index: int, window,
               ops: AttentionOps, use_rope=True):
        """One-token decode. x: (B,1,d); cache {"k","v"}: (B,S,K,hd).
        The new token's k/v are written into the cache IN PLACE at
        ``cache_index`` (the reference returns an updated copy); the
        same cache dict is returned."""
        positions = (torch.full((1,), cache_index, dtype=torch.int64,
                                device=x.device) if use_rope else None)
        q, k, v = self._project_qkv(contraction_layout(x, self.wq), positions)
        write_slot(cache["k"], cache_index, k[:, 0])
        write_slot(cache["v"], cache_index, v[:, 0])
        out = ops.decode(q, cache["k"], cache["v"], cache_index=cache_index,
                         window=window)
        return self._out(out), cache

    def make_cache(self, batch: int, seq_len: int):
        return make_empty_cache(self.cfg, batch, seq_len, self.wo.device)


def make_empty_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    shape = (batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
