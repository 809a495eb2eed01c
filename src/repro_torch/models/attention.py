"""GQA attention: prefill and cached decode, plus the plain references.

The attention products themselves go through the ``AttentionOps`` pair
the model's entry points pass down, by default the dispatch of
``repro_torch.kernels``: on a CUDA tensor the hand-written flash-prefill
and flash-decode kernels, on a CPU tensor their plain PyTorch versions.  ``chunked_attention`` and
``decode_attention_xla`` are the plain references of the reference
package's XLA path (a chunked online softmax and a masked one-token
decode); the dispatch uses them for windowed attention on the CPU.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import AttentionOps
from .common import ModelConfig
from .layers import apply_rope, dense_init, ones, rms_norm

NEG_INF = -2.0e38


def _pick_chunk(seq: int, target: int) -> int:
    """Largest divisor of ``seq`` that is <= target."""
    c = min(seq, target)
    while seq % c:
        c -= 1
    return c


# --------------------------------------------------------------------- #
# plain references
# --------------------------------------------------------------------- #
def chunked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None, q_chunk: int = 512,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Chunked online-softmax attention. q (B,Sq,H,D), k (B,Sk,K,D),
    v (B,Sk,K,Dv) -> (B,Sq,H,Dv) in v's dtype; fp32 softmax."""
    B, Sq, H, D = q.shape
    Sk, K, Dv = v.shape[1], k.shape[2], v.shape[3]
    G = H // K
    scale = D ** -0.5
    qc, kc = _pick_chunk(Sq, q_chunk), _pick_chunk(Sk, kv_chunk)
    qg = q.reshape(B, Sq, K, G, D).float()
    kf, vf = k.float(), v.float()
    kv_pos = torch.arange(Sk, device=q.device)
    outs = []
    for q0 in range(0, Sq, qc):
        qi = qg[:, q0:q0 + qc]
        qpos = q0 + torch.arange(qc, device=q.device)
        acc = torch.zeros(B, qc, K, G, Dv, device=q.device)
        m = torch.full((B, K, G, qc), NEG_INF, device=q.device)
        l = torch.zeros(B, K, G, qc, device=q.device)
        for k0 in range(0, Sk, kc):
            s = torch.einsum("bqkgd,bckd->bkgqc", qi, kf[:, k0:k0 + kc]) * scale
            kpos = kv_pos[k0:k0 + kc]
            mask = torch.ones(qc, kpos.numel(), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bkgqc,bckv->bqkgv", p.to(v.dtype).float(),
                              vf[:, k0:k0 + kc])
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        out = acc / l.clamp_min(1e-37).permute(0, 3, 1, 2)[..., None]
        outs.append(out.reshape(B, qc, H, Dv))
    return torch.cat(outs, dim=1).to(v.dtype)


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

    def _project_qkv(self, x, positions):
        cfg = self.cfg
        B, S, _ = x.shape
        hd, dt = cfg.head_dim, cfg.dtype
        q = (x @ self.wq.to(dt)).reshape(B, S, cfg.n_heads, hd)
        k = (x @ self.wk.to(dt)).reshape(B, S, cfg.n_kv_heads, hd)
        v = (x @ self.wv.to(dt)).reshape(B, S, cfg.n_kv_heads, hd)
        if cfg.qk_norm:  # qk-norm before rope
            q = rms_norm(self.q_norm, q)
            k = rms_norm(self.k_norm, k)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _out(self, o):
        B, S = o.shape[:2]
        return o.reshape(B, S, -1) @ self.wo.to(self.cfg.dtype)

    def prefill(self, x, *, window, ops: AttentionOps):
        """Causal attention over the prompt; also returns its (k, v)."""
        positions = torch.arange(x.shape[1], device=x.device)
        q, k, v = self._project_qkv(x, positions)
        out = ops.prefill(q, k, v, causal=True, window=window)
        return self._out(out), {"k": k, "v": v}

    def decode(self, x, cache, *, cache_index: int, window,
               ops: AttentionOps):
        """One-token decode. x: (B,1,d); cache {"k","v"}: (B,S,K,hd).
        The new token's k/v are written into the cache IN PLACE at
        ``cache_index`` (the reference returns an updated copy); the
        same cache dict is returned."""
        positions = torch.full((1,), cache_index, dtype=torch.int64,
                               device=x.device)
        q, k, v = self._project_qkv(x, positions)
        cache["k"][:, cache_index] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, cache_index] = v[:, 0].to(cache["v"].dtype)
        out = ops.decode(q, cache["k"], cache["v"], cache_index=cache_index,
                         window=window)
        return self._out(out), cache


def make_empty_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    shape = (batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
