"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style): the
reference package's ``repro/models/mla.py``.

Train and prefill materialise per-head K and V from the latent and run
the flash kernels through ``ops`` (q and k have nope + rope dims, v has
``v_head_dim``: D = 96 with Dv = 64 at minicpm3's widths).  Decode is the
*absorbed* form: scores and values are computed against the compressed
latent cache (kv_lora_rank + rope dims a token), in fp32 einsums with no
kernel, as in the reference.  A layer's cache is ``{"c_kv": (B,S,R),
"k_rope": (B,S,rope)}`` in the compute dtype, written in place by decode.
The methods take ``Attention``'s keywords, so a block calls either mixer
the same way; ``window`` is ignored, as the reference's MLA ignores it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import AttentionOps
from ..sharding.hints import merge_heads, split_heads, write_slot
from .common import ModelConfig
from .layers import apply_rope, dense_init, ones, rms_norm

NEG_INF = -2.0e38


class MLA(nn.Module):
    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        d, H, pd, dev = cfg.d_model, cfg.n_heads, cfg.pdtype, g.device
        nope, rope, vdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        if cfg.q_lora_rank:
            self.wq_a = dense_init(g, (d, cfg.q_lora_rank), pd)
            self.q_a_norm = ones(cfg.q_lora_rank, pd, dev)
            self.wq_b = dense_init(g, (cfg.q_lora_rank, H * (nope + rope)), pd)
        else:
            self.wq = dense_init(g, (d, H * (nope + rope)), pd)
        self.wkv_a = dense_init(g, (d, cfg.kv_lora_rank + rope), pd)
        self.kv_a_norm = ones(cfg.kv_lora_rank, pd, dev)
        self.wkv_b = dense_init(g, (cfg.kv_lora_rank, H * (nope + vdim)), pd)
        self.wo = dense_init(g, (H * vdim, d), pd)
        self.cfg = cfg

    def _queries(self, x, positions):
        """(q_nope (B,S,H,nope), q_rope (B,S,H,rope) with rope applied)."""
        cfg = self.cfg
        dt, nope = cfg.dtype, cfg.qk_nope_head_dim
        if cfg.q_lora_rank:
            ql = rms_norm(self.q_a_norm, x @ self.wq_a.to(dt))
            q = ql @ self.wq_b.to(dt)
        else:
            q = x @ self.wq.to(dt)
        q = split_heads(q, cfg.n_heads, nope + cfg.qk_rope_head_dim)
        q_nope, q_rope = q[..., :nope], q[..., nope:]
        return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)

    def _latent(self, x, positions):
        """(c_kv (B,S,R) normalised latent, k_rope (B,S,rope))."""
        cfg = self.cfg
        R = cfg.kv_lora_rank
        kv_a = x @ self.wkv_a.to(cfg.dtype)
        c_kv = rms_norm(self.kv_a_norm, kv_a[..., :R])
        k_rope = apply_rope(kv_a[..., R:][..., None, :], positions, cfg.rope_theta)
        return c_kv, k_rope[..., 0, :]

    def _materialised(self, x, attend):
        """The train/prefill path: per-head q, k, v from the latent, then
        ``attend(q, k, v)``; returns (out (B,S,d), c_kv, k_rope)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, nope, rope = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        positions = torch.arange(S, device=x.device)
        q_nope, q_rope = self._queries(x, positions)
        c_kv, k_rope = self._latent(x, positions)
        kv = split_heads(c_kv @ self.wkv_b.to(cfg.dtype), H, nope + cfg.v_head_dim)
        # K == H (no GQA in MLA); the kernels read contiguous tensors, and
        # v is a strided view of kv
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([kv[..., :nope], k_rope[:, :, None, :].expand(B, S, H, rope)], -1)
        v = kv[..., nope:].contiguous()
        out = merge_heads(attend(q, k, v))
        return out @ self.wo.to(cfg.dtype), c_kv, k_rope

    def forward_train(self, x, *, window=None, ops: AttentionOps):
        """Differentiable causal MLA over the whole sequence."""
        return self._materialised(
            x, lambda q, k, v: ops.train(q, k, v, causal=True))[0]

    def prefill(self, x, *, window=None, ops: AttentionOps):
        """Causal MLA over the prompt; also returns its latent cache."""
        out, c_kv, k_rope = self._materialised(
            x, lambda q, k, v: ops.prefill(q, k, v, causal=True))
        return out, {"c_kv": c_kv, "k_rope": k_rope}

    def decode(self, x, cache, *, cache_index: int, window=None,
               ops: AttentionOps | None = None):
        """Absorbed one-token decode against the latent cache, written IN
        PLACE at ``cache_index``; the same cache dict is returned."""
        cfg = self.cfg
        H, R = cfg.n_heads, cfg.kv_lora_rank
        nope, rope, vdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        positions = torch.full((1,), cache_index, dtype=torch.int64, device=x.device)
        q_nope, q_rope = self._queries(x, positions)  # (B,1,H,*)
        c_new, kr_new = self._latent(x, positions)
        write_slot(cache["c_kv"], cache_index, c_new[:, 0])
        write_slot(cache["k_rope"], cache_index, kr_new[:, 0])
        c_kv, k_rope = cache["c_kv"].float(), cache["k_rope"].float()

        wkv_b = split_heads(self.wkv_b.to(cfg.dtype).float(), H, nope + vdim)
        w_k, w_v = wkv_b[..., :nope], wkv_b[..., nope:]
        q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), w_k)
        s = torch.einsum("bhr,bsr->bhs", q_abs, c_kv)
        s = s + torch.einsum("bhp,bsp->bhs", q_rope[:, 0].float(), k_rope)
        s = s * ((nope + rope) ** -0.5)
        mask = torch.arange(c_kv.shape[1], device=x.device) <= cache_index
        w = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
        o_lat = torch.einsum("bhs,bsr->bhr", w, c_kv)
        out = torch.einsum("bhr,rhv->bhv", o_lat, w_v)
        out = merge_heads(out[:, None]).to(cfg.dtype)
        return out @ self.wo.to(cfg.dtype), cache

    def make_cache(self, batch: int, seq_len: int):
        return make_empty_mla_cache(self.cfg, batch, seq_len, self.wo.device)


def make_empty_mla_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    return {"c_kv": torch.zeros((batch, seq_len, cfg.kv_lora_rank), dtype=cfg.dtype,
                                device=device),
            "k_rope": torch.zeros((batch, seq_len, cfg.qk_rope_head_dim),
                                  dtype=cfg.dtype, device=device)}
