"""Model configuration for every family of the reference: dense GQA and
MHA decoders, MLA (minicpm3), the vision LM (phi-3-vision's backbone
with its patch-embedding stub), the whisper encoder-decoder, Mamba-1
SSMs, token-dropping MoE with an optional dense residual
(llama4-maverick, arctic) and the hybrid interleave of Mamba, attention
and MoE (jamba, with its ``long_context_window``).

A model is a *block pattern* (a short tuple of ``BlockSpec``) repeated
``n_repeats`` times, as in the reference package; the port runs the
layers as a loop over an ``nn.ModuleList``.  Ported blocks: attention
(GQA or MLA) or mamba, then a dense MLP (SwiGLU or GELU), an MoE or
none.  ``param_counts`` counts parameters as the reference does.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class MoEConfig:
    """Token-dropping (capacity-factor) mixture-of-experts."""

    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # Routing-group size (tokens per capacity group); the dispatch and
    # combine one-hots are O(tokens x E x capacity).  0 = one group per
    # sequence.
    group_size: int = 256
    # Arctic-style: a dense FFN residual branch computed for every token in
    # parallel with the routed experts (also llama4-maverick's shared expert).
    dense_residual: bool = False
    dense_residual_ff: int = 0  # 0 -> the config's d_ff
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective state space block."""

    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank > 0 else -(-d_model // 16)


@dataclass(frozen=True)
class BlockSpec:
    """One layer's shape: a mixer plus an MLP."""

    mixer: str = "attn"  # "attn" | "mamba"
    mlp: str = "dense"  # "dense" | "moe" | "none"
    # sliding window for this block's attention (None = full/causal).
    window: int | None = None


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    pattern: tuple[BlockSpec, ...] = ()

    attention: str = "gqa"  # "gqa" | "mla" | "none"
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # MLA (DeepSeek/MiniCPM3 style multi-head latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None

    # encoder-decoder (whisper backbone)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500  # whisper stub frontend frames

    # modality frontend stubs
    frontend: str | None = None  # None | "audio" | "vision"
    n_patch_tokens: int = 256  # vision stub: patch embeds before the text

    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    mlp_act: str = "swiglu"  # "swiglu" | "gelu"
    tie_embeddings: bool = False

    # numerics: names of torch dtypes; training policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = False  # as the reference: LM training checkpoints each pattern repeat
    opt_state_dtype: str = "float32"  # AdamW moments: float32 | bfloat16 | int8
    # sliding window applied to *attention* blocks only at long context
    long_context_window: int | None = None

    max_seq_len: int = 4096

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.pattern:
            mlp = "moe" if self.moe is not None else "dense"
            mixer = "mamba" if self.family == "ssm" else "attn"
            object.__setattr__(self, "pattern", (BlockSpec(mixer=mixer, mlp=mlp),))
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.pattern)}")

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:
        if self.ssm is None:
            raise ValueError(f"{self.name}: d_inner needs an SSM config")
        return self.ssm.expand * self.d_model

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def uses_attention(self) -> bool:
        return any(b.mixer == "attn" for b in self.pattern)

    @property
    def uses_mamba(self) -> bool:
        return any(b.mixer == "mamba" for b in self.pattern)

    @property
    def subquadratic(self) -> bool:
        """True if the arch can run 500k-token decode (SSM/hybrid-window)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---------------- parameter counting (for 6ND roofline) ------------ #
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        if self.attention == "mla":
            qr = self.q_lora_rank or self.d_model
            p = 0
            if self.q_lora_rank:
                p += d * self.q_lora_rank
            p += qr * self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
            p += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            p += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
            p += self.n_heads * self.v_head_dim * d
            return p
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        return q + kv + o

    def _dense_mlp_params(self, d_ff: int | None = None) -> int:
        ff = d_ff or self.d_ff
        mult = 3 if self.mlp_act == "swiglu" else 2
        return mult * self.d_model * ff

    def _moe_params(self) -> tuple[int, int]:
        """(total, active) params of one MoE layer."""
        if self.moe is None:
            raise ValueError(f"{self.name}: MoE params need an MoE config")
        e = self._dense_mlp_params()
        total = self.moe.n_experts * e + self.d_model * self.moe.n_experts
        active = self.moe.top_k * e
        if self.moe.dense_residual:
            r = self._dense_mlp_params(self.moe.dense_residual_ff or self.d_ff)
            total += r
            active += r
        return total, active

    def _mamba_params(self) -> int:
        if self.ssm is None:
            raise ValueError(f"{self.name}: Mamba params need an SSM config")
        di, d = self.d_inner, self.d_model
        s = self.ssm
        dtr = s.resolved_dt_rank(d)
        return (
            d * 2 * di  # in_proj (x and gate)
            + di * s.conv_width
            + di * (dtr + 2 * s.state_dim)  # x_proj
            + dtr * di  # dt_proj
            + di * s.state_dim  # A_log
            + di  # D
            + di * d  # out_proj
        )

    def param_counts(self) -> tuple[int, int]:
        """(total, active) parameters, the reference's count: the blocks
        (an MoE's active share is its top_k experts and dense residual),
        whisper's encoder and cross-attention, and the embeddings (one
        table when tied), in both."""
        total = active = 0
        for b in self.pattern:
            if b.mixer == "attn":
                p = self._attn_params()
                total += p
                active += p
            elif b.mixer == "mamba":
                p = self._mamba_params()
                total += p
                active += p
            if b.mlp == "dense":
                p = self._dense_mlp_params()
                total += p
                active += p
            elif b.mlp == "moe":
                t, a = self._moe_params()
                total += t
                active += a
        total *= self.n_repeats
        active *= self.n_repeats
        emb = self.vocab_size * self.d_model
        emb_total = emb if self.tie_embeddings else 2 * emb
        if self.is_encoder_decoder:
            enc_per_layer = self._attn_params() + self._dense_mlp_params()
            # decoder cross-attention
            dec_cross = self._attn_params() * self.n_layers
            total += enc_per_layer * self.n_encoder_layers + dec_cross
            active += enc_per_layer * self.n_encoder_layers + dec_cross
        total += emb_total
        active += emb_total
        return total, active


def sinusoidal_positions(n: int, d: int, device=None,
                         offset: int = 0) -> torch.Tensor:
    """Whisper-style sinusoidal position embeddings of positions
    ``offset .. offset + n - 1``: (n, d) fp32, sin then cos halves."""
    half = d // 2
    log_timescale = math.log(10000.0) / max(half - 1, 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32,
                                                  device=device))
    pos = torch.arange(offset, offset + n, dtype=torch.float32, device=device)
    scaled = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)
