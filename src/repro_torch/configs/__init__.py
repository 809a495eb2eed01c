"""Ported architecture configs (``--arch <id>``).

Each module defines ``CONFIG``, the full-scale config, identical to the
reference package's.  ``reduced(cfg)`` derives the same small config the
reference's CPU tests use.  Every config of the reference is ported:
the MoE decoders (llama4-maverick, arctic), the dense GQA and MHA
decoders, MLA (minicpm3), the vision LM (phi-3-vision), the whisper
encoder-decoder, the Mamba-1 SSM (falcon-mamba) and the hybrid of Mamba,
attention and MoE (jamba).
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ModelConfig, SSMConfig

ARCH_IDS = [
    "llama4_maverick_400b_a17b",
    "arctic_480b",
    "qwen3_1p7b",
    "llama3p2_1b",
    "minicpm3_4b",
    "minicpm_2b",
    "falcon_mamba_7b",
    "whisper_tiny",
    "phi3_vision_4p2b",
    "jamba_1p5_large_398b",
]

_ALIASES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "arctic-480b": "arctic_480b",
    "qwen3-1.7b": "qwen3_1p7b",
    "llama3.2-1b": "llama3p2_1b",
    "minicpm3-4b": "minicpm3_4b",
    "minicpm-2b": "minicpm_2b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "whisper-tiny": "whisper_tiny",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def get(name: str) -> ModelConfig:
    name = canonical(name)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown or unported arch {name!r} "
                         f"(ported: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get(a) for a in ARCH_IDS}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family config for CPU tests: same pattern/features,
    tiny widths, fp32 numerics, 2 pattern repeats."""
    kw: dict = dict(
        n_layers=2 * len(cfg.pattern),
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=cfg.d_ff and 128,
        vocab_size=512,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
        opt_state_dtype="float32",
        max_seq_len=128,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2),
            dense_residual_ff=128 if cfg.moe.dense_residual else 0)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(state_dim=4, conv_width=4, expand=2, dt_rank=8)
    if cfg.attention == "mla":
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_rope_head_dim=8,
                  qk_nope_head_dim=16, v_head_dim=16)
    if cfg.is_encoder_decoder:
        kw.update(n_encoder_layers=2, encoder_seq_len=16)
    if cfg.frontend == "vision":
        kw.update(n_patch_tokens=8)
    if cfg.long_context_window:
        kw.update(long_context_window=32)
    return cfg.replace(**kw)
