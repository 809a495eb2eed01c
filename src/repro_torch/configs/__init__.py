"""Ported architecture configs (``--arch <id>``).

Each module defines ``CONFIG``, the full-scale config, identical to the
reference package's.  ``reduced(cfg)`` derives the same small config the
reference's CPU tests use.  Only the dense GQA decoders are ported.
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCH_IDS = [
    "qwen3_1p7b",
    "llama3p2_1b",
]

_ALIASES = {
    "qwen3-1.7b": "qwen3_1p7b",
    "llama3.2-1b": "llama3p2_1b",
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
    )
    return cfg.replace(**kw)
