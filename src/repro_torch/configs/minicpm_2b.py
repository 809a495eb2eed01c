"""minicpm-2b [dense] — 40L d_model=2304 36H (kv=36, MHA) d_ff=5760
vocab=122753 — llama-like arch trained with the WSD schedule (implemented in
repro_torch.optim.schedules.wsd). [arXiv:2404.06395; hf]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    rope_theta=10000.0,
    tie_embeddings=True,
)
