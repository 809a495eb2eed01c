"""minicpm3-4b [dense] — 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
(multi-head latent attention, DeepSeek-V2 style).
[hf:openbmb/MiniCPM3-4B; hf]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_rope_head_dim=32,
    qk_nope_head_dim=64,
    v_head_dim=64,
    rope_theta=10000.0,
)
