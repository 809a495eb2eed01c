"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064 — phi3-mini backbone; the CLIP frontend is a STUB:
``input_specs()`` provides precomputed patch embeddings concatenated before
the text tokens. [hf:microsoft/Phi-3-vision-128k-instruct; hf]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    frontend="vision",
    n_patch_tokens=256,
    rope_theta=10000.0,
)
