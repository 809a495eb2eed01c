"""whisper-tiny [audio] — 4L (enc) + 4L (dec) d_model=384 6H d_ff=1536
vocab=51865 — encoder-decoder; the conv/mel frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings.
[arXiv:2212.04356; unverified]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    is_encoder_decoder=True,
    n_encoder_layers=4,
    encoder_seq_len=1500,
    frontend="audio",
    norm_type="layernorm",
    mlp_act="gelu",
    tie_embeddings=True,
)
