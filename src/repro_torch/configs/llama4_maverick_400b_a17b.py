"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1, shared expert (modeled as the dense
residual branch), dense/MoE interleave of 2.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from repro_torch.models.common import BlockSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=(BlockSpec(mixer="attn", mlp="dense"),
             BlockSpec(mixer="attn", mlp="moe")),
    moe=MoEConfig(n_experts=128, top_k=1, capacity_factor=1.25,
                  dense_residual=True),
    rope_theta=500000.0,
    remat=True,
    opt_state_dtype="bfloat16",  # 400B: fp32 moments do not fit one pod
)
