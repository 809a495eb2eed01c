"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128e top-2 + dense residual (Arctic's dense-MoE hybrid).
[hf:Snowflake/snowflake-arctic-base; hf]"""

from repro_torch.models.common import BlockSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    pattern=(BlockSpec(mixer="attn", mlp="moe"),),
    moe=MoEConfig(n_experts=128, top_k=2, capacity_factor=1.25,
                  dense_residual=True),
    rope_theta=10000.0,
    remat=True,
    opt_state_dtype="int8",  # 480B: blockwise-int8 Adam moments
)
