"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave
(1 attention layer per 8), MoE every other layer. Attention layers use a
sliding window at the long_500k shape (mamba carries the long context).
[arXiv:2403.19887; hf]"""

from repro_torch.models.common import BlockSpec, ModelConfig, MoEConfig, SSMConfig

# period-8 pattern: position 0 is attention, 1-7 mamba; MoE on odd positions
_PATTERN = tuple(
    BlockSpec(mixer="attn" if i == 0 else "mamba",
              mlp="moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=_PATTERN,
    moe=MoEConfig(n_experts=16, top_k=2, capacity_factor=1.25),
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    long_context_window=2048,
    remat=True,
    opt_state_dtype="bfloat16",
)
