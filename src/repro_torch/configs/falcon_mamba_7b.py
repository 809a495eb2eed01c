"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — pure mamba-1 blocks (no MLP sublayer).
[arXiv:2410.05355; unverified]"""

from repro_torch.models.common import BlockSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # attention-free
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=65024,
    attention="none",
    pattern=(BlockSpec(mixer="mamba", mlp="none"),),
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
)
