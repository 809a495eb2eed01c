from .flash_attention import (DKV_SM90_FP32_KERNEL,  # noqa: F401
                              DKV_SM90_KERNEL, DQ_SM90_FP32_KERNEL,
                              DQ_SM90_KERNEL, SM90_FP32_KERNEL, SM90_KERNEL,
                              backward_kernels, bwd_dkv_launch, bwd_dq_launch,
                              flash_attention_bwd, flash_attention_bwd_plain,
                              flash_attention_fwd, flash_attention_plain,
                              forward_kernel)
from .ops import flash_attention, flash_attention_plain_train  # noqa: F401
