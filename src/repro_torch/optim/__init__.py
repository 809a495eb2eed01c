from .adamw import (adamw_update, clip_by_global_norm, dequantize_blockwise,  # noqa: F401
                    global_norm, init_opt_state, opt_state_partition_specs,
                    quantize_blockwise)
from .schedules import SCHEDULES, constant, warmup_cosine, wsd  # noqa: F401
