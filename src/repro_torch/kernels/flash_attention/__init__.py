from .flash_attention import (KERNEL, flash_attention_fwd,  # noqa: F401
                              flash_attention_plain)
