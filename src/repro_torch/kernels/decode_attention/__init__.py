from .decode_attention import (KERNEL, decode_attention_fwd,  # noqa: F401
                               decode_attention_plain)
