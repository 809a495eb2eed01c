from .mamba_scan import (KERNEL, mamba_scan_fwd, mamba_scan_naive,  # noqa: F401
                         mamba_scan_plain)
from .ops import mamba_scan, mamba_scan_plain_train  # noqa: F401
