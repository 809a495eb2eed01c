"""Which head dims each CUDA kernel takes: a pure function of the kernel,
the dtype and (D, Dv), so the rule is tested without a card.

The flash forward and the backward pair, in bf16 and in fp32 alike, take
D == Dv in {32, 64, 96, 128} and (D, Dv) = (96, 64), MLA's prefill and
training (64 nope + 32 rope dims of q and k, 64 of v): the head dims of
every family the reference runs on its Pallas kernels, in either dtype
(phi-3-vision's 96, minicpm3's (96, 64)).  In fp32 a row of 96 is three
128-byte swizzle atoms, and the 96-column outputs are summed in two parts
of 48.  Decode takes D == Dv in {32, 64, 96, 128} in both dtypes.  A
wrapper given anything else on CUDA ((96, 32), D = 16, ...) raises, naming
the shape; there is no fall-back to the plain version.  D = 16, which only
the reduced test configs use, runs on the CPU's plain versions.
"""

from __future__ import annotations

import torch

_WITH_96 = ((32, 32), (64, 64), (96, 96), (128, 128))
_MLA = _WITH_96 + ((96, 64),)

HEAD_DIMS = {
    ("flash_fwd", torch.bfloat16): _MLA,
    ("flash_fwd", torch.float32): _MLA,
    ("flash_bwd", torch.bfloat16): _MLA,
    ("flash_bwd", torch.float32): _MLA,
    ("decode", torch.bfloat16): _WITH_96,
    ("decode", torch.float32): _WITH_96,
}


def takes(kernel: str, dtype: torch.dtype, D: int, Dv: int) -> bool:
    """Whether ``kernel`` ("flash_fwd", "flash_bwd" or "decode") takes
    head dims (D, Dv) in ``dtype``."""
    return (D, Dv) in HEAD_DIMS.get((kernel, dtype), ())


def check(name: str, kernel: str, dtype: torch.dtype, D: int, Dv: int) -> None:
    """Raises ``ValueError`` naming the shape when ``takes`` says no."""
    if not takes(kernel, dtype, D, Dv):
        pairs = ", ".join(f"({d}, {dv})" for d, dv in HEAD_DIMS.get((kernel, dtype), ()))
        raise ValueError(f"{name}: head dims D={D}, Dv={Dv} in {str(dtype)[6:]}; the "
                         f"kernel takes (D, Dv) in {pairs}")
