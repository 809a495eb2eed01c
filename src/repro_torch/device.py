"""Device selection for every entry point of the port.

The default is the first CUDA card.  The CPU is used only when the
caller names it (``device="cpu"``, ``--device cpu``); asking for CUDA on
a machine without a card raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` or ``"cuda"`` -> ``cuda:0``; ``"cpu"`` -> the CPU.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly
    or by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
