"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU.

    Raises instead of falling back: a run that asked for the card and got
    the CPU would report CPU numbers as if they were the card's."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    return dev
