"""Device-memory watermarks.

The port of the JAX package's ``utils/memory.py``: the reference's
``print_allocated_memory`` (``torch.cuda.memory_allocated`` plus the
calling line), opt-in and tagged, reading PyTorch's CUDA allocator."""

from __future__ import annotations

import traceback
from typing import Dict, Optional

import torch

_GB = 1024**3


def device_memory_stats(device=None) -> Dict[str, float]:
    """allocated / peak allocated / total memory of the card in GB (all 0.0
    on the CPU)."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type != "cuda":
        return dict(allocated_gb=0.0, peak_gb=0.0, limit_gb=0.0)
    _, total = torch.cuda.mem_get_info(dev)
    return dict(allocated_gb=torch.cuda.memory_allocated(dev) / _GB,
                peak_gb=torch.cuda.max_memory_allocated(dev) / _GB,
                limit_gb=total / _GB)


def print_allocated_memory(tag: Optional[str] = None, log: bool = False,
                           device=None) -> Optional[Dict[str, float]]:
    """Gated watermark print (no-op unless ``log``); ``tag`` defaults to the
    caller's file:line."""
    if not log:
        return None
    if tag is None:
        frame = traceback.extract_stack()[-2]
        tag = f"{frame.filename}:{frame.lineno}"
    stats = device_memory_stats(device)
    print(f"[mem] {tag}: allocated {stats['allocated_gb']:.2f} GB, peak {stats['peak_gb']:.2f} GB")
    return stats
