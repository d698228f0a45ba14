"""Fused ReLU hidden stack of the HPD index network (kernels K3a and K3b).

Replaces ``ops/pallas/hidden.py: hidden_stack_pallas`` of the JAX package.
``hidden_stack_fwd`` / ``hidden_stack_bwd`` launch the kernels of
``hidden.cu`` for a CUDA tensor and run the plain PyTorch version beside
them for a CPU tensor; :class:`HiddenStack` is the autograd Function over
the pair. The backward recomputes the forward, masks with ``pre >= 0`` (the
kernel's rule, not ``torch.relu``'s), returns dW and db of every layer and
zero coordinate gradients (the vertex coords are data).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ..precision import PRECISION_CODE, kernel_precision, pdot
from . import build

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]
MAX_LAYERS = 4
MAX_WIDTH = 128
MAX_INPUT = 8


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


# ------------------------------ plain versions ------------------------------ #

def hidden_stack_fwd_plain(x: torch.Tensor, layers: Layers, precision: str) -> torch.Tensor:
    h = x
    for w, b in layers:
        h = torch.clamp(pdot(h, w, precision) + b, min=0.0)
    return h


def hidden_stack_bwd_plain(
    x: torch.Tensor, layers: Layers, gh: torch.Tensor, precision: str
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    acts, pres = [x], []
    for w, b in layers:
        z = pdot(acts[-1], w, precision) + b
        pres.append(z)
        acts.append(torch.clamp(z, min=0.0))
    g = gh
    grads = [None] * len(layers)
    for i in reversed(range(len(layers))):
        g = torch.where(pres[i] >= 0.0, g, torch.zeros_like(g))
        grads[i] = (pdot(acts[i].T, g, precision), g.sum(dim=0))
        if i > 0:
            g = pdot(g, layers[i][0].T, precision)
    return grads


# --------------------------------- kernels ---------------------------------- #

_ARGS_FWD = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_ARGS_BWD = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = build.library("hidden")
    lib.hidden_stack_fwd.argtypes = _ARGS_FWD
    lib.hidden_stack_fwd.restype = ctypes.c_int
    lib.hidden_stack_bwd.argtypes = _ARGS_BWD
    lib.hidden_stack_bwd.restype = ctypes.c_int
    lib.hidden_stack_bwd_blocks.argtypes = [ctypes.c_int]
    lib.hidden_stack_bwd_blocks.restype = ctypes.c_int
    return lib


def _widths(x: torch.Tensor, layers: Layers) -> List[int]:
    widths = [x.shape[1]] + [w.shape[1] for w, _ in layers]
    if not 1 <= len(layers) <= MAX_LAYERS or widths[0] > MAX_INPUT or max(widths[1:]) > MAX_WIDTH:
        raise ValueError(
            f"hidden stack {widths} not supported by the kernel "
            f"(<= {MAX_LAYERS} layers, input <= {MAX_INPUT}, widths <= {MAX_WIDTH})"
        )
    for (w, b), din, dout in zip(layers, widths[:-1], widths[1:]):
        if tuple(w.shape) != (din, dout) or tuple(b.shape) != (dout,):
            raise ValueError(f"layer shapes {tuple(w.shape)}, {tuple(b.shape)} break the chain {widths}")
    return widths + [0] * (MAX_LAYERS + 1 - len(widths))


def _checked(t: torch.Tensor, device: torch.device, name: str) -> torch.Tensor:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got {t.dtype} on {t.device}")
    return t.contiguous()


def _pack(layers: Layers, device: torch.device) -> torch.Tensor:
    return torch.cat([
        torch.cat([_checked(w, device, "w").reshape(-1), _checked(b, device, "b")])
        for w, b in layers
    ])


def _launch_fwd(x: torch.Tensor, layers: Layers, precision: str) -> torch.Tensor:
    dev = x.device
    x = _checked(x, dev, "x")
    widths = _widths(x, layers)
    params = _pack(layers, dev)
    u = x.shape[0]
    h = torch.empty(u, layers[-1][0].shape[1], device=dev, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.hidden_stack_fwd(
            x.data_ptr(), params.data_ptr(), h.data_ptr(), u, len(layers), *widths,
            PRECISION_CODE[precision], torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(code, lib, "hidden_error_string", "hidden_stack_fwd")
    hidden_stack_fwd.launches += 1
    return h


def _launch_bwd(x: torch.Tensor, layers: Layers, gh: torch.Tensor, precision: str):
    dev = x.device
    x = _checked(x, dev, "x")
    gh = _checked(gh, dev, "gh")
    widths = _widths(x, layers)
    params = _pack(layers, dev)
    u = x.shape[0]
    lib = _lib()
    nb = max(1, lib.hidden_stack_bwd_blocks(u))
    partials = torch.empty(nb, params.numel(), device=dev, dtype=torch.float32)
    dparams = torch.empty_like(params)
    with torch.cuda.device(dev):
        code = lib.hidden_stack_bwd(
            x.data_ptr(), gh.data_ptr(), params.data_ptr(), partials.data_ptr(),
            dparams.data_ptr(), u, len(layers), *widths, PRECISION_CODE[precision],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(code, lib, "hidden_error_string", "hidden_stack_bwd")
    hidden_stack_bwd.launches += 1
    grads, off = [], 0
    for w, b in layers:
        dw = dparams[off: off + w.numel()].view(w.shape)
        off += w.numel()
        db = dparams[off: off + b.numel()]
        off += b.numel()
        grads.append((dw, db))
    return grads


def hidden_stack_fwd(x: torch.Tensor, layers: Layers, precision: str = "highest") -> torch.Tensor:
    """x (U, d) -> h (U, w_n), ReLU after every layer (K3a)."""
    precision = kernel_precision(precision)
    if _on_card(x):
        return _launch_fwd(x, layers, precision)
    return hidden_stack_fwd_plain(x, layers, precision)


def hidden_stack_bwd(
    x: torch.Tensor, layers: Layers, gh: torch.Tensor, precision: str = "highest"
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """[(dW_i, db_i)] of sum(h * gh) (K3b)."""
    precision = kernel_precision(precision)
    if _on_card(x):
        return _launch_bwd(x, layers, gh, precision)
    return hidden_stack_bwd_plain(x, layers, gh, precision)


hidden_stack_fwd.launches = 0
hidden_stack_bwd.launches = 0


class HiddenStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, precision, *params):
        layers = list(zip(params[0::2], params[1::2]))
        ctx.precision = precision
        ctx.save_for_backward(x, *params)
        return hidden_stack_fwd(x, layers, precision)

    @staticmethod
    def backward(ctx, gh):
        x, *params = ctx.saved_tensors
        layers = list(zip(params[0::2], params[1::2]))
        grads = hidden_stack_bwd(x, layers, gh.contiguous(), ctx.precision)
        flat = [g for pair in grads for g in pair]
        return (torch.zeros_like(x), None, *flat)


def hidden_stack(x: torch.Tensor, layers: Layers, precision: str = "highest") -> torch.Tensor:
    return HiddenStack.apply(x, precision, *[t for pair in layers for t in pair])
