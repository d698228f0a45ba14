"""Fused ReLU hidden stack of the HPD index network (kernels K3a and K3b).

Replaces ``ops/pallas/hidden.py: hidden_stack_pallas`` of the JAX package,
with its width contract (:func:`supports`, the JAX gate copied): every width
<= 512, every hidden width a multiple of 8, at least one layer, any depth.
``hidden_stack_fwd`` / ``hidden_stack_bwd`` launch the kernels of
``hidden.cu`` for a CUDA tensor and run the plain PyTorch version beside
them for a CPU tensor; both refuse a stack outside the contract first.
:class:`HiddenStack` is the autograd Function over the pair. The backward
recomputes the forward, masks with ``pre >= 0`` (the kernel's rule, not
``torch.relu``'s), returns dW and db of every layer and zero coordinate
gradients (the vertex coords are data).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from ..precision import PRECISION_CODE, kernel_precision, pdot
from . import build

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]
MAX_WIDTH = 512


def supports(widths: Sequence[int]) -> bool:
    """The JAX kernel's gate (``ops/pallas/hidden.py: supports``) on
    widths = (d, h1, ..., hn) of the hidden stack, head excluded: K3 runs
    where it holds, the plain stack elsewhere, as the JAX package runs its
    XLA stack."""
    return (
        len(widths) >= 2
        and all(w <= MAX_WIDTH for w in widths)
        and all(w % 8 == 0 for w in widths[1:])
    )


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

def _lib() -> ctypes.CDLL:
    return _configure(build.library("hidden"))


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a built hidden library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hidden_stack_fwd.argtypes = [vp] * 3 + [ci] * 2 + [vp] * 2 + [ci, vp]
    lib.hidden_stack_fwd.restype = ci
    lib.hidden_stack_bwd.argtypes = [vp] * 6 + [ci] * 2 + [vp] * 2 + [ci, vp]
    lib.hidden_stack_bwd.restype = ci
    lib.hidden_stack_bwd_plan.argtypes = [ci, ci, vp, vp]
    lib.hidden_stack_bwd_plan.restype = ci
    return lib


def _widths(x: torch.Tensor, layers: Layers) -> List[int]:
    """(d, h1, ..., hn); raises ValueError outside the kernels' contract."""
    widths = [x.shape[1]] + [w.shape[1] for w, _ in layers]
    if not layers or not supports(widths) or min(widths[1:]) < 8:
        raise ValueError(
            f"hidden stack {widths} not supported by the kernel (>= 1 layer, widths "
            f"<= {MAX_WIDTH}, hidden widths multiples of 8)"
        )
    for (w, b), din, dout in zip(layers, widths[:-1], widths[1:]):
        if tuple(w.shape) != (din, dout) or tuple(b.shape) != (dout,):
            raise ValueError(f"layer shapes {tuple(w.shape)}, {tuple(b.shape)} break the chain {widths}")
    return widths


@functools.lru_cache(maxsize=None)
def _device_widths(widths: Tuple[int, ...], device: str) -> torch.Tensor:
    """The widths as an int32 tensor on the device, made once per stack."""
    return torch.tensor(widths, dtype=torch.int32, device=device)


def _host_widths(widths: Sequence[int]):
    return (ctypes.c_int * len(widths))(*widths)


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
    widths = _widths(x, layers)
    x = _checked(x, dev, "x")
    params = _pack(layers, dev)
    u = x.shape[0]
    h = torch.empty(u, widths[-1], device=dev, dtype=torch.float32)
    lib = _lib()
    w_dev = _device_widths(tuple(widths), str(dev))
    with torch.cuda.device(dev):
        code = lib.hidden_stack_fwd(
            x.data_ptr(), params.data_ptr(), h.data_ptr(), u, len(layers), _host_widths(widths),
            w_dev.data_ptr(), PRECISION_CODE[precision], torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(code, lib, "hidden_error_string", "hidden_stack_fwd")
    hidden_stack_fwd.launches += 1
    return h


def _launch_bwd(x: torch.Tensor, layers: Layers, gh: torch.Tensor, precision: str):
    dev = x.device
    widths = _widths(x, layers)
    x = _checked(x, dev, "x")
    gh = _checked(gh, dev, "gh")
    params = _pack(layers, dev)
    u = x.shape[0]
    lib = _lib()
    plan = (ctypes.c_longlong * 2)()
    build.check(lib.hidden_stack_bwd_plan(u, len(layers), _host_widths(widths), plan), lib,
                "hidden_error_string", "hidden_stack_bwd_plan")
    partials = torch.empty(plan[0], params.numel(), device=dev, dtype=torch.float32)
    scratch = torch.empty(plan[1], device=dev, dtype=torch.float32)
    dparams = torch.empty_like(params)
    w_dev = _device_widths(tuple(widths), str(dev))
    with torch.cuda.device(dev):
        code = lib.hidden_stack_bwd(
            x.data_ptr(), gh.data_ptr(), params.data_ptr(), partials.data_ptr(),
            scratch.data_ptr(), dparams.data_ptr(), u,
            len(layers), _host_widths(widths), w_dev.data_ptr(), PRECISION_CODE[precision],
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
    _widths(x, layers)
    if _on_card(x):
        return _launch_fwd(x, layers, precision)
    return hidden_stack_fwd_plain(x, layers, precision)


def hidden_stack_bwd(
    x: torch.Tensor, layers: Layers, gh: torch.Tensor, precision: str = "highest"
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """[(dW_i, db_i)] of sum(h * gh) (K3b)."""
    precision = kernel_precision(precision)
    _widths(x, layers)
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
