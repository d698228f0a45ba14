"""The roofline probes of the measurement path (kernels K13, K14, K15).

Replaces the three Pallas kernels of ``tools/mxu_probe.py`` in the JAX
package (closures inside its ``main``):

  K13 ``rowsum_dot(h, w, regime)``: (U, 1) = sum_t (h w)[:, t], the (U, T)
      product never written; regimes 'highest' (fp32 on the CUDA cores),
      'default' and 'bf16' (one function: bf16 operands, products exact in
      fp32, one tensor-core kernel) and 'bf16x3' (the hi/lo split of
      'high' on the tensor cores); all accumulate in fp32.
  K14 ``hbm_write(shape)``: a new fp32 tensor of ones.
  K15 ``hbm_scale_copy(x)``: 2 x into a new tensor.

For a CUDA tensor (K14: a CUDA device) the wrappers launch the kernels of
``probe.cu``; on the CPU they run the plain versions below. K13's plain
version takes the product in row chunks and sums each row: never
``h @ w.sum(1)``, the rewrite that made the TPU tool's first numbers
fiction.
"""

from __future__ import annotations

import ctypes

import torch

from ..precision import pdot
from . import build

REGIMES = ("highest", "default", "bf16", "bf16x3")
# the precision contract (ops/precision.py) each regime computes
REGIME_PRECISION = {"highest": "highest", "default": "default", "bf16": "default",
                    "bf16x3": "high"}
# rows per plain-version chunk: (chunk, T) fp32 temporaries of <= 64 MB
PLAIN_CHUNK_ELEMS = 1 << 24


def _regime(regime: str) -> str:
    if regime not in REGIMES:
        raise ValueError(f"unknown rowsum regime {regime!r}; expected one of {REGIMES}")
    return regime


# ------------------------------ plain versions ------------------------------ #

def rowsum_dot_plain(h: torch.Tensor, w: torch.Tensor, regime: str = "highest") -> torch.Tensor:
    """(U, 1): the product under the regime's precision, row chunk by row
    chunk, each row summed."""
    precision = REGIME_PRECISION[_regime(regime)]
    step = max(1, PLAIN_CHUNK_ELEMS // max(w.shape[1], 1))
    out = torch.empty(h.shape[0], 1, dtype=torch.float32, device=h.device)
    for r0 in range(0, h.shape[0], step):
        out[r0:r0 + step] = pdot(h[r0:r0 + step], w, precision).sum(dim=1, keepdim=True)
    return out


def hbm_write_plain(shape, device="cpu") -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=torch.float32, device=device)


def hbm_scale_copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


# --------------------------------- kernels ---------------------------------- #

def _lib() -> ctypes.CDLL:
    lib = build.library("probe")
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rowsum_dot.argtypes = [vp, vp, ci, ci, ci, ci, vp, vp, vp]
    lib.rowsum_scratch_elems.argtypes = [ci, ci]
    lib.rowsum_scratch_elems.restype = cll
    lib.hbm_write.argtypes = [vp, cll, vp]
    lib.hbm_scale_copy.argtypes = [vp, vp, cll, vp]
    for fn in (lib.rowsum_dot, lib.hbm_write, lib.hbm_scale_copy):
        fn.restype = ci
    return lib


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as K13's 16-byte loads need (K14/K15
    take any address: they fall back to scalar accesses)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch_rowsum(h, w, regime):
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(f"rowsum_dot takes h (U, H) and w (H, T); got {tuple(h.shape)}, {tuple(w.shape)}")
    for name, x in (("h", h), ("w", w)):
        if x.device != h.device or x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {h.device}, got {x.dtype} on {x.device}")
    dev = h.device
    h, w = _aligned(h), _aligned(w)
    u, hd = h.shape
    out = torch.empty(u, 1, device=dev, dtype=torch.float32)
    lib = _lib()
    # the tensor-core regimes' w^T in bf16, made by the call itself
    scratch = torch.empty(lib.rowsum_scratch_elems(w.shape[1], REGIMES.index(regime)),
                          device=dev, dtype=torch.bfloat16)
    with torch.cuda.device(dev):
        code = lib.rowsum_dot(h.data_ptr(), w.data_ptr(), u, hd, w.shape[1],
                              REGIMES.index(regime), out.data_ptr(),
                              scratch.data_ptr(), _stream(dev))
    build.check(code, lib, "probe_error_string", f"rowsum_dot[{regime}]")
    rowsum_dot.launches += 1
    rowsum_dot.regime_launches[regime] += 1
    return out


def rowsum_dot(h: torch.Tensor, w: torch.Tensor, regime: str = "highest") -> torch.Tensor:
    """(U, 1) = sum_t (h w)[:, t] under ``regime`` (K13). The kernel takes H
    a multiple of 16 up to 128 and T a multiple of 128 (else RuntimeError).
    Launches are counted in ``launches`` and, by regime, in
    ``regime_launches``."""
    regime = _regime(regime)
    if h.is_cuda:
        return _launch_rowsum(h, w, regime)
    return rowsum_dot_plain(h, w, regime)


def hbm_write(shape, device="cuda") -> torch.Tensor:
    """A new fp32 tensor of ones of ``shape`` on ``device`` (K14)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return hbm_write_plain(shape, dev)
    return _write_ones(torch.empty(tuple(shape), dtype=torch.float32, device=dev))


def _write_ones(out: torch.Tensor) -> torch.Tensor:
    """K14's launch: ones into ``out``, contiguous fp32 on a card at any
    address (16-byte stores where it is aligned, else scalar ones)."""
    lib = _lib()
    with torch.cuda.device(out.device):
        code = lib.hbm_write(out.data_ptr(), out.numel(), _stream(out.device))
    build.check(code, lib, "probe_error_string", "hbm_write")
    hbm_write.launches += 1
    return out


def hbm_scale_copy(x: torch.Tensor) -> torch.Tensor:
    """2 x in a new fp32 tensor (K15)."""
    if x.dtype != torch.float32:
        raise ValueError(f"hbm_scale_copy takes float32; got {x.dtype}")
    if not x.is_cuda:
        return hbm_scale_copy_plain(x)
    x = x.contiguous()
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.hbm_scale_copy(x.data_ptr(), y.data_ptr(), x.numel(), _stream(x.device))
    build.check(code, lib, "probe_error_string", "hbm_scale_copy")
    hbm_scale_copy.launches += 1
    return y


rowsum_dot.launches = 0
rowsum_dot.regime_launches = dict.fromkeys(REGIMES, 0)
hbm_write.launches = 0
hbm_scale_copy.launches = 0
