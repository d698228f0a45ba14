"""The matmul precision contract shared by the plain versions and the kernels.

Mirrors the JAX package's ``_kernel_precision`` / ``_kdot``:

  'highest'  true fp32 products and sums (TF32 must stay off)
  'high'     a.b ~ hi(a).hi(b) + hi(a).lo(b) + lo(a).hi(b) with hi/lo the
             bf16 split (x = hi + lo); each bf16 product is exact in fp32,
             sums in fp32 (about 2^-16 of each term is lost)
  'default'  one bf16-rounded product per term, fp32 sums

The CUDA kernels implement the same three modes per multiply-add
(``ops/cuda/common.cuh``), so a kernel and its plain version differ only in
summation order.
"""

from __future__ import annotations

import torch

PRECISIONS = ("default", "high", "highest")
PRECISION_CODE = {"highest": 0, "high": 1, "default": 2}


def kernel_precision(precision) -> str:
    """Canonicalize None / a string to one of PRECISIONS."""
    if precision is None:
        return "highest"
    p = str(precision).lower()
    if p not in PRECISIONS:
        raise ValueError(f"unknown matmul precision {precision!r}")
    return p


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def pdot(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b under the precision contract (fp32 in, fp32 out)."""
    precision = kernel_precision(precision)
    if precision == "highest":
        return a @ b
    a_hi, b_hi = bf16_round(a), bf16_round(b)
    if precision == "default":
        return a_hi @ b_hi
    a_lo, b_lo = bf16_round(a - a_hi), bf16_round(b - b_hi)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
