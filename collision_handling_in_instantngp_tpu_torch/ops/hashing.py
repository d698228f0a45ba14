"""Spatial fast hash of the vanilla InstantNGP path: the XOR of each
corner coordinate times a large prime, modulo the table size T.

The JAX package computes it in uint32. PyTorch's uint32 has no multiply on
most backends, so this computes in int64: for a power-of-two T only the low
log2(T) bits of the result are read, and the low 32 bits of every product
and XOR are those of the uint32 arithmetic. Each product is taken modulo
2^32 from 16-bit halves of the corner, so no int64 product overflows and
the ids equal the JAX package's bit for bit for any uint32 corner.
"""

from __future__ import annotations

import torch

PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def _as_uint32(corners: torch.Tensor) -> torch.Tensor:
    """int64 values of ``corners.astype(uint32)`` as XLA casts: a float
    truncates toward zero and saturates to [0, 2^32 - 1], an integer wraps
    modulo 2^32."""
    if corners.is_floating_point():
        return torch.clamp(corners.double(), 0.0, float(_U32)).long()
    return corners.long() & _U32


def _mul_u32(c: torch.Tensor, prime: int) -> torch.Tensor:
    """(c * prime) mod 2^32 for int64 c in [0, 2^32): the high half enters
    shifted by 16 after its own product is cut to 16 bits."""
    lo, hi = c & 0xFFFF, c >> 16
    return (lo * prime + (((hi * prime) & 0xFFFF) << 16)) & _U32


def fast_hash(corners: torch.Tensor, hash_table_size: int) -> torch.Tensor:
    """(..., d) corner coordinates -> (...,) int32 slot ids in [0, T).
    Raises ValueError where T is not a power of two."""
    if hash_table_size <= 0 or hash_table_size & (hash_table_size - 1) != 0:
        raise ValueError(
            f"hash_table_size must be a power of two, got {hash_table_size}"
        )
    c = _as_uint32(corners)
    acc = torch.zeros(corners.shape[:-1], dtype=torch.int64, device=corners.device)
    for i in range(corners.shape[-1]):
        acc = acc ^ _mul_u32(c[..., i], PRIMES[i])
    return (acc & (hash_table_size - 1)).to(torch.int32)
