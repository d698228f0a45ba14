"""Deterministic serial scatter-add (kernel K12).

Replaces ``ops/pallas/scatter_probe.py: scatter_add_vmem`` of the JAX
package: rows (N, C) float32, idx (N,) slot ids in [0, T) ->
segment_sum(rows, idx, T) as (T, C) float32, each slot's rows added in
ascending row order, bitwise the serial sum.

For a CUDA tensor ``scatter_add_serial`` sorts the row ids stably by slot
and finds each slot's range (index preparation, which the TPU kernel does
not do in its body: ``torch.sort``, ``torch.searchsorted`` and the range
check, :func:`prepare`), then launches the reduction kernel of
``scatter.cu`` (:func:`scatter_sorted`): the rows are gathered into slot
order, then a block streams the rows of 8 slots through a shared-memory
ring while one warp per slot adds that slot's rows in row order. No
atomics. For a CPU tensor it runs the plain version, the same serial sum
in PyTorch. Both raise ValueError on an idx outside [0, T).
"""

from __future__ import annotations

import ctypes

import torch

from . import build


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _check(rows: torch.Tensor, idx: torch.Tensor, t: int) -> None:
    if rows.dim() != 2 or idx.shape != (rows.shape[0],) or rows.dtype != torch.float32:
        raise ValueError(
            f"scatter_add_serial takes rows (N, C) float32 and idx (N,); got rows "
            f"{tuple(rows.shape)} {rows.dtype}, idx {tuple(idx.shape)}"
        )
    if idx.device != rows.device or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx: expected int32/int64 on {rows.device}, got {idx.dtype} on {idx.device}")
    if rows.shape[0] >= 2**31 or t < 0:
        raise ValueError(f"scatter_add_serial takes N < 2^31 rows and T >= 0; got N={rows.shape[0]}, T={t}")


def _out_of_range(t: int) -> ValueError:
    return ValueError(f"scatter_add_serial: idx outside [0, {t})")


def scatter_add_serial_plain(rows: torch.Tensor, idx: torch.Tensor, t: int) -> torch.Tensor:
    """Each slot's rows added one after another in ascending row order,
    from 0: the TPU kernel's serial sum, bitwise. Round j adds the j-th row
    of every slot that has more than j rows, with the slots ordered longest
    first so that those are a prefix; as many rounds as the longest slot
    has rows."""
    _check(rows, idx, t)
    n, c = rows.shape
    idx = idx.long()
    if n and (int(idx.min()) < 0 or int(idx.max()) >= t):
        raise _out_of_range(t)
    count = torch.bincount(idx, minlength=t)
    by_len = torch.argsort(count, descending=True, stable=True)
    place = torch.empty_like(by_len)
    place[by_len] = torch.arange(t, device=idx.device)
    keys, order = torch.sort(idx, stable=True)
    rank = torch.arange(n, device=idx.device) - (torch.cumsum(count, 0) - count)[keys]
    ordered = rows.index_select(0, order[torch.argsort(rank * t + place[keys])])
    hist = torch.bincount(count)
    active = (hist.sum() - torch.cumsum(hist, 0))[:-1].tolist()
    acc = torch.zeros(t, c, dtype=rows.dtype, device=rows.device)
    r0 = 0
    for a in active:
        acc[:a] += ordered[r0:r0 + a]
        r0 += a
    return acc.index_select(0, place)


def _lib() -> ctypes.CDLL:
    lib = build.library("scatter")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.scatter_add_serial.argtypes = [vp] * 3 + [ci] * 3 + [vp] * 3
    lib.scatter_add_serial.restype = ci
    return lib


def prepare(idx: torch.Tensor, t: int):
    """(order (N,) int32 row ids sorted stably by slot, offsets (T + 1,)
    int32 each slot's range in it) on idx's device; raises ValueError on an
    idx outside [0, T) (one host sync)."""
    n = idx.shape[0]
    keys, order = torch.sort(idx, stable=True)
    offsets = torch.searchsorted(keys, torch.arange(t + 1, device=idx.device, dtype=keys.dtype),
                                 out_int32=True)
    # offsets[0] and offsets[T] (a view, one copy to the host) must be 0 and N
    if (offsets[::t].tolist() != [0, n]) if t else n:
        raise _out_of_range(t)
    return order.to(torch.int32), offsets


def scatter_sorted(rows: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The kernel alone on :func:`prepare`'s output: (T, C) float32. Counts
    one launch of ``scatter_add_serial``. Allocates an (N, C) float32
    scratch for the rows in slot order, as large as ``rows`` (83 MB at the
    blend's N = 647,168, C = 32), freed on return."""
    dev = rows.device
    rows = rows.contiguous()
    (n, c), t = rows.shape, offsets.shape[0] - 1
    out = torch.empty(t, c, device=dev, dtype=torch.float32)
    rows_sorted = torch.empty(n, c, device=dev, dtype=torch.float32)   # the kernel's scratch
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.scatter_add_serial(
            rows.data_ptr(), order.data_ptr(), offsets.data_ptr(), n, t, c, out.data_ptr(),
            rows_sorted.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(code, lib, "scatter_error_string", "scatter_add_serial")
    scatter_add_serial.launches += 1
    return out


def _launch(rows: torch.Tensor, idx: torch.Tensor, t: int) -> torch.Tensor:
    _check(rows, idx, t)
    return scatter_sorted(rows, *prepare(idx, t))


def scatter_add_serial(rows: torch.Tensor, idx: torch.Tensor, t: int) -> torch.Tensor:
    """(T, C) = segment_sum(rows, idx, T), each slot summed in row order (K12)."""
    if _on_card(rows):
        return _launch(rows, idx, t)
    return scatter_add_serial_plain(rows, idx, t)


scatter_add_serial.launches = 0
