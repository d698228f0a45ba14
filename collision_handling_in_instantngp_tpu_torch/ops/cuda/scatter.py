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
ring while one warp per slot adds that slot's rows in row order (variant
"ring"); rows of 4 columns or fewer in slots of at most 32 rows on average
go to one thread per slot and column instead, adding in the same order
(variant "narrow", :func:`narrow_path`). No atomics. For a CPU tensor it
runs the plain version, the same serial sum in PyTorch. Both raise
ValueError on an idx outside [0, T), except where the caller passes
``ids_checked`` (ids a gather's forward has already checked): the card
path then skips the check and its host sync.

A ``slot_range`` (lo, hi) gives rows lo..hi of that (T, C) sum alone: the
slots a rank holds when the tables are sharded by slot
(``parallel/mesh.py``). The card path takes the slot offsets over
[lo, hi] on the same sorted ids, so the kernel visits only the rows of
those slots (the rows of other slots are sorted past either end and never
read); no host sync, no compaction, the same kernel. The plain version
keeps the rows of those slots in their order and sums them.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

VARIANTS = ("ring", "narrow")
NARROW_COLS = 4    # widest rows of the narrow variant
NARROW_ROWS = 32   # most rows a slot on average for the narrow variant


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


def _range_of(slot_range, t: int):
    lo, hi = (0, t) if slot_range is None else (int(slot_range[0]), int(slot_range[1]))
    if not 0 <= lo <= hi <= t:
        raise ValueError(f"scatter_add_serial: slot range [{lo}, {hi}) is not within [0, {t})")
    return lo, hi


def scatter_add_serial_plain(rows: torch.Tensor, idx: torch.Tensor, t: int,
                             slot_range=None) -> torch.Tensor:
    """Each slot's rows added one after another in ascending row order,
    from 0: the TPU kernel's serial sum, bitwise. Round j adds the j-th row
    of every slot that has more than j rows, with the slots ordered longest
    first so that those are a prefix; as many rounds as the longest slot
    has rows. ``slot_range`` (lo, hi): rows lo..hi of the (T, C) sum."""
    _check(rows, idx, t)
    n, c = rows.shape
    idx = idx.long()
    if n and (int(idx.min()) < 0 or int(idx.max()) >= t):
        raise _out_of_range(t)
    if slot_range is not None:
        lo, hi = _range_of(slot_range, t)
        keep = (idx >= lo) & (idx < hi)
        return scatter_add_serial_plain(rows[keep], idx[keep] - lo, hi - lo)
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
    lib.scatter_add_serial.argtypes = [vp] * 3 + [ci] * 4 + [vp] * 3
    lib.scatter_add_serial.restype = ci
    return lib


def prepare(idx: torch.Tensor, t: int, check: bool = True, slot_range=None):
    """(order (N,) int32 row ids sorted stably by slot, offsets (T + 1,)
    int32 each slot's range in it) on idx's device; with ``check``, raises
    ValueError on an idx outside [0, T) (one host sync). ``slot_range``
    (lo, hi): the offsets (hi - lo + 1,) of the slots lo..hi alone."""
    n = idx.shape[0]
    keys, order = torch.sort(idx, stable=True)
    if slot_range is not None:
        lo, hi = _range_of(slot_range, t)
        offsets = torch.searchsorted(
            keys, torch.arange(lo, hi + 1, device=idx.device, dtype=keys.dtype), out_int32=True)
        # the smallest and largest id (one copy to the host) must lie in [0, T)
        if check and n:
            first, last = torch.stack((keys[0], keys[-1])).tolist()
            if first < 0 or last >= t:
                raise _out_of_range(t)
        return order.to(torch.int32), offsets
    offsets = torch.searchsorted(keys, torch.arange(t + 1, device=idx.device, dtype=keys.dtype),
                                 out_int32=True)
    # offsets[0] and offsets[T] (a view, one copy to the host) must be 0 and N
    if check and ((offsets[::t].tolist() != [0, n]) if t else n):
        raise _out_of_range(t)
    return order.to(torch.int32), offsets


def narrow_path(n: int, c: int, t: int) -> bool:
    """Whether N rows of C columns on T slots take the narrow variant."""
    return c <= NARROW_COLS and n <= NARROW_ROWS * t


def scatter_sorted(rows: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor,
                   ranged: bool = False) -> torch.Tensor:
    """The kernel alone on :func:`prepare`'s output: (T, C) float32, T =
    len(offsets) - 1. Counts one launch of ``scatter_add_serial``, in total,
    by variant (``variant_launches``) and, for ``ranged`` offsets (a slot
    range), in ``range_launches``. Allocates an (N, C) float32
    scratch for the rows in slot order, as large as ``rows`` (83 MB at the
    blend's N = 647,168, C = 32), freed on return."""
    dev = rows.device
    rows = rows.contiguous()
    (n, c), t = rows.shape, offsets.shape[0] - 1
    narrow = narrow_path(n, c, t)
    out = torch.empty(t, c, device=dev, dtype=torch.float32)
    rows_sorted = torch.empty(n, c, device=dev, dtype=torch.float32)   # the kernel's scratch
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.scatter_add_serial(
            rows.data_ptr(), order.data_ptr(), offsets.data_ptr(), n, t, c, int(narrow),
            out.data_ptr(),
            rows_sorted.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(code, lib, "scatter_error_string", "scatter_add_serial")
    scatter_add_serial.launches += 1
    scatter_add_serial.variant_launches[VARIANTS[narrow]] += 1
    scatter_add_serial.range_launches += int(ranged)
    return out


def _launch(rows: torch.Tensor, idx: torch.Tensor, t: int, check: bool,
            slot_range=None) -> torch.Tensor:
    _check(rows, idx, t)
    return scatter_sorted(rows, *prepare(idx, t, check, slot_range),
                          ranged=slot_range is not None)


def scatter_add_serial(rows: torch.Tensor, idx: torch.Tensor, t: int,
                       ids_checked: bool = False, slot_range=None) -> torch.Tensor:
    """(T, C) = segment_sum(rows, idx, T), each slot summed in row order
    (K12). ``ids_checked``: idx is known to lie in [0, T), so the card path
    makes no range check (no host sync); the CPU path always checks.
    ``slot_range`` (lo, hi): rows lo..hi of that sum, (hi - lo, C)."""
    if _on_card(rows):
        return _launch(rows, idx, t, not ids_checked, slot_range)
    return scatter_add_serial_plain(rows, idx, t, slot_range)


scatter_add_serial.launches = 0
scatter_add_serial.variant_launches = dict.fromkeys(VARIANTS, 0)
scatter_add_serial.range_launches = 0
