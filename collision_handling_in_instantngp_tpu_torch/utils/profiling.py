"""Profiling helpers: a ``torch.profiler`` trace, device time by kernel,
kernel timing with CUDA events, a step timer, and the card's name and
power limit.

The port of the JAX package's ``utils/profiling.py`` (``trace``,
``StepTimer``), plus what the measurement tools and ``chip_smoke.py``
share. A time taken here on the CPU is a host-clock time and is labelled
so; device times come only from the card.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Callable, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (host, and the card where there is one)
    and write a Chrome/Perfetto trace to ``<log_dir>/trace.json``:

        with profiling.trace("chiprun_out/trace") as prof:
            run_epoch(...)        # ends in a host transfer
        rows = device_time_by_kernel(prof, wall_ms)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_time_by_kernel(prof, wall_ms: float) -> dict:
    """Device time by kernel name from a finished profile: {"wall_ms",
    "busy_ms", "idle_share", "kernels": [{"name", "ms", "calls", "share"}]}
    sorted by time. Everything runs on one stream, so the busy time is the
    sum of the device events; user annotations (e.g. ``Optimizer.step``)
    span kernels already counted and are skipped. A profile without device
    events gives busy 0 and idle share 1."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            row = by_name.setdefault(e.name, dict(name=e.name, ms=0.0, calls=0))
            row["ms"] += e.device_time_total / 1e3
            row["calls"] += 1
    busy = sum(r["ms"] for r in by_name.values())
    rows = sorted(by_name.values(), key=lambda r: -r["ms"])
    for r in rows:
        r["share"] = r["ms"] / busy if busy else 0.0
    idle = max(0.0, 1.0 - busy / wall_ms) if wall_ms > 0 else 1.0
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=idle, kernels=rows)


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls after one warm-up
    call, from CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean host-clock time of ``fn`` in ms over ``reps`` calls after one
    warm-up call (the CPU path; no device time)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def time_ms(fn: Callable[[], object], reps: int, device: torch.device) -> float:
    """CUDA-event time on the card, host-clock time on the CPU."""
    return cuda_ms(fn, reps) if device.type == "cuda" else host_ms(fn, reps)


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W"."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def device_info(dev: torch.device) -> dict:
    """Where a measurement ran: platform, device name, the card's name and
    power limit (None on the CPU) and the clock its times come from."""
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", gpu=None, timer="host_clock")
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                gpu=gpu_name_and_power_limit(), timer="cuda_events")


class StepTimer:
    """Wall-clock step timer: ``stop`` with a tensor first copies it to the
    host, which waits for the work it depends on."""

    def __init__(self) -> None:
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync_value: Optional[torch.Tensor] = None) -> float:
        if sync_value is not None:
            float(sync_value.detach().reshape(-1)[0].cpu())
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop called before start")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return dt
