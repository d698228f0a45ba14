"""Start the ranks of a process group as processes of this machine.

:func:`spawn` starts ``world_size`` processes with the ``spawn`` start
method; each joins one group through a ``FileStore`` in a directory of the
caller's (no TCP port to race for), runs ``fn(rank, world_size, *args)``
and writes what it returns to a file of that directory, which the caller
gets back in rank order. A rank that raises, exits non-zero or outlives
``timeout`` fails the whole call: the others are stopped and
:func:`spawn` raises with the rank's traceback. ``fn`` must be importable
by module and name (a function of a module, or of the ``__main__`` script
that calls :func:`spawn`), ``args`` picklable.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence


def _entry(fn, rank, world_size, backend, init_method, device, args, out_path, threads):
    import torch
    import torch.distributed as dist

    from .mesh import initialize_distributed

    if threads:
        torch.set_num_threads(threads)
    try:
        initialize_distributed(backend, init_method, rank, world_size, device)
        result = {"ok": fn(rank, world_size, *args)}
    except Exception:
        result = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    if "error" in result:
        raise SystemExit(1)


def spawn(fn: Callable, world_size: int, args: Sequence[Any] = (), *, store_dir: str,
          backend: str = "gloo", device="cuda", timeout: float = 600.0,
          threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    joined in one ``backend`` group on ``device`` (a card every rank uses,
    unless "cpu" is asked for; several ranks on one card need gloo, as NCCL
    takes one rank a card); ``threads`` sets each rank's torch threads.
    Returns every rank's result, rank 0 first."""
    os.makedirs(store_dir, exist_ok=True)
    init_method = "file://" + os.path.abspath(os.path.join(store_dir, "store"))
    outs = [os.path.join(store_dir, f"rank{r}.pkl") for r in range(world_size)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world_size, backend, init_method, str(device),
                                              tuple(args), outs[r], threads))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        if late:
            raise TimeoutError(f"ranks {late} of {world_size} still running after {timeout:.0f} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results, errors = [], []
    for r, (p, out) in enumerate(zip(procs, outs)):
        if not os.path.exists(out):
            errors.append(f"rank {r} exited with code {p.exitcode} and no result")
            continue
        with open(out, "rb") as f:
            res = pickle.load(f)
        if "error" in res or p.exitcode != 0:
            errors.append(f"rank {r} (exit code {p.exitcode}):\n{res.get('error', '')}")
        results.append(res.get("ok"))
    if errors:
        raise RuntimeError("\n".join(errors))
    return results
