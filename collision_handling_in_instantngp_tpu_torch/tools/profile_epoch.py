"""A ``torch.profiler`` trace of training epochs of grid 4061 on the card.

    python -m collision_handling_in_instantngp_tpu_torch.tools.profile_epoch \\
        [--epochs 3] [--logdir chiprun_out/trace] \\
        [--mode gngf|gngf-dense|scaled] [--device cuda] [--image images/strawberry.npy]

Modes: ``gngf`` the default geometry (T = 2^8, 4 levels), ``gngf-dense``
the same with the dense HPD branch (``fused_hpd=False``), ``vanilla`` the
default geometry with the vanilla hash (``use_hash_function=True``: no HPD,
the table gradient on K12), ``scaled`` ``instantngp_scaled_model()``
(T = 2^14, 16 levels: K1-K3). After two warm-up epochs, ``--epochs`` epochs of ``run_epoch`` are traced, each timed
on the host clock up to a host copy of the tables (``StepTimer``); the tool
prints px/s, device time by kernel and the device-memory watermark, and
writes ``<logdir>/trace.json`` (Chrome / Perfetto).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from ..config import experiment_from_grid_id, instantngp_scaled_model
from ..data import load_image_dataset, make_shuffle_permutations
from ..device import resolve_device
from ..models import gngf
from ..train.optimizer import make_optimizer
from ..train.train_step import build_epoch_batches, initial_collision_state, run_epoch
from ..utils import memory, profiling

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODES = ("gngf", "gngf-dense", "vanilla", "scaled")


def experiment(mode: str):
    exp = experiment_from_grid_id(4061)
    if mode == "gngf-dense":
        return dataclasses.replace(exp, model=dataclasses.replace(exp.model, fused_hpd=False))
    if mode == "vanilla":
        return dataclasses.replace(exp, model=dataclasses.replace(exp.model, use_hash_function=True))
    if mode == "scaled":
        return experiment_from_grid_id(4061, base_model=instantngp_scaled_model())
    return exp


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Trace training epochs with torch.profiler.")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--logdir", default=os.path.join(REPO, "chiprun_out", "trace"))
    ap.add_argument("--mode", default="gngf", choices=MODES)
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    ap.add_argument("--image", default=os.path.join(REPO, "images", "strawberry.npy"))
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    exp = experiment(args.mode)
    dev = resolve_device(args.device)
    data = load_image_dataset(args.image)
    statics = gngf.make_statics(exp.model)
    shuffled, _ = make_shuffle_permutations(data.num_pixels, exp.train.seed, exp.train.shuffle_pixels)
    batches = build_epoch_batches(data.coords, data.targets, exp.train.batch_fraction, shuffled,
                                  data.image, exp.model, statics, dev)
    params = gngf.init_params(exp.model, exp.train.seed, dev)
    optimizer = make_optimizer(exp.optimizer, params)
    prev, min_poss = initial_collision_state(exp, statics, dev)

    def epoch():
        return run_epoch(params, optimizer, batches, exp, statics, prev, min_poss)

    for _ in range(2):                      # warm-up: kernel builds, allocator
        epoch()
    timer = profiling.StepTimer()
    epoch_s = []
    with profiling.trace(args.logdir) as prof:
        for _ in range(args.epochs):
            timer.start()
            epoch()
            epoch_s.append(timer.stop(params.tables))
    dt = sum(epoch_s)
    px_s = args.epochs * data.num_pixels / dt
    print(f"traced {args.epochs} epochs in {dt:.3f}s ({px_s:.0f} px/s) on {dev} -> "
          f"{os.path.join(args.logdir, 'trace.json')}")
    mem = memory.print_allocated_memory(f"profile_epoch {args.mode}", log=True, device=dev)
    result = dict(mode=args.mode, epochs=args.epochs, seconds=dt, epoch_seconds=epoch_s,
                  pixels_per_s=px_s, memory_gb=mem)
    if dev.type != "cuda":
        print("  device time: not measured (CPU run)")
        return result
    summary = profiling.device_time_by_kernel(prof, 1e3 * dt)
    for row in summary["kernels"][:12]:
        print(f"  {row['ms']:10.3f} ms {row['share']:7.2%} x{row['calls']:<5d} {row['name'][:90]}")
    print(f"  device busy {summary['busy_ms']:.1f} ms of {summary['wall_ms']:.1f} ms, "
          f"idle share {summary['idle_share']:.2%}")
    return dict(result, **summary)


if __name__ == "__main__":
    main()
