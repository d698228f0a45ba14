"""One training batch's time by stage program (the port's counterpart of the
JAX package's ``tools/ablate_scaled.py``). Each stage is timed alone, up to
one scalar probe that depends on its whole work:

  fwd      the loss (under ``torch.no_grad``)
  grad     the loss and ``torch.autograd.grad`` of it
  update   the Adam step alone, on gradients computed beforehand
  step     the loss, its gradients and the Adam step (a batch of ``fit``)

The batch is batch 0 of grid 4061 on the dedup route, at
``instantngp_scaled_model()`` with 1/8 batches (``--mode scaled``, the JAX
tool's) or the default geometry (``--mode gngf``); ``--batch-fraction`` and
``--precision`` override. Times are CUDA-event means over ``--reps`` runs
after one warm-up run (host clock with ``--device cpu``). ``update`` and
``step`` move the weights as they run, as the JAX tool's do not; the shapes,
and so the work, stay the same.

``--cell-gather`` runs the A/B of ``ModelConfig.dedup_cell_gather`` as the
JAX tool does: the stage programs on the same batch with the field on, then
off, each from the same weights, and prints and returns both (``ms`` is the
field-on run's). The field selects a TPU layout in the JAX package and
nothing in the port (``models/encoding.py``), so here the two runs are one
program and their difference is the timer's spread.

    python -m collision_handling_in_instantngp_tpu_torch.tools.ablate_scaled \\
        [--mode scaled|gngf] [--batch-fraction F] [--reps N] \\
        [--precision default|high|highest] [--device cuda] [--image PATH] [--cell-gather]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from ..data import load_image_dataset
from ..device import resolve_device
from ..models import gngf
from ..train.optimizer import make_optimizer
from ..utils import profiling
from .attribution import IMAGE, batch_zero, probe, real_loss
from .roofline import experiment


def stage_programs(exp, params, batch, optimizer):
    """{stage: fn() -> scalar probe}, and the gradients ``update`` applies."""
    weights = [p for p in params.parameters() if p.requires_grad]

    def grads_of():
        loss = real_loss(exp, params, batch)
        return loss, torch.autograd.grad(loss, weights)

    def fwd():
        with torch.no_grad():
            return real_loss(exp, params, batch)

    def grad():
        loss, grads = grads_of()
        return loss.detach() + probe(*grads)

    fixed = [g.detach().clone() for g in grads_of()[1]]

    def apply(grads):
        for p, g in zip(weights, grads):
            p.grad = g
        optimizer.step()
        state = [t for s in optimizer.state.values() for k, t in s.items() if k != "step"]
        return probe(*weights, *state)

    def update():
        return apply(fixed)

    def step():
        loss, grads = grads_of()
        return loss.detach() + apply(grads)

    return dict(fwd=fwd, grad=grad, update=update, step=step)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="One batch's time by stage program.")
    ap.add_argument("--mode", default="scaled", choices=["scaled", "gngf"])
    ap.add_argument("--batch-fraction", type=float, default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cell-gather", action="store_true",
                    help="A/B ModelConfig.dedup_cell_gather (one program in the port)")
    ap.add_argument("--precision", default=None, choices=["default", "high", "highest"],
                    help="matmul precision of the whole stage programs")
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    ap.add_argument("--image", default=IMAGE)
    return ap


def run(exp, batch, dev, reps: int) -> dict:
    """{stage: ms} of the stage programs on ``batch`` from ``exp``'s seed."""
    params = gngf.init_params(exp.model, exp.train.seed, dev)
    programs = stage_programs(exp, params, batch, make_optimizer(exp.optimizer, params))
    return {name: profiling.time_ms(fn, reps, dev) for name, fn in programs.items()}


def report(t: dict) -> None:
    print(f"fwd     {t['fwd']:9.3f} ms/batch   (loss only)")
    print(f"grad    {t['grad']:9.3f} ms/batch   (fwd+bwd)")
    print(f"update  {t['update']:9.3f} ms/batch   (optimizer only)")
    print(f"step    {t['step']:9.3f} ms/batch   (fwd+bwd+update)")
    print(f"derived: bwd ~ {max(t['grad'] - t['fwd'], 0):.3f} ms, fusion overlap "
          f"(grad+update-step) ~ {t['grad'] + t['update'] - t['step']:.3f} ms")


def with_cell_gather(exp, on: bool):
    return dataclasses.replace(exp, model=dataclasses.replace(exp.model, dedup_cell_gather=on))


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    exp = experiment(args.mode, args.precision)
    fraction = args.batch_fraction or (1 / 8 if args.mode == "scaled" else None)
    if fraction:
        exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train, batch_fraction=fraction))
    data = load_image_dataset(args.image)
    cases = {"on": True, "off": False} if args.cell_gather else {"on": exp.model.dedup_cell_gather}
    info = profiling.device_info(dev)
    out = {}
    for label, on in cases.items():
        run_exp = with_cell_gather(exp, on)
        batch = batch_zero(run_exp, data, dev)
        t = run(run_exp, batch, dev, args.reps)
        p = int(batch.x.shape[0])
        print(f"mode={args.mode} batch_rows={p} device={info['kind']} ({info['gpu'] or 'host clock'})"
              f" dedup_cell_gather={on}")
        report(t)
        out[label] = dict(ms=t, dedup_cell_gather=on)
    res = dict(mode=args.mode, precision=exp.model.matmul_precision, batch_rows=p,
               reps=args.reps, ms=out["on"]["ms"], device_kind=info["kind"], gpu=info["gpu"])
    if args.cell_gather:
        res["cell_gather"] = out
        print(f"cell gather on - off: step {out['on']['ms']['step'] - out['off']['ms']['step']:.3f} "
              f"ms, grad {out['on']['ms']['grad'] - out['off']['ms']['grad']:.3f} ms")
    return res


if __name__ == "__main__":
    main()
