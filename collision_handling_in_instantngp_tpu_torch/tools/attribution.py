"""The training step of batch 0 split by stage, in rows that sum to the step
(the port's counterpart of the JAX package's ``tools/attribution.py``).

Cumulative prefixes: prefix k runs the real pipeline from the batch inputs
through stage k and reduces the live tensors to one scalar probe; stage k
costs t(prefix k) - t(prefix k-1), so the rows telescope and sum to the
last prefix, which is the whole step. The forward column times each prefix
under ``torch.no_grad``; the backward column adds ``torch.autograd.grad``
of the prefix scalar with respect to the trained parameters (a prefix
short of the loss sees a ones cotangent at its probe, not the real one:
the same products and traffic). The last row, "optimizer", is the real
step: the loss, its gradients and ``make_optimizer``'s Adam step.

The prefixes mirror ``models/gngf.py: forward`` on the dedup route:

  noop       the probe of the inputs and parameters alone (what every
             prefix pays before any model work)
  geometry   ``scale_to_grid``, ``bilinear_coeffs``, the active vertices
  hidden     the HPD hidden stack on the unique vertices: K3a / K3b
             (``ops/cuda/hidden.py``, under the gate ``hidden.supports``) on
             the streamed route, else the plain stack
  tail       ``apply_hpd_unique``: the streamed tail K1 / K2 at ``--mode
             scaled``, the dense HPD at ``--mode gngf``
  blend      ``blend_unique`` + ``gather_rows`` (K12 takes both table
             gradients) + ``interpolate``
  decoder    the pixel MLP and its sigmoid
  loss       ``train/loss.py: compute_loss``

A gate holds the mirror to the model: the last prefix's loss must be bitwise
the value ``gngf.forward`` plus ``compute_loss`` give on the same batch and
weights, or the tool raises (a mirror that drifted would charge time to the
wrong stage). Times are CUDA-event means over ``--reps`` runs after one
warm-up run (host-clock times with ``--device cpu``, which only checks that
the tool runs).

    python -m collision_handling_in_instantngp_tpu_torch.tools.attribution \\
        [--mode scaled|gngf] [--precision default|high|highest] [--reps N] \\
        [--json-out PATH] [--device cuda] [--image PATH]

``--json-out`` writes the JAX tool's keys (``mode``, ``precision``,
``batch_rows``, ``reps``, ``unique_rows``, ``dims``, ``device_kind``,
``rows``, ``step_ms``, ``stamp``) and ``power_limit_w``; its times are
unrounded, so the rows' ``d_fwdbwd_ms`` sum to ``step_ms``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, NamedTuple

import torch

from ..config import ExperimentConfig
from ..data import load_image_dataset, make_shuffle_permutations
from ..device import resolve_device
from ..models import encoding as enc
from ..models import gngf
from ..models.hpd import apply_hpd_unique, relu_stack, use_stream
from ..ops import dedup as dedup_ops
from ..ops.cuda import hidden
from ..ops.grid import scale_to_grid
from ..ops.interpolate import bilinear_coeffs, interpolate
from ..ops.precision import pdot
from ..train.loss import compute_loss
from ..train.optimizer import make_optimizer
from ..train.train_step import build_epoch_batches
from ..utils import profiling
from .roofline import experiment

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
IMAGE = os.path.join(REPO, "images", "strawberry.npy")
STAGES = ("noop", "geometry", "hidden", "tail", "blend", "decoder", "loss")


class Batch(NamedTuple):
    """Batch 0 of an epoch, on its device."""

    statics: gngf.GNGFStatics
    x: torch.Tensor
    y: torch.Tensor
    valid: int
    geom: dedup_ops.DedupGeometry
    num_batches: int


def batch_zero(exp: ExperimentConfig, data, device) -> Batch:
    """The first of the epoch's batches as ``fit`` builds them; raises
    unless it takes the dedup route."""
    statics = gngf.make_statics(exp.model)
    shuffled, _ = make_shuffle_permutations(data.num_pixels, exp.train.seed,
                                            exp.train.shuffle_pixels)
    batches = build_epoch_batches(data.coords, data.targets, exp.train.batch_fraction, shuffled,
                                  data.image, exp.model, statics, device)
    if batches.dedup[0] is None:
        raise ValueError("the stage split follows the dedup route; this configuration does not "
                         "take it")
    return Batch(statics, batches.x[0], batches.y[0], batches.valid[0], batches.dedup[0],
                 int(batches.x.shape[0]))


def probe(*tensors) -> torch.Tensor:
    """One float32 scalar that depends on every element of ``tensors``
    (None skipped)."""
    total = None
    for t in tensors:
        if t is None:
            continue
        s = t.sum().to(torch.float32)
        total = s if total is None else total + s
    return total


def loss_state(exp: ExperimentConfig, device):
    """The collision state the split runs at: no previous collisions,
    minimum ones (the JAX tool's), so the collision term is zero."""
    l = exp.model.num_levels
    return (torch.zeros(l, dtype=torch.float32, device=device),
            torch.ones(l, dtype=torch.float32, device=device))


def make_prefix(exp: ExperimentConfig, params: gngf.GNGFParams, batch: Batch
                ) -> Callable[[str], torch.Tensor]:
    """``prefix(stage)``: the step through ``stage`` reduced to one scalar
    (at "loss", the loss itself)."""
    mcfg, lcfg = exp.model, exp.loss
    x, dev = batch.x, batch.x.device
    consts = gngf.device_statics(batch.statics, dev)
    n_ls, offsets = consts.n_ls, consts.offsets
    side = dedup_ops.grid_side(mcfg.n_max)
    geom = batch.geom
    prev_coll, prev_min = loss_state(exp, dev)
    prec = mcfg.matmul_precision

    def prefix(upto: str) -> torch.Tensor:
        if upto == "noop":
            return probe(x) + probe(*params.parameters())
        with torch.no_grad():
            scaled, _ = scale_to_grid(x, n_ls, offsets)
        ucoords = (dedup_ops.active_coords(geom.active, side) if geom.active is not None
                   else consts.unique_coords)
        coeffs = bilinear_coeffs(scaled, offsets)
        if upto == "geometry":
            return probe(ucoords, coeffs)
        if upto == "hidden":
            # the hidden stack as apply_hpd_unique runs it (the dense HPD
            # runs it as the plain stack); the whole call would run the tail
            layers = params.hpd.layers()[:-1]
            widths = [ucoords.shape[1]] + [w.shape[1] for w, _ in layers]
            if (use_stream(mcfg, ucoords.shape[0]) and layers and hidden.supports(widths)):
                h = hidden.hidden_stack(ucoords, layers, prec)
            else:
                h = relu_stack(ucoords, layers, prec)
            return probe(h, coeffs)
        marginal_raw, vals_u, idx_u = apply_hpd_unique(params.hpd, ucoords, mcfg,
                                                       counts=geom.counts)
        if upto == "tail":
            return probe(marginal_raw, vals_u, idx_u, coeffs)
        feats_u = enc.blend_unique(params.tables, idx_u, vals_u, mcfg)
        h_pix = interpolate(enc.gather_rows(feats_u, geom.ids), coeffs)
        if upto == "blend":
            return probe(h_pix, marginal_raw)
        rgb = params.mlp(h_pix, mcfg.hidden_activation.value, "sigmoid", prec)
        if upto == "decoder":
            return probe(rgb, marginal_raw)
        if upto != "loss":
            raise ValueError(upto)
        if mcfg.keep_topk_only:
            marginal_raw = pdot(geom.counts, vals_u, "highest")
        marginal = marginal_raw / (x.shape[0] * mcfg.num_corners)
        return compute_loss(rgb, batch.y, marginal, prev_coll, prev_min, lcfg,
                            valid_rows=batch.valid).total

    return prefix


def real_loss(exp: ExperimentConfig, params: gngf.GNGFParams, batch: Batch) -> torch.Tensor:
    """The loss as the trainer computes it on the batch."""
    prev_coll, prev_min = loss_state(exp, batch.x.device)
    out = gngf.forward(params, batch.x, exp.model, batch.statics, dedup=batch.geom)
    return compute_loss(out.rgb, batch.y, out.marginal, prev_coll, prev_min, exp.loss,
                        valid_rows=batch.valid, probs=out.probs).total


def check_gate(exp, params, batch, prefix) -> float:
    """Raises unless the last prefix is bitwise the real loss; returns it."""
    with torch.no_grad():
        mirrored, real = prefix("loss"), real_loss(exp, params, batch)
    if not torch.equal(mirrored, real):
        raise RuntimeError(f"the stage prefixes diverged from gngf.forward: loss {mirrored.item()!r} "
                           f"against {real.item()!r}")
    return float(real)


def trained(params: gngf.GNGFParams):
    return [p for p in params.parameters() if p.requires_grad]


def grad_probe(prefix, stage: str, weights) -> torch.Tensor:
    """The prefix scalar plus the probe of its gradients."""
    out = prefix(stage)
    if not out.requires_grad:
        return out.detach()
    grads = torch.autograd.grad(out, weights, allow_unused=True)
    return out.detach() + probe(*grads)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="The training step split by stage, rows summing "
                                             "to the step.")
    ap.add_argument("--mode", default="scaled", choices=["scaled", "gngf"])
    ap.add_argument("--precision", default=None, choices=["default", "high", "highest"])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json-out", default="")
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    ap.add_argument("--image", default=IMAGE)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    exp = experiment(args.mode, args.precision)
    mcfg = exp.model
    data = load_image_dataset(args.image)
    batch = batch_zero(exp, data, dev)
    params = gngf.init_params(mcfg, exp.train.seed, dev)
    prefix = make_prefix(exp, params, batch)
    check_gate(exp, params, batch, prefix)
    weights = trained(params)

    def ms(fn):
        return profiling.time_ms(fn, args.reps, dev)

    fwd_t, bwd_t = {}, {}
    for s in STAGES:
        with torch.no_grad():
            fwd_t[s] = ms(lambda s=s: prefix(s))
        bwd_t[s] = ms(lambda s=s: grad_probe(prefix, s, weights))

    optimizer = make_optimizer(exp.optimizer, params)

    def step():
        loss = prefix("loss")
        for p, g in zip(weights, torch.autograd.grad(loss, weights)):
            p.grad = g
        optimizer.step()
        return loss.detach()

    t_step = ms(step)      # last: it moves the weights

    info = profiling.device_info(dev)
    p = int(batch.x.shape[0])
    print(f"mode={args.mode} precision={mcfg.matmul_precision} batch_rows={p} "
          f"device={info['kind']} ({info['gpu'] or 'host clock'}) reps={args.reps}")
    print(f"{'stage':10s} {'fwd ms':>9s} {'Δfwd':>8s} {'fwd+bwd ms':>11s} {'Δ(f+b)':>8s}")
    prev_f = prev_b = 0.0
    rows = []
    for s in STAGES:
        df, db = fwd_t[s] - prev_f, bwd_t[s] - prev_b
        print(f"{s:10s} {fwd_t[s]:9.3f} {df:8.3f} {bwd_t[s]:11.3f} {db:8.3f}")
        rows.append(dict(stage=s, fwd_ms=fwd_t[s], d_fwd_ms=df, fwdbwd_ms=bwd_t[s], d_fwdbwd_ms=db))
        prev_f, prev_b = fwd_t[s], bwd_t[s]
    d_opt = t_step - bwd_t["loss"]
    print(f"{'optimizer':10s} {'':>9s} {'':>8s} {t_step:11.3f} {d_opt:8.3f}")
    rows.append(dict(stage="optimizer", fwdbwd_ms=t_step, d_fwdbwd_ms=d_opt))
    print(f"TOTAL step {t_step:.3f} ms/batch ({p / t_step:.1f}K px/s at {batch.num_batches} "
          "batches)")

    u_rows = int(batch.geom.active.shape[0] if batch.geom.active is not None
                 else batch.statics.unique_coords.shape[0])
    result = dict(
        mode=args.mode, precision=mcfg.matmul_precision, batch_rows=p, reps=args.reps,
        unique_rows=u_rows,
        dims=dict(H=int(mcfg.hpd_hidden[-1]), T=int(mcfg.hash_table_size), L=int(mcfg.num_levels),
                  K=int(mcfg.topk_k), F=int(mcfg.feature_dim), hpd_hidden=list(mcfg.hpd_hidden),
                  mlp_hidden=list(mcfg.mlp_hidden), input_dim=int(mcfg.input_dim),
                  corners=int(mcfg.num_corners)),
        device_kind=info["kind"], rows=rows, step_ms=t_step,
        stamp=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        power_limit_w=profiling.power_limit_w(info["gpu"]), gpu=info["gpu"])
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"-> {args.json_out}")
    return result


if __name__ == "__main__":
    main()
