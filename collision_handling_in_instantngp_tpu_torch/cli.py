"""Command-line entry point of the port.

  python -m collision_handling_in_instantngp_tpu_torch.cli \
      -f strawberry.jpeg -s 4061 -e 4061 [--scaled] [--should_bw] [--epochs N] \
      [--device cuda] [-t] [--logger {jsonl,wandb,null}] \
      [--wandb_entity ... --wandb_project ... --wandb_name ...] \
      [-hwp HPD_model.pkl] [-ewp encoding_model.pkl] [--log_image_every N] \
      [--manifest runs/grid_manifest.jsonl] [--shard-index I --shard-count N] \
      [--epoch_span S] [--ensemble E]

``-e`` is inclusive; without it the run goes from ``-s`` through the last id
of the grid, as in the JAX package's CLI. The sweep is the grid driver's
(``train/grid_search.py``): ids already in ``--manifest`` are skipped and
their rows replayed (the JAX package's manifest resumes here and the other
way round), and a shard takes ``ids[index::count]`` (-1: the
``torch.distributed`` rank and world size, else 0 of 1). Images load from
``--images_dir`` (a ``.npy`` uint8 image needs neither cv2 nor PIL);
``--should_bw`` trains a one-channel model on the grayscale image. Each
grid id logs to its own logger: ``runs/{image}_{id}.jsonl`` (``-t``: the
media-saving ``runs/{image}_{id}_test.jsonl``, never wandb; where
matplotlib is not installed the JSONL logs keep no media), and writes its
best-PSNR checkpoint to ``weights/{id}_{stamp}/``. ``-t`` then renders the
last id's checkpoint at the image's size and saves the original beside it
as ``runs/{image}_{id}_comparison.png`` (where matplotlib is installed).
``-hwp`` loads a pretrained HPD and freezes it, ``-ewp`` starts from saved
tables; both read the JAX package's files as well as the port's. Runs on
the card unless ``--device cpu`` (or the JAX CLI's ``--platform cpu``).
``--epoch_span S`` runs up to S epochs a call with nothing read on the host
between them (``trainer.fit``); ``--ensemble E`` trains E configurations of
one shape side by side (``trainer.fit_ensemble``, through the grid driver:
no per-id logs, one best-PSNR checkpoint each, ``weights/{id}_ens{id}/``).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run General Neural Gauge Fields (PyTorch/CUDA).")
    p.add_argument("-f", "--filename", type=str, default="strawberry.jpeg",
                   help="Image file name inside --images_dir.")
    p.add_argument("--images_dir", type=str, default="images")
    p.add_argument("--should_bw", action="store_true",
                   help="Convert the image to black and white (a one-channel model).")
    p.add_argument("-s", "--start_id_param", type=int, default=0,
                   help="First grid-search config id.")
    p.add_argument("-e", "--end_id_param", type=int, default=None,
                   help="Last grid-search config id (inclusive; default: the last "
                        "id of the grid).")
    p.add_argument("-t", "--is_test", action="store_true",
                   help="Test mode: no remote logging; a local JSONL log with media.")
    p.add_argument("--epochs", type=int, default=None,
                   help="Override the 5000-epoch budget.")
    p.add_argument("--logger", type=str, default="jsonl", choices=["jsonl", "wandb", "null"])
    p.add_argument("--wandb_entity", type=str, default="dl_project_bussola-fasoli-montagna")
    p.add_argument("--wandb_project", type=str, default="cv_project_final_grid_search")
    p.add_argument("--wandb_name", type=str, default=None)
    p.add_argument("-ewp", "--encoding_weights_path", type=str, default=None,
                   help="encoding_model.pkl whose tables start the run.")
    p.add_argument("-hwp", "--hpd_weights_path", type=str, default=None,
                   help="HPD_model.pkl whose HPD is loaded and frozen.")
    p.add_argument("--log_image_every", type=int, default=None,
                   help="Log the reconstructed train_image every N epochs "
                        "(default: counts epochs only).")
    p.add_argument("--scaled", action="store_true",
                   help="T=2^14, 16 levels, resolutions 16..512 instead of "
                        "T=2^8 x 4 levels.")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain versions of the kernels.")
    p.add_argument("--platform", type=str, default="auto", choices=["auto", "cpu"],
                   help="The JAX CLI's flag: 'auto' keeps --device, 'cpu' runs on the CPU.")
    p.add_argument("--manifest", type=str, default="runs/grid_manifest.jsonl",
                   help="Completion manifest: ids in it are skipped (resume).")
    p.add_argument("--shard-index", type=int, default=0,
                   help="-1 = the torch.distributed rank (0 without a process group).")
    p.add_argument("--shard-count", type=int, default=1,
                   help="-1 = the torch.distributed world size (1 without a process group).")
    p.add_argument("--epoch_span", type=int, default=1,
                   help="Epochs per call, with nothing read on the host between them. >1 "
                        "amortizes the host's per-epoch work; logging/early-stop still "
                        "evaluate per epoch (see trainer.fit).")
    p.add_argument("--ensemble", type=int, default=1,
                   help=">1: train that many same-shape configs side by side (scalar "
                        "metrics only; see trainer.fit_ensemble).")
    return p


def has_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def make_logger_factory(args, image_name: str):
    """The logger of each grid id, as the JAX package's CLI builds it; a
    JSONL log stores media only where matplotlib is installed."""
    from .utils.logging import make_logger

    stamp = args.wandb_name or time.strftime("%Y%m%d%H%M%S")
    media = has_matplotlib()
    if not media and args.logger != "null":
        print("matplotlib not available; the JSONL logs keep no media")

    def logger_factory(exp):
        if args.is_test:
            return make_logger("jsonl", path=f"runs/{image_name}_{exp.grid_id}_test.jsonl",
                               save_media=media)
        if args.logger == "null":
            return make_logger("null")
        if args.logger == "wandb":
            from .config import reference_wandb_config

            return make_logger(
                "wandb", path=f"runs/{image_name}_{exp.grid_id}.jsonl", save_media=media,
                wandb_kwargs=dict(
                    entity=args.wandb_entity, project=args.wandb_project, group=image_name,
                    name=f"{stamp}_{exp.grid_id}",
                    config=reference_wandb_config(exp, image_name=image_name,
                                                  bw=args.should_bw),
                ),
            )
        return make_logger("jsonl", path=f"runs/{image_name}_{exp.grid_id}.jsonl",
                           save_media=media)

    return logger_factory


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .config import ModelConfig, experiment_from_grid_id, get_grid_search_configs
    from .config import instantngp_scaled_model
    from .data import load_image_dataset
    from .device import resolve_device
    from .train.grid_search import run_grid_search

    device = resolve_device("cpu" if args.platform == "cpu" else args.device)
    channels = 1 if args.should_bw else 3
    model_cfg = (instantngp_scaled_model(out_channels=channels) if args.scaled
                 else ModelConfig(out_channels=channels))
    image_path = os.path.join(args.images_dir, args.filename)
    data = load_image_dataset(image_path, bw=args.should_bw,
                              normalize=not model_cfg.batchnorm_input)
    print(f"Image: {image_path} ({data.height}x{data.width}, {data.num_pixels} pixels, "
          f"{data.channels} channels) on {device}")
    grid = get_grid_search_configs()
    end = args.end_id_param if args.end_id_param is not None else len(grid) - 1
    if not 0 <= args.start_id_param <= end < len(grid):
        raise ValueError(f"grid ids must satisfy 0 <= start <= end <= {len(grid) - 1}")
    image_name = os.path.splitext(args.filename)[0]
    results = run_grid_search(
        data, args.start_id_param, end + 1, base_model=model_cfg, epochs=args.epochs,
        manifest_path=args.manifest, logger_factory=make_logger_factory(args, image_name),
        hpd_weights_path=args.hpd_weights_path,
        encoding_weights_path=args.encoding_weights_path,
        shard_index=None if args.shard_index < 0 else args.shard_index,
        shard_count=None if args.shard_count < 0 else args.shard_count,
        progress=sys.stdout.isatty(), epoch_span=args.epoch_span,
        ensemble_size=args.ensemble, log_image_every=args.log_image_every, device=device,
    )
    for row in results:
        print(f"grid {row['grid_id']}: best PSNR {row['best_psnr']:.3f} "
              f"({row['epochs_run']} epochs)"
              + (f", checkpoint {row['run_dir']}" if row["run_dir"] else ""))

    if args.is_test and results and results[-1]["run_dir"]:
        # the reference's test mode shows the original beside the output;
        # here the last id's checkpoint is rendered and saved as a figure
        from .models.gngf import params_from_jax
        from .render import render_image
        from .utils.checkpoint import load_pytree

        last = results[-1]
        exp = experiment_from_grid_id(last["grid_id"], base_model=model_cfg, grid=grid)
        tree = load_pytree(os.path.join(last["run_dir"], "whole_model.pkl"))
        recon = render_image(params_from_jax(tree, device), exp.model, height=data.height,
                             width=data.width, device=device)
        print(f"rendered grid {last['grid_id']} from {last['run_dir']}: "
              f"{'x'.join(map(str, recon.shape))} uint8")
        if has_matplotlib():
            from .utils.visualize import save_comparison

            out_path = f"runs/{image_name}_{last['grid_id']}_comparison.png"
            os.makedirs("runs", exist_ok=True)
            save_comparison(data.image.astype(np.uint8), recon, out_path)
            print(f"comparison figure: {out_path}")
        else:
            print("matplotlib not available; no comparison figure is written")
    return 0


if __name__ == "__main__":
    sys.exit(main())
