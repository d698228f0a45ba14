"""Command-line entry point of the port.

  python -m collision_handling_in_instantngp_tpu_torch.cli \
      -f strawberry.jpeg -s 4061 -e 4061 [--scaled] [--epochs N] [--device cuda] \
      [-t] [--logger {jsonl,wandb,null}] \
      [--wandb_entity ... --wandb_project ... --wandb_name ...] \
      [-hwp HPD_model.pkl] [-ewp encoding_model.pkl] [--log_image_every N]

``-e`` is inclusive; without it the run goes from ``-s`` through the last id
of the grid, as in the JAX package's CLI. Images load from ``--images_dir``
(a ``.npy`` uint8 image needs neither cv2 nor PIL). Each grid id logs to
its own logger: ``runs/{image}_{id}.jsonl`` (``-t``: the media-saving
``runs/{image}_{id}_test.jsonl``, never wandb; where matplotlib is not
installed the JSONL logs keep no media), and writes its best-PSNR
checkpoint to ``weights/{id}_{stamp}/``. ``-hwp`` loads a pretrained HPD
and freezes it, ``-ewp`` starts from saved tables; both read the JAX
package's files as well as the port's. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run General Neural Gauge Fields (PyTorch/CUDA).")
    p.add_argument("-f", "--filename", type=str, default="strawberry.jpeg",
                   help="Image file name inside --images_dir.")
    p.add_argument("--images_dir", type=str, default="images")
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
    return p


def make_logger_factory(args, image_name: str):
    """The logger of each grid id, as the JAX package's CLI builds it; a
    JSONL log stores media only where matplotlib is installed."""
    from .utils.logging import make_logger

    stamp = args.wandb_name or time.strftime("%Y%m%d%H%M%S")
    media = importlib.util.find_spec("matplotlib") is not None
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
                    config=reference_wandb_config(exp, image_name=image_name),
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
    from .train.trainer import fit

    device = resolve_device(args.device)
    model_cfg = instantngp_scaled_model() if args.scaled else ModelConfig()
    image_path = os.path.join(args.images_dir, args.filename)
    data = load_image_dataset(image_path, normalize=not model_cfg.batchnorm_input)
    print(f"Image: {image_path} ({data.height}x{data.width}, {data.num_pixels} pixels, "
          f"{data.channels} channels) on {device}")
    grid = get_grid_search_configs()
    end = args.end_id_param if args.end_id_param is not None else len(grid) - 1
    if not 0 <= args.start_id_param <= end < len(grid):
        raise ValueError(f"grid ids must satisfy 0 <= start <= end <= {len(grid) - 1}")
    logger_factory = make_logger_factory(args, os.path.splitext(args.filename)[0])
    for gid in range(args.start_id_param, end + 1):
        exp = experiment_from_grid_id(gid, base_model=model_cfg, grid=grid)
        res = fit(exp, data, epochs=args.epochs, device=device, logger=logger_factory(exp),
                  hpd_weights_path=args.hpd_weights_path,
                  encoding_weights_path=args.encoding_weights_path,
                  log_image_every=args.log_image_every)
        print(f"grid {gid}: best PSNR {res.best_psnr:.3f} ({res.epochs_run} epochs)"
              + (f", checkpoint {res.run_dir}" if res.run_dir else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
