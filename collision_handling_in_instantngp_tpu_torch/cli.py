"""Command-line entry point of the port.

  python -m collision_handling_in_instantngp_tpu_torch.cli \
      -f strawberry.jpeg -s 4061 -e 4061 [--scaled] [--epochs N] [--device cuda]

``-e`` is inclusive; without it the run goes from ``-s`` through the last id
of the grid, as in the JAX package's CLI. Images load from ``--images_dir``
(a ``.npy`` uint8 image needs neither cv2 nor PIL). Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys


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
    p.add_argument("--epochs", type=int, default=None,
                   help="Override the 5000-epoch budget.")
    p.add_argument("--scaled", action="store_true",
                   help="T=2^14, 16 levels, resolutions 16..512 instead of "
                        "T=2^8 x 4 levels.")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain versions of the kernels.")
    return p


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
    for gid in range(args.start_id_param, end + 1):
        exp = experiment_from_grid_id(gid, base_model=model_cfg, grid=grid)
        res = fit(exp, data, epochs=args.epochs, device=device)
        print(f"grid {gid}: best PSNR {res.best_psnr:.3f} ({res.epochs_run} epochs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
