"""Typed configuration: the port's own copy of the JAX package's config.

Same dataclasses, field names and defaults as the JAX package's ``config.py``
so that a configuration means the same run in both, and the same grid-search
enumeration so that ``-s/-e`` ids are interchangeable (48,000 filtered
configs; id 4061 is the README's best run). One model field is left out
because it picks a layout the port does not have: ``dedup_cell_gather``
(the TPU cell-table gather layouts); the port runs the dedup route with a
plain row gather. Kept as a copy rather than an import: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple


class TopkBlendMode(enum.Enum):
    """How top-k looked-up features are blended over the K axis.

    RAW_SUM      ``sum(looked_up * topk_probs)``
    SOFTMAX_AVG  ``sum(looked_up * softmax(topk_probs))`` (default)
    WEIGHTED_AVG ``sum(looked_up * topk_probs) / sum(topk_probs)``
    """

    RAW_SUM = "raw_sum"
    SOFTMAX_AVG = "softmax_avg"
    WEIGHTED_AVG = "weighted_avg"


class TopkScatterMode(enum.Enum):
    """Backward of the straight-through top-k: SCATTER sends the value
    gradients to the selected slots; NOOP drops them (the reference's
    discarded out-of-place scatter)."""

    SCATTER = "scatter"
    NOOP = "noop"


class HiddenActivation(enum.Enum):
    RELU = "relu"
    LEAKY_RELU = "leaky_relu"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyper-parameters (defaults = the reference's T=2^8, 4 levels)."""

    input_dim: int = 2
    hash_table_size: int = 2**8
    num_levels: int = 4
    n_min: int = 8
    n_max: int = 32
    feature_dim: int = 2
    mlp_hidden: Tuple[int, ...] = (64, 64)
    hpd_hidden: Tuple[int, ...] = (32, 64, 128)
    topk_k: int = 4
    out_channels: int = 3
    use_hash_function: bool = False
    keep_topk_only: bool = False
    batchnorm_input: bool = False
    hidden_activation: HiddenActivation = HiddenActivation.RELU
    topk_blend: TopkBlendMode = TopkBlendMode.SOFTMAX_AVG
    topk_scatter: TopkScatterMode = TopkScatterMode.SCATTER
    # "highest" = true fp32 (TF32 off), "high" = 3-term bf16 hi/lo split,
    # "default" = one bf16-rounded product; all accumulate in fp32
    matmul_precision: str = "highest"
    # a recall target for lax.approx_max_k in the JAX package, which is
    # approximate only on a TPU (XLA lowers it to an exact top-k on the CPU
    # and GPU). Set, it sends the HPD's streamed tails to their chunked
    # PyTorch route, which takes the exact lowest-index top-k; the kernel
    # routes ("pallas", "pallas_full") ignore it, as the JAX package's do.
    topk_approx_recall: Optional[float] = None
    # per-row route (dedup off): stream the HPD tail over row chunks instead
    # of materializing the dense (P, L, V, T) probabilities; False = dense
    fused_hpd: bool = True
    # False (or batchnorm_input) takes the per-row route
    dedup_vertices: bool = True
    # dedup route: "auto" streams the HPD tail past DEDUP_DENSE_MAX_ELEMENTS
    # (U*T), "unique_stream" always streams; anything else runs dense.
    # per-row route: "auto" takes the whole-network kernels (K10/K11) for
    # K <= 32 and T <= 2048, "pallas_full" always, both only where their
    # row tile fits the stack; "pallas" (and those two past that tile) the
    # tail kernels (K8/K9) after a plain hidden stack; anything else the
    # chunked PyTorch tail (models/hpd.py: fused_backend)
    hpd_backend: str = "auto"

    @property
    def num_corners(self) -> int:
        return 2**self.input_dim

    @property
    def encoded_dim(self) -> int:
        """MLP decoder input width L*F, level-major."""
        return self.num_levels * self.feature_dim


def instantngp_scaled_model(**overrides) -> ModelConfig:
    """InstantNGP-paper-scale preset: T=2^14, 16 levels, resolutions 16..512
    (the CLI's ``--scaled``)."""
    base = dict(
        hash_table_size=2**14,
        num_levels=16,
        n_min=16,
        n_max=512,
        feature_dim=2,
    )
    base.update(overrides)
    return ModelConfig(**base)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """gamma/epsilon per the grid axes: sum_js_kl -> (grid gamma, 1),
    js_div -> (-1, 0), else (-1, 1)."""

    delta: float = 1.0
    gamma: float = -1.0
    epsilon: float = 1.0
    l_mse: float = 1.0
    l_js_kl: float = 1.0
    l_collisions: float = 1.0

    @staticmethod
    def resolve_gamma_epsilon(
        should_sum_js_kl_div: bool, should_js_div: bool, loss_gamma: float
    ) -> Tuple[float, float]:
        gamma = loss_gamma if should_sum_js_kl_div else -1.0
        epsilon = 1.0 if should_sum_js_kl_div else (0.0 if should_js_div else 1.0)
        return float(gamma), float(epsilon)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Three-group Adam."""

    encoding_lr: float = 1e-4
    hpd_lr: float = 1e-3
    mlp_lr: float = 1e-3
    encoding_weight_decay: float = 0.0
    hpd_weight_decay: float = 1e-6
    mlp_weight_decay: float = 1e-6
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-15


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_fraction: float = 1.0 / 3.0
    epochs: int = 5000
    tolerance: int = 500
    min_delta: float = 1e-6
    histograms_rate: int = 100
    shuffle_pixels: bool = True
    seed: int = 2**16 - 1
    save_params: bool = True
    zero_collision_abort: bool = True
    checkpoint_dir: str = "weights"
    checkpoint_min_interval_s: float = 10.0


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    grid_id: Optional[int] = None


# Key ORDER matters: ids come from itertools.product over the values in
# insertion order.
GRID_SEARCH_AXES: Dict[str, List[Any]] = {
    "should_shuffle_pixels": [True, False],
    "should_keep_topk_only": [False, True],
    "should_sum_js_kl_div": [False, True],
    "loss_gamma": [-2, -3, -0.5, 0],
    "should_js_div": [False, True],
    "l_mse": [1, 1e1, 1e2, 1e3, 5e2],
    "l_js_kl": [1, 1e1, 1e2, 1e3, 5e2],
    "l_collisions": [1, 1e-1, 1e-2, 1e-3],
    "MLP_lr": [1e-3, 1e-4],
    "HPD_lr": [1e-3, 1e-4],
    "topk_k": [1, 4, 20, 32, 128],
}


def get_grid_search_configs(
    axes: Optional[Dict[str, List[Any]]] = None,
) -> List[Dict[str, Any]]:
    """Cartesian product, then constraint mutation (sum_js_kl -> js_div=False;
    else loss_gamma=0), then order-preserving dedup: 48,000 configs for the
    default axes; list index == grid id."""
    axes = GRID_SEARCH_AXES if axes is None else axes
    raw = [dict(zip(axes.keys(), vals)) for vals in itertools.product(*axes.values())]
    seen: set = set()
    filtered: List[Dict[str, Any]] = []
    for cfg in raw:
        if cfg["should_sum_js_kl_div"]:
            cfg["should_js_div"] = False
        else:
            cfg["loss_gamma"] = 0
        key = tuple(cfg.items())
        if key in seen:
            continue
        seen.add(key)
        filtered.append(cfg)
    return filtered


def experiment_from_grid_id(
    grid_id: int,
    base_model: Optional[ModelConfig] = None,
    base_train: Optional[TrainConfig] = None,
    grid: Optional[Sequence[Dict[str, Any]]] = None,
) -> ExperimentConfig:
    grid = get_grid_search_configs() if grid is None else grid
    g = grid[grid_id]
    base_model = base_model if base_model is not None else ModelConfig()
    base_train = base_train if base_train is not None else TrainConfig()
    gamma, epsilon = LossConfig.resolve_gamma_epsilon(
        g["should_sum_js_kl_div"], g["should_js_div"], g["loss_gamma"]
    )
    model = dataclasses.replace(
        base_model,
        topk_k=int(g["topk_k"]),
        keep_topk_only=bool(g["should_keep_topk_only"]),
    )
    loss = LossConfig(
        delta=1.0,
        gamma=gamma,
        epsilon=epsilon,
        l_mse=float(g["l_mse"]),
        l_js_kl=float(g["l_js_kl"]),
        l_collisions=float(g["l_collisions"]),
    )
    opt = OptimizerConfig(mlp_lr=float(g["MLP_lr"]), hpd_lr=float(g["HPD_lr"]))
    train = dataclasses.replace(
        base_train, shuffle_pixels=bool(g["should_shuffle_pixels"])
    )
    return ExperimentConfig(
        model=model, loss=loss, optimizer=opt, train=train, grid_id=grid_id
    )
