"""Three-group Adam: tables, HPD and decoder, each with its own lr and
weight decay; betas (0.9, 0.99), eps 1e-15.

``torch.optim.Adam`` adds weight decay to the gradient (L2) before the
moment updates, which is what optax's ``add_decayed_weights`` followed by
``scale_by_adam`` does in the JAX package. The input BatchNorm's scale and
bias are in no group: they stay frozen, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..config import OptimizerConfig
from ..models.gngf import GNGFParams


def make_optimizer(cfg: OptimizerConfig, params: GNGFParams) -> torch.optim.Adam:
    groups = [
        {"params": [params.tables], "lr": cfg.encoding_lr,
         "weight_decay": cfg.encoding_weight_decay},
        {"params": list(params.hpd.parameters()), "lr": cfg.hpd_lr,
         "weight_decay": cfg.hpd_weight_decay},
        {"params": list(params.mlp.parameters()), "lr": cfg.mlp_lr,
         "weight_decay": cfg.mlp_weight_decay},
    ]
    return torch.optim.Adam(groups, betas=(cfg.beta1, cfg.beta2), eps=cfg.eps)
