"""Training loss: MSE + per-level JS/KL slot-uniformity + collision penalty.

  total = l_mse * MSE + sum_l (l_js_kl * js_kl_l + l_collisions * coll_l)

* The compared distribution is each level's MARGINAL slot distribution
  over the batch (an (N,) vector, N = T, or K under keep_topk_only): the
  model emits it pre-reduced, or hands dense (P, L, V, N) probabilities
  (the per-row route's dense branch, or its top-k values under
  keep_topk_only) that ``marginal_slot_distribution`` reduces.
* ``KLDivLoss(reduction='batchmean')(log p, q)`` on a 1-D input is
  ``sum(q (log q - log p)) / N``; the 1/N is kept. ``xlogy`` gives 0 where
  q == 0.
* "js" is the reference's variant ``(KL_bm(m || p) + KL_bm(m || q)) / 2``
  with m = (p + q) / 2, and ``js_kl = -(gamma + epsilon) js + epsilon kl``.
* The collision term ``collisions / (min_possible + delta)`` uses the
  previous epoch's counts and carries no gradient.
* The vanilla hash path has neither marginals nor probs: the loss is
  ``l_mse * MSE``, with zero JS/KL and collision terms.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import LossConfig


class LossAux(NamedTuple):
    total: torch.Tensor
    mse: torch.Tensor
    js_kl_per_level: torch.Tensor   # (L,)
    coll_per_level: torch.Tensor    # (L,) no gradient


def _kl_batchmean(log_p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.special.xlogy(q, q) - q * log_p, dim=-1) / q.shape[-1]


def marginal_slot_distribution(probs: torch.Tensor) -> torch.Tensor:
    """(P, L, V, N) -> (L, N): sum over pixels and corners / (P * V)."""
    p, _, v, _ = probs.shape
    return torch.sum(probs, dim=(0, 2)) / (p * v)


def js_kl_divergence(p_marginal: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    """(L, N) marginals -> (L,) js_kl per level."""
    n = p_marginal.shape[-1]
    q = torch.full_like(p_marginal, 1.0 / n)
    log_p = torch.log(p_marginal)
    kl = _kl_batchmean(log_p, q)
    m = (p_marginal + q) / 2.0
    js = (_kl_batchmean(log_p, m) + _kl_batchmean(torch.log(q), m)) / 2.0
    return -(cfg.gamma + cfg.epsilon) * js + cfg.epsilon * kl


def compute_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    marginals: Optional[torch.Tensor],
    prev_collisions: torch.Tensor,
    prev_min_possible: torch.Tensor,
    cfg: LossConfig,
    valid_rows: Optional[int] = None,
    probs: Optional[torch.Tensor] = None,
) -> LossAux:
    """pred/target (P, C) in [0, 1]; marginals (L, N), or None with dense
    ``probs`` (P, L, V, N) instead, or neither (the vanilla path); prev_*
    (L,) from the previous epoch (zeros at epoch 0). Rows >= valid_rows are
    the padded tail of the last batch and are masked out of the MSE."""
    if valid_rows is None:
        mse = torch.mean((pred - target) ** 2)
    else:
        mask = (torch.arange(pred.shape[0], device=pred.device) < valid_rows).to(pred.dtype)
        mse = torch.sum((pred - target) ** 2 * mask[:, None]) / (valid_rows * pred.shape[-1])
    if marginals is None and probs is None:
        zeros = torch.zeros(prev_collisions.shape, dtype=mse.dtype, device=mse.device)
        return LossAux(total=cfg.l_mse * mse, mse=mse, js_kl_per_level=zeros,
                       coll_per_level=zeros)
    coll = (prev_collisions / (prev_min_possible + cfg.delta)).detach()
    if marginals is None:
        marginals = marginal_slot_distribution(probs)
    js_kls = js_kl_divergence(marginals, cfg)
    total = cfg.l_mse * mse + torch.sum(cfg.l_js_kl * js_kls + cfg.l_collisions * coll)
    return LossAux(total=total, mse=mse, js_kl_per_level=js_kls, coll_per_level=coll)
