"""Three-group Adam: tables, HPD and decoder, each with its own lr and
weight decay; betas (0.9, 0.99), eps 1e-15.

``torch.optim.Adam`` adds weight decay to the gradient (L2) before the
moment updates, which is what optax's ``add_decayed_weights`` followed by
``scale_by_adam`` does in the JAX package. The input BatchNorm's scale and
bias are in no group: they stay frozen, as in the JAX package. So does a
frozen HPD (``freeze_hpd``, a pretrained HPD loaded with ``-hwp``: the JAX
package's "frozen" label); the vanilla path has no HPD and no HPD group.

:func:`to_optax_state` and :func:`load_optax_state` carry the Adam state
to and from the JAX package's optax state (``utils/checkpoint.py``'s
stand-ins): per label "encoding", "hpd" and "mlp" a masked chain of
(weight decay, Adam, scale), whose Adam ``count`` is ``state["step"]``,
``mu`` ``exp_avg`` and ``nu`` ``exp_avg_sq``, with ``MaskedNode`` at the
leaves of the other labels; "frozen" holds no state.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

from ..config import OptimizerConfig
from ..models.gngf import GNGFParams
from ..utils.checkpoint import (
    EmptyState, MaskedNode, MaskedState, PartitionState, ScaleByAdamState,
)

ADAM_LABELS = ("encoding", "hpd", "mlp")


def param_leaves(params: GNGFParams) -> Iterator[Tuple[tuple, torch.Tensor]]:
    """(path in the JAX package's params tree, tensor) of every parameter."""
    yield ("tables",), params.tables
    for key in ("hpd", "mlp"):
        mlp = getattr(params, key)
        if mlp is not None:
            for i, (w, b) in enumerate(mlp.layers()):
                yield (key, i, "w"), w
                yield (key, i, "b"), b
    if params.batchnorm is not None:
        yield ("batchnorm", "scale"), params.batchnorm.scale
        yield ("batchnorm", "bias"), params.batchnorm.bias


def label_of(path: tuple, freeze_hpd: bool) -> str:
    """The JAX package's optimizer label of a parameter path."""
    if path[0] == "tables":
        return "encoding"
    if path[0] == "hpd":
        return "frozen" if freeze_hpd else "hpd"
    return "mlp" if path[0] == "mlp" else "frozen"


def make_optimizer(cfg: OptimizerConfig, params: GNGFParams,
                   freeze_hpd: bool = False) -> torch.optim.Adam:
    """One group per label that has parameters. A frozen HPD stops taking
    gradients (``requires_grad`` off), so its backward is skipped too."""
    lr_wd = {"encoding": (cfg.encoding_lr, cfg.encoding_weight_decay),
             "hpd": (cfg.hpd_lr, cfg.hpd_weight_decay),
             "mlp": (cfg.mlp_lr, cfg.mlp_weight_decay)}
    if freeze_hpd and params.hpd is not None:
        params.hpd.requires_grad_(False)
    groups = []
    for label in ADAM_LABELS:
        members = [t for path, t in param_leaves(params) if label_of(path, freeze_hpd) == label]
        if members:
            lr, wd = lr_wd[label]
            groups.append({"params": members, "lr": lr, "weight_decay": wd})
    return torch.optim.Adam(groups, betas=(cfg.beta1, cfg.beta2), eps=cfg.eps)


def _tree(params: GNGFParams, leaf) -> dict:
    """The params tree's shape with ``leaf(path, tensor)`` at every leaf."""
    out = {"tables": leaf(("tables",), params.tables)}
    for key in ("hpd", "mlp"):
        mlp = getattr(params, key)
        if mlp is not None:
            out[key] = [{"w": leaf((key, i, "w"), w), "b": leaf((key, i, "b"), b)}
                        for i, (w, b) in enumerate(mlp.layers())]
    if params.batchnorm is not None:
        out["batchnorm"] = {n: leaf(("batchnorm", n), getattr(params.batchnorm, n))
                            for n in ("scale", "bias")}
    return out


def _group_params(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for g in optimizer.param_groups for p in g["params"]]


def to_optax_state(optimizer, params: GNGFParams, freeze_hpd: bool = False) -> PartitionState:
    """The JAX package's optax state (numpy leaves) of ``optimizer``, an Adam
    over ``params`` or its state as {id(param): state}. Every label's Adam
    counts the same steps in the JAX package, so each ``count`` is the
    optimizer's step count, labels without parameters included."""
    if isinstance(optimizer, torch.optim.Optimizer):
        optimizer = {id(p): s for p, s in optimizer.state.items()}
    steps = [float(s["step"]) for s in optimizer.values() if "step" in s]
    count = np.asarray(int(max(steps, default=0)), np.int32)
    inner = {"frozen": MaskedState(EmptyState())}
    for label in ADAM_LABELS:
        def moment(name, label=label):
            def leaf(path, t):
                if label_of(path, freeze_hpd) != label:
                    return MaskedNode()
                state = optimizer.get(id(t), {})
                m = state.get(name)
                return (m.detach().cpu().numpy() if m is not None
                        else np.zeros(tuple(t.shape), np.float32))
            return _tree(params, leaf)

        adam = ScaleByAdamState(count=count, mu=moment("exp_avg"), nu=moment("exp_avg_sq"))
        inner[label] = MaskedState((EmptyState(), adam, EmptyState()))
    return PartitionState(dict(sorted(inner.items())))


def _at(tree, path):
    for key in path:
        if isinstance(tree, dict):
            if key not in tree:
                return None
            tree = tree[key]
        elif isinstance(tree, list) and isinstance(key, int) and key < len(tree):
            tree = tree[key]
        else:
            return None
    return tree


def _adam_of(state) -> ScaleByAdamState:
    """The Adam state inside one label's (masked) chain state."""
    if isinstance(state, ScaleByAdamState):
        return state
    if isinstance(state, tuple):
        for s in state:
            found = _adam_of(s)
            if found is not None:
                return found
    return None


def load_optax_state(optimizer: torch.optim.Adam, params: GNGFParams,
                     opt_state: PartitionState) -> None:
    """Set ``optimizer``'s Adam state from the JAX package's optax state
    (``utils.checkpoint.load_pytree`` of a ``whole_opt.pkl``). A parameter
    the state masks out, or a label whose count is 0, keeps a fresh state;
    a parameter in no group of ``optimizer`` (a frozen HPD) takes none."""
    index = {id(p): i for i, p in enumerate(_group_params(optimizer))}
    new_state = {}
    for label in ADAM_LABELS:
        adam = _adam_of(opt_state.inner_states.get(label))
        if adam is None or int(np.asarray(adam.count)) == 0:
            continue
        for path, t in param_leaves(params):
            mu, nu = _at(adam.mu, path), _at(adam.nu, path)
            if mu is None or isinstance(mu, MaskedNode) or id(t) not in index:
                continue
            if tuple(np.shape(mu)) != tuple(t.shape):
                raise ValueError(f"optimizer state {'/'.join(map(str, path))}: "
                                 f"{np.shape(mu)}, the parameter is {tuple(t.shape)}")
            new_state[index[id(t)]] = {
                "step": torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32),
                "exp_avg": torch.as_tensor(np.asarray(mu, np.float32)),
                "exp_avg_sq": torch.as_tensor(np.asarray(nu, np.float32)),
            }
    sd = optimizer.state_dict()
    sd["state"] = new_state
    optimizer.load_state_dict(sd)
