"""Checkpoints in the JAX package's format, read and written both ways.

A run directory ``{checkpoint_dir}/{grid_id}_{stamp}/`` holds five
artifacts (``whole_model.pkl``, ``whole_opt.pkl``, ``encoding_model.pkl``,
``HPD_model.pkl`` where the model has an HPD, ``MLP_model.pkl``), plus
``bn_state.pkl`` with BatchNorm and ``checkpoint_meta.json`` (format
version and the model config). All but ``whole_opt.pkl`` are pickles of
plain dicts and lists of numpy arrays, the tables (L, T, F) in both
packages.

``whole_opt.pkl`` is the JAX package's optax state: a pickle of optax's
namedtuples, which this package must neither import nor need. Reading,
:func:`load_pytree` unpickles with a restricted ``Unpickler`` that maps
each optax class, by its class name, to a stand-in namedtuple of this
module, takes numpy's array reconstructors, and refuses every other
global. Writing, :func:`save_pytree` pickles with the pure-Python pickler
and writes each stand-in under the global name of the optax class it
stands for (``OPTAX_GLOBALS``, the paths of optax 0.2.6), so the JAX
package loads the file as real optax state. ``train/optimizer.py`` maps
that state to and from ``torch.optim.Adam``'s.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import json
import os
import pickle
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

CHECKPOINT_FORMAT_VERSION = 2


class PartitionState(NamedTuple):
    """optax.multi_transform's state: one inner state per label."""
    inner_states: Any


class MaskedState(NamedTuple):
    inner_state: Any


class EmptyState(NamedTuple):
    pass


class MaskedNode(NamedTuple):
    """A leaf outside a label's mask."""


class ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


# the global names the installed optax (0.2.6) pickles its classes under
OPTAX_GLOBALS = {
    PartitionState: ("optax.transforms._combining", "PartitionState"),
    MaskedState: ("optax.transforms._masking", "MaskedState"),
    EmptyState: ("optax._src.base", "EmptyState"),
    MaskedNode: ("optax.transforms._masking", "MaskedNode"),
    ScaleByAdamState: ("optax._src.transform", "ScaleByAdamState"),
}
# any optax module's class of these names reads as the stand-in (older
# optax named the partition state MultiTransformState, in optax._src.combine)
_STAND_INS = {cls.__name__: cls for cls in OPTAX_GLOBALS}
_STAND_INS["MultiTransformState"] = PartitionState
_NUMPY_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"), ("numpy._core.numeric", "_frombuffer"),
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "optax" and name in _STAND_INS:
            return _STAND_INS[name]
        if (module, name) in _NUMPY_GLOBALS:
            return getattr(importlib.import_module(module), name)
        raise pickle.UnpicklingError(f"checkpoint refers to {module}.{name}, which is not allowed")


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing the stand-ins as optax's classes."""

    def save_global(self, obj, name=None):
        if obj in OPTAX_GLOBALS:
            module, qualname = OPTAX_GLOBALS[obj]
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_host(v) for v in tree]
    if isinstance(tree, tuple):
        items = [_to_host(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return np.asarray(tree) if isinstance(tree, (np.ndarray, np.generic)) else tree


def save_pytree(tree: Any, path: str) -> None:
    """Pickle a tree of dicts, lists, stand-ins and arrays (tensors go to
    numpy) with protocol 4."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=4).dump(_to_host(tree))


def load_pytree(path: str) -> Any:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _config_stamp(model_cfg) -> dict:
    out = {}
    for f in dataclasses.fields(model_cfg):
        v = getattr(model_cfg, f.name)
        if isinstance(v, enum.Enum):
            v = v.value
        elif isinstance(v, tuple):
            v = list(v)  # JSON round-trips tuples as lists
        out[f.name] = v
    return out


class CheckpointMismatchError(RuntimeError):
    """A checkpoint's stamped model config or format version does not match
    what the caller expects."""


def save_run_checkpoint(run_dir: str, params: dict, opt_state: Any,
                        bn_state: Optional[dict] = None, model_cfg=None) -> None:
    """The five artifacts of a best-PSNR checkpoint, ``bn_state.pkl`` where
    there are running statistics, and the stamp where ``model_cfg`` is
    given. ``params``: the JAX package's tree (``gngf.params_to_numpy``)."""
    save_pytree(params, os.path.join(run_dir, "whole_model.pkl"))
    save_pytree(opt_state, os.path.join(run_dir, "whole_opt.pkl"))
    save_pytree(params["tables"], os.path.join(run_dir, "encoding_model.pkl"))
    if "hpd" in params:
        save_pytree(params["hpd"], os.path.join(run_dir, "HPD_model.pkl"))
    save_pytree(params["mlp"], os.path.join(run_dir, "MLP_model.pkl"))
    if bn_state is not None:
        save_pytree(bn_state, os.path.join(run_dir, "bn_state.pkl"))
    if model_cfg is not None:
        meta = {"format_version": CHECKPOINT_FORMAT_VERSION,
                "model_config": _config_stamp(model_cfg)}
        with open(os.path.join(run_dir, "checkpoint_meta.json"), "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True, default=str)


def validate_run_checkpoint(run_dir: str, model_cfg) -> None:
    """Raise CheckpointMismatchError where ``run_dir``'s stamp disagrees with
    ``model_cfg`` on a field both have, or its format is newer than this
    one. An unstamped directory passes."""
    meta_path = os.path.join(run_dir, "checkpoint_meta.json")
    if not os.path.exists(meta_path):
        return
    with open(meta_path) as f:
        meta = json.load(f)
    version = meta.get("format_version")
    if version is not None and version > CHECKPOINT_FORMAT_VERSION:
        raise CheckpointMismatchError(
            f"{run_dir}: checkpoint format v{version} is newer than this "
            f"build's v{CHECKPOINT_FORMAT_VERSION}")
    if model_cfg is None:
        return
    want = {k: str(v) for k, v in _config_stamp(model_cfg).items()}
    got = {k: str(v) for k, v in meta.get("model_config", {}).items()}
    diffs = {k: (got[k], want[k]) for k in want if k in got and got[k] != want[k]}
    if diffs:
        lines = ", ".join(f"{k}: checkpoint={a} vs expected={b}" for k, (a, b) in diffs.items())
        raise CheckpointMismatchError(f"{run_dir}: model config mismatch — {lines}")


def load_run_checkpoint(run_dir: str, model_cfg=None) -> Tuple[dict, Any, Optional[dict]]:
    """(params tree, optimizer state of stand-ins, bn_state or None) of a
    run directory, its stamp checked against ``model_cfg`` where given."""
    validate_run_checkpoint(run_dir, model_cfg)
    params = load_pytree(os.path.join(run_dir, "whole_model.pkl"))
    opt_state = load_pytree(os.path.join(run_dir, "whole_opt.pkl"))
    bn_path = os.path.join(run_dir, "bn_state.pkl")
    bn_state = load_pytree(bn_path) if os.path.exists(bn_path) else None
    return params, opt_state, bn_state


def load_hpd_weights(params, path: str):
    """Replace the HPD of ``params`` (GNGFParams) with the layers of an
    ``HPD_model.pkl``, on the params' device; returns ``params``. Freezing
    is the optimizer's (``make_optimizer(..., freeze_hpd=True)``)."""
    from ..models.gngf import mlp_from_layers

    params.hpd = mlp_from_layers(load_pytree(path), params.tables.device)
    return params


def load_encoding_weights(params, path: str):
    """Copy the (L, T, F) tables of an ``encoding_model.pkl`` into
    ``params``; returns ``params``."""
    tables = torch.as_tensor(np.asarray(load_pytree(path), np.float32))
    if tables.shape != params.tables.shape:
        raise ValueError(f"{path}: tables {tuple(tables.shape)}, the model has "
                         f"{tuple(params.tables.shape)}")
    with torch.no_grad():
        params.tables.copy_(tables)
    return params
