"""Numerical-sanity debug mode: find the first non-finite value of a step.

``checked_step`` wraps a step function: it runs under
``torch.autograd.detect_anomaly(check_nan=True)`` (a backward that makes a
NaN raises, naming its op), then every float tensor of the outputs is
checked. It returns ``(error, outputs)`` and ``error.throw()`` raises on
the first non-finite value, named by its path, so the JAX package's
``checkify_step`` call sites read the same. ``assert_all_finite`` is the
host-side check over a tree of parameters.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every tensor or array in ``tree``: modules by their
    named parameters and buffers, dicts by key, lists, tuples and named
    tuples by index."""
    if isinstance(tree, nn.Module):
        for name, t in (*tree.named_parameters(), *tree.named_buffers()):
            yield f"{path}.{name}", t
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, (torch.Tensor, np.ndarray)):
        yield path, tree


def first_non_finite(tree: Any) -> Optional[str]:
    """The path of the first float leaf that holds a NaN or an Inf, or None."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf.detach()).all()):
                return path
        elif leaf.dtype.kind == "f" and not np.all(np.isfinite(leaf)):
            return path
    return None


def assert_all_finite(tree: Any, name: str = "tree") -> None:
    """Raise FloatingPointError naming the first non-finite float leaf."""
    path = first_non_finite(tree)
    if path is not None:
        raise FloatingPointError(f"non-finite values in {name}{path}")


class StepError:
    """The result of one checked step; ``throw()`` raises where it found a
    non-finite value."""

    def __init__(self, message: Optional[str] = None):
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def checked_step(step_fn: Callable) -> Callable:
    """Wrap ``step_fn``: the wrapped function returns ``(error, outputs)``.
    A backward inside the step that makes a NaN raises at once (anomaly
    mode); a non-finite output is reported by ``error.throw()``."""

    def wrapped(*args, **kwargs):
        with torch.autograd.detect_anomaly(check_nan=True):
            outputs = step_fn(*args, **kwargs)
        path = first_non_finite(outputs)
        return StepError(None if path is None else f"non-finite values in outputs{path}"), outputs

    return wrapped
