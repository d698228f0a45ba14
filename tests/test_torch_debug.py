"""The port's debug mode against the JAX package's ``utils/debug.py``, on
the CPU: ``assert_all_finite`` names the first non-finite leaf by the same
path as JAX over the same numpy tree (and by parameter name over
``GNGFParams``); ``checked_step`` reports a step's non-finite output where
JAX's ``checkify_step`` does, and a NaN made in a backward raises at once.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.utils import debug as jdebug
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.utils import debug


def _tree():
    cfg = jcfg.ModelConfig(hash_table_size=32, hpd_hidden=(8,), mlp_hidden=(8,))
    return jax.tree_util.tree_map(np.asarray, jgngf.init_params(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("where", [("tables",), ("hpd", 0, "w"), ("mlp", 1, "b")],
                         ids=lambda w: "/".join(map(str, w)))
@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_assert_all_finite_names_the_path_as_jax(where, bad):
    tree = _tree()
    debug.assert_all_finite(tree, "params")
    jdebug.assert_all_finite(tree, "params")
    leaf = tree
    for k in where[:-1]:
        leaf = leaf[k]
    leaf[where[-1]] = leaf[where[-1]].copy()
    leaf[where[-1]].reshape(-1)[1] = bad
    with pytest.raises(FloatingPointError) as ref:
        jdebug.assert_all_finite(tree, "params")
    with pytest.raises(FloatingPointError) as got:
        debug.assert_all_finite(tree, "params")
    assert str(got.value) == str(ref.value)

    params = gngf.params_from_jax(tree)
    name = {"tables": ".tables", "hpd": ".hpd.weights.0", "mlp": ".mlp.biases.1"}[where[0]]
    with pytest.raises(FloatingPointError, match=f"non-finite values in params{name}$"):
        debug.assert_all_finite(params, "params")


def test_assert_all_finite_skips_integer_leaves():
    debug.assert_all_finite({"ids": torch.arange(4), "n": np.arange(3), "x": [torch.ones(2)]})


def test_checked_step_reports_a_non_finite_output_as_checkify():
    def jax_step(x):
        return {"loss": jnp.log(x).sum(), "x": x}

    def step(x):
        return {"loss": torch.log(x).sum(), "x": x}

    for vals, finite in (([1.0, 2.0], True), ([1.0, -2.0], False)):
        jerr, _ = jdebug.checkify_step(jax_step)(jnp.asarray(vals))
        err, out = debug.checked_step(step)(torch.tensor(vals))
        assert (jerr.get() is None) == (err.get() is None) == finite
        if finite:
            err.throw()
            assert out["loss"].item() == pytest.approx(np.log(2.0))
        else:
            with pytest.raises(FloatingPointError, match=r"outputs\['loss'\]"):
                err.throw()


def test_checked_step_raises_on_a_nan_in_the_backward():
    w = torch.tensor([1.0, 0.0], requires_grad=True)

    def step():
        loss = torch.sqrt(w).sum()       # finite forward; d sqrt at 0 is inf, times 0 -> nan
        (loss * 0.0).backward()
        return loss

    with pytest.raises(RuntimeError, match="nan"):
        debug.checked_step(step)()
