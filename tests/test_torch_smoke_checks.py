"""``chip_smoke.py``'s step 20 verdict on the CPU, on small synthetic runs:
``nudged_params`` moves every parameter element by exactly one ulp, and
``check_parallel`` holds a rank to JAX's bounds against the single
process, and its parameters to JAX's bound around the range the nudged
single-process runs span only where such a run itself leaves that bound;
losses, collisions and the BatchNorm statistics stay held to the single
process."""

import copy
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

from collision_handling_in_instantngp_tpu_torch.config import (  # noqa: E402
    ModelConfig, experiment_from_grid_id,
)
from collision_handling_in_instantngp_tpu_torch.models import gngf  # noqa: E402

RNG = np.random.default_rng(65535)


def _run(tables=None, losses=(0.5, 0.4, 0.3), colls=((1.0, 2.0),) * 3, bn=None, launches=1):
    tables = RNG.uniform(-1e-3, 1e-3, (2, 8, 2)).astype(np.float32) if tables is None else tables
    return dict(rank=0, history=[dict(loss=l, collisions=list(c)) for l, c in zip(losses, colls)],
                params=dict(tables=tables, mlp=[dict(w=np.ones((2, 3), np.float32),
                                                     b=np.zeros(3, np.float32))]),
                bn_state=bn or dict(mean=np.zeros(2), var=np.ones(2)),
                launches=dict(k=launches))


def _moved(run, use, at=(0, 3, 1)):
    """``run`` with one table element moved by ``use`` of JAX's bound."""
    out = copy.deepcopy(run)
    b = out["params"]["tables"][at]
    out["params"]["tables"][at] = np.float32(b + use * (1e-7 + 2e-4 * abs(b)))
    return out


def test_nudged_params_move_every_element_one_ulp():
    exp = experiment_from_grid_id(4061, base_model=ModelConfig(batchnorm_input=True))
    base = gngf.init_params(exp.model, exp.train.seed, "cpu")
    moved = chip_smoke.nudged_params(exp, 1, torch.device("cpu"))
    ups = 0
    for (name, a), b in zip(base.named_parameters(), moved.parameters()):
        up, down = torch.nextafter(a, a + 1), torch.nextafter(a, a - 1)
        assert torch.all((b == up) | (b == down)), name
        ups += int((b == up).sum())
    n = sum(p.numel() for p in base.parameters())
    assert 0.45 * n < ups < 0.55 * n


def test_within_bound_passes_without_witness():
    ref = _run()
    calls = []
    v = chip_smoke.check_parallel("t", [_moved(ref, 0.9)], ref, False, ("k",), True,
                                  lambda: calls.append(1) or [])
    assert calls == [] and v["envelope_used"] == [None] and 0.85 < v["param_tolerance_used"][0] < 0.95


@pytest.mark.parametrize("rank_use, rank_at, witness, ok", [
    # the single process holds the bound, so must the rank
    (1.5, (0, 3, 1), [0.2, 0.3], False),
    # a nudged run moves the rank's element by 1.8 of the bound: the rank's
    # 1.5 lies inside the runs' range, its 2.5 within the bound of it
    (1.5, (0, 3, 1), [0.2, 1.8], True),
    (2.5, (0, 3, 1), [0.2, 1.8], True),
    # 3.0 is 1.2 of the bound past the range
    (3.0, (0, 3, 1), [0.2, 1.8], False),
    # the nudged runs leave the bound elsewhere, not where the rank does
    (1.5, (1, 6, 0), [0.2, 1.8], False),
])
def test_params_past_bound_held_to_the_runs_range(rank_use, rank_at, witness, ok):
    ref = _run()
    nudged = [_moved(ref, w) for w in witness]
    rank = _moved(ref, rank_use, at=rank_at)
    check = lambda: chip_smoke.check_parallel("t", [rank], ref, False, ("k",), True, lambda: nudged)
    if ok:
        v = check()
        assert v["witness_use"] == pytest.approx(witness, rel=1e-3)
        assert v["envelope_used"][0] == pytest.approx(max(0.0, rank_use - max(witness)), abs=1e-2)
    else:
        with pytest.raises(AssertionError, match="params take"):
            check()


@pytest.mark.parametrize("kw", [dict(losses=(0.5, 0.4, 0.31)),
                                dict(colls=((1.0, 2.0), (1.0, 2.0), (1.0, 3.0))),
                                dict(bn=dict(mean=np.ones(2), var=np.ones(2))),
                                dict(launches=0)],
                         ids=["losses", "collisions", "batchnorm", "launches"])
def test_other_bounds_stay_held_to_the_single_process(kw):
    ref = _run()
    rank = _moved(_run(tables=ref["params"]["tables"].copy(), **kw), 1.5)
    nudged = [_moved(ref, 3.0)]     # the params alone would pass against the runs' range
    with pytest.raises(AssertionError) as err:
        chip_smoke.check_parallel("t", [rank], ref, False, ("k",), True, lambda: nudged)
    assert ("launched no" if "launches" in kw else
            {"losses": "losses", "colls": "collisions", "bn": "BatchNorm"}[next(iter(kw))]
            ) in str(err.value)


def test_bitwise_case_takes_no_witness():
    ref = _run()
    with pytest.raises(AssertionError, match="params take"):
        chip_smoke.check_parallel("t", [_moved(ref, 1e5)], ref, True, ("k",), False,
                                  lambda: [_moved(ref, 1e9)])
