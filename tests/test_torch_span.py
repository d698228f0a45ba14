"""Multi-epoch spans in the port, on the CPU: ``train_step.run_span`` and
``fit(epoch_span=S)`` against one epoch a call, and against the JAX
package's ``fit(epoch_span=S)``; the device-side epoch (constants made once,
``used_slot_presence`` without ``nonzero``).

The sizes are ``tests/test_torch_grid_search.py``'s (grid 4061, T = 32,
HPD [2 -> 8 -> 32], decoder [8 -> 8 -> 3], a seeded 8 x 6 image), on three
routes: the per-row route (that size), the dedup route (a 36-vertex grid,
``hpd_backend="unique_stream"``: the plain versions of K1-K3) and the
vanilla hash. Within the port a span is bitwise one epoch a call: history,
best and final params, checkpoints, final image. Against JAX the slice
tests' tolerances (``tests/test_torch_slice.py``): loss rtol 1e-5,
collisions equal, params atol 1e-5; the integer image equal, and PSNR rtol
1e-6, since its ``int_sq_err`` is an fp32 mean of the integer errors that
XLA and PyTorch sum in different orders (at this size the port's span-1
fit differs from JAX's in PSNR's 7th digit too). The stop cases follow JAX's
documented divergences: a stop epoch inside a span, not its last, logs no
``hist_counts_*``.
"""

import copy
import dataclasses

import numpy as np
import jax
import pytest
import torch

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.data import ImageData as JImageData
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.train.trainer import fit as jax_fit
from collision_handling_in_instantngp_tpu.utils import logging as jlog
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import image_dataset, make_shuffle_permutations
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.ops import dedup
from collision_handling_in_instantngp_tpu_torch.train import train_step as tts
from collision_handling_in_instantngp_tpu_torch.train.optimizer import make_optimizer
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit
from collision_handling_in_instantngp_tpu_torch.utils import checkpoint as ckpt
from collision_handling_in_instantngp_tpu_torch.utils import logging as tlog

SMALL = dict(hash_table_size=32, hpd_hidden=(8,), mlp_hidden=(8,))
ROUTES = {
    "per_row": SMALL,
    "dedup": dict(SMALL, hash_table_size=128, num_levels=2, n_min=2, n_max=4,
                  hpd_backend="unique_stream"),
    "vanilla": dict(SMALL, use_hash_function=True),
}
TIMING = {"seconds", "pixels_per_s", "stats_seconds", "ckpt_seconds", "span_epochs"}
# grid 4061's first 23 epochs at histograms_rate 10 and span 5: counts
# epochs 0, 10, 20 and the last two run alone (JAX's schedule)
SPANS_23 = {**dict.fromkeys(range(1, 6), 5), **dict.fromkeys(range(6, 10), 4),
            **dict.fromkeys(range(11, 16), 5), **dict.fromkeys(range(16, 20), 4)}


def _data():
    img = np.random.default_rng(65535).integers(0, 256, size=(8, 6, 3)).astype(np.uint8)
    data = image_dataset(img, "tiny.png")
    jdata = JImageData(coords=data.coords, targets=data.targets, height=data.height,
                       width=data.width, image=data.image, name=data.name)
    return data, jdata


def _exp(route, tmp=None, **train):
    base_train = tcfg.TrainConfig(save_params=tmp is not None,
                                  checkpoint_dir=str(tmp) if tmp else "weights",
                                  checkpoint_min_interval_s=0.0, histograms_rate=10, **train)
    return tcfg.experiment_from_grid_id(4061, base_model=tcfg.ModelConfig(**ROUTES[route]),
                                        base_train=base_train)


def _jexp(route, **train):
    exp = jcfg.experiment_from_grid_id(4061, base_model=jcfg.ModelConfig(**ROUTES[route]))
    return dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, save_params=False, histograms_rate=10, **train))


def _jax_start(route):
    jexp = _jexp(route)
    jp = jgngf.init_params(jax.random.PRNGKey(jexp.train.seed), jexp.model)
    return gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _state_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _setup(route):
    exp = _exp(route)
    data, _ = _data()
    statics = gngf.make_statics(exp.model)
    shuffled, _ = make_shuffle_permutations(data.num_pixels, exp.train.seed)
    batches = tts.build_epoch_batches(data.coords, data.targets, exp.train.batch_fraction,
                                      shuffled, data.image, exp.model, statics, "cpu")
    params = gngf.init_params(exp.model, exp.train.seed)
    return exp, statics, batches, params


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_span_equals_epochs_one_by_one(route):
    """run_span(n=4) == 4 run_epoch calls, bitwise: every scalar, the last
    image and ids, the params and Adam state; the tracker holds the state
    of the epoch with the least int_sq_err (ties: the later one), Adam's
    step included."""
    exp, statics, batches, start = _setup(route)
    assert (batches.dedup[0] is not None) == (route == "dedup")
    n = 4

    params = copy.deepcopy(start)
    opt = make_optimizer(exp.optimizer, params)
    prev, min_poss = tts.initial_collision_state(exp, statics, "cpu")
    serial, states, steps = [], [], []
    for j in range(n):
        m = tts.run_epoch(params, opt, batches, exp, statics, prev, min_poss,
                          collect_ids=j == n - 1)
        prev = m.collisions_device
        serial.append(m)
        states.append({k: v.clone() for k, v in params.state_dict().items()})
        steps.append(max(float(s["step"]) for s in opt.state.values()))

    params2 = copy.deepcopy(start)
    opt2 = make_optimizer(exp.optimizer, params2)
    prev2, _ = tts.initial_collision_state(exp, statics, "cpu")
    tracker = tts.BestTracker(params2, opt2)
    span, last = tts.run_span(params2, opt2, batches, exp, statics, prev2, min_poss, n, tracker)
    host = span.to_host()
    for j, m in enumerate(serial):
        got = host.epoch(j)
        for name in tts.SCALARS:
            np.testing.assert_array_equal(getattr(got, name), getattr(m, name), err_msg=name)
    assert torch.equal(last.image, serial[-1].image)
    if route != "dedup":
        assert torch.equal(last.ids.rows, serial[-1].ids.rows)
    _state_equal(params, params2)
    for p, p2 in zip(opt.state.values(), opt2.state.values()):
        for k in p:
            assert torch.equal(p[k], p2[k]), k

    errs = [np.float32(m.int_sq_err) for m in serial]
    best = max(j for j in range(n) if errs[j] == min(errs))
    assert int(tracker.epoch) == best
    state, opt_state = tracker.snapshot(best)
    for k, v in states[best].items():
        assert torch.equal(state[k], v), k
    assert {float(s["step"]) for s in opt_state.values()} == {steps[best]}


@pytest.fixture(scope="module")
def span_fits(tmp_path_factory):
    """Per route: the port's fit at span 1 and at span 5, 23 epochs, each
    writing its best checkpoint (checkpoint_min_interval_s 0)."""
    data, _ = _data()
    out = {}
    for route in sorted(ROUTES):
        tmp = tmp_path_factory.mktemp(route)
        out[route] = [fit(_exp(route, tmp / f"s{s}"), data, epochs=23, device="cpu",
                          verbose=False, epoch_span=s, run_name=f"s{s}")
                      for s in (1, 5)]
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fit_span_equals_span_one(span_fits, route):
    one, five = span_fits[route]
    assert one.epochs_run == five.epochs_run == 23
    assert len(one.history) == len(five.history) == 23
    for r1, r5 in zip(one.history, five.history):
        assert set(r5) - TIMING == set(r1) - TIMING
        for k in set(r1) - TIMING:
            assert r1[k] == r5[k], (r1["epoch"], k)
        assert r5.get("span_epochs") == SPANS_23.get(r5["epoch"]), r5["epoch"]
        assert "span_epochs" not in r1
    for k in ("best_psnr", "final_psnr", "final_loss", "stopped_early", "zero_collision_abort"):
        assert getattr(one, k) == getattr(five, k), k
    _state_equal(one.params, five.params)
    _state_equal(one.best_params, five.best_params)
    np.testing.assert_array_equal(one.final_image, five.final_image)
    # the best checkpoint, Adam's moments and count included
    cfg = _exp(route).model
    (t1, o1, b1), (t5, o5, b5) = (ckpt.load_run_checkpoint(r.run_dir, model_cfg=cfg)
                                  for r in (one, five))
    for a, b in ((t1, t5), (o1, o5), (b1, b5)):
        la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def jax_span_fit():
    data, jdata = _data()
    jres = jax_fit(_jexp("per_row"), jdata, epochs=23, verbose=False, epoch_span=5)
    tres = fit(_exp("per_row"), data, epochs=23, device="cpu", verbose=False, epoch_span=5,
               params=_jax_start("per_row"))
    return jres, tres


def test_fit_span_matches_jax(jax_span_fit):
    jres, tres = jax_span_fit
    assert tres.epochs_run == jres.epochs_run == 23
    for ep, (j, t) in enumerate(zip(jres.history, tres.history)):
        np.testing.assert_allclose(t["train_loss"], j["train_loss"], rtol=1e-5, err_msg=f"epoch {ep}")
        np.testing.assert_allclose(t["train_psnr"], j["train_psnr"], rtol=1e-6, err_msg=f"epoch {ep}")
        for l in range(4):
            assert t[f"collisions_level{l}"] == j[f"collisions_level{l}"], (ep, l)
    np.testing.assert_allclose(tres.best_psnr, jres.best_psnr, rtol=1e-6)
    np.testing.assert_array_equal(tres.final_image, jres.final_image)
    jp = jax.tree_util.tree_map(np.asarray, jres.state.params)
    tp = gngf.params_to_numpy(tres.params)
    for a, b in zip(jax.tree_util.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


class _JRows(jlog.NullLogger):
    """JAX rows by step (a NullLogger: no image, no figures)."""

    def __init__(self):
        self.rows = {}

    def log(self, metrics, step=None):
        self.rows[step] = metrics


class _TRows(tlog.NullLogger):
    def __init__(self):
        self.rows = {}

    def log(self, metrics, step=None):
        self.rows[step] = metrics


def _counts_steps(rows):
    return sorted(s for s, r in rows.items() if "hist_counts_level0_counts" in r)


# (model, train, epochs, span): under min_delta 1e9 every epoch after the
# first checked one (epoch 1) "stalls", so at tolerance 2 the stopper fires
# after epoch 3's check and epoch 4 stops, inside the span 1-5; at tolerance
# 3 epoch 5 stops, the span's last. Resolution 1 at T = 256 leaves both
# levels collision-free from JAX's init, so the abort fires at epoch 10,
# inside the span 9-12.
STOPS = {
    "early_stop_mid_span": (SMALL, dict(tolerance=2, min_delta=1e9), 12, 5),
    "early_stop_span_end": (SMALL, dict(tolerance=3, min_delta=1e9), 12, 5),
    "zero_collision_abort": (dict(SMALL, hash_table_size=256, n_min=1, n_max=1, num_levels=2),
                             dict(histograms_rate=100), 20, 4),
}


@pytest.mark.parametrize("case", sorted(STOPS))
def test_stop_inside_a_span_matches_jax(case):
    """epochs_run, the flags and which epochs log hist_counts_* equal JAX's
    fit at the same span (a stop epoch inside a span, not its last, logs
    none), and the port's span-1 fit stops at the same epoch."""
    model, train, epochs, span = STOPS[case]
    data, jdata = _data()
    train = dict(dict(histograms_rate=10), **train)
    jexp = jcfg.experiment_from_grid_id(4061, base_model=jcfg.ModelConfig(**model))
    jexp = dataclasses.replace(jexp, train=dataclasses.replace(jexp.train, save_params=False,
                                                               **train))
    texp = tcfg.experiment_from_grid_id(4061, base_model=tcfg.ModelConfig(**model),
                                        base_train=tcfg.TrainConfig(save_params=False, **train))
    jp = jgngf.init_params(jax.random.PRNGKey(jexp.train.seed), jexp.model)
    start = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    jrows, trows, t1rows = _JRows(), _TRows(), _TRows()
    jres = jax_fit(jexp, jdata, epochs=epochs, verbose=False, epoch_span=span, logger=jrows)
    tres = fit(texp, data, epochs=epochs, device="cpu", verbose=False, epoch_span=span,
               params=start, logger=trows)
    one = fit(texp, data, epochs=epochs, device="cpu", verbose=False, params=start,
              logger=t1rows)
    for k in ("epochs_run", "stopped_early", "zero_collision_abort"):
        assert getattr(tres, k) == getattr(jres, k) == getattr(one, k), k
    assert tres.stopped_early and tres.epochs_run < epochs
    assert tres.zero_collision_abort == (case == "zero_collision_abort")
    assert sorted(trows.rows) == sorted(jrows.rows) == list(range(tres.epochs_run))
    assert _counts_steps(trows.rows) == _counts_steps(jrows.rows)
    stop = tres.epochs_run - 1
    assert (stop in _counts_steps(trows.rows)) == (case == "early_stop_span_end")
    assert stop in _counts_steps(t1rows.rows)


def _presence_nonzero(idx_unique, counts, t):
    """The former form: a nonzero of the occupied (l, v), then a scatter."""
    u, k = idx_unique.shape
    l_ids, v_ids = torch.nonzero(counts > 0, as_tuple=True)
    presence = torch.zeros(counts.shape[0], k, t, dtype=torch.bool)
    presence[l_ids[:, None], torch.arange(k)[None, :], idx_unique[v_ids].long()] = True
    return presence


@pytest.mark.parametrize("fill", ["random", "zero"])
def test_used_slot_presence_equals_nonzero_form(fill):
    rng = np.random.default_rng(7)
    u, k, t, l = 500, 4, 256, 5
    idx = torch.as_tensor(rng.integers(0, t, size=(u, k)).astype(np.int32))
    counts = rng.integers(0, 3, size=(l, u)).astype(np.float32) * (rng.random((l, u)) < 0.4)
    if fill == "zero":
        counts[:] = 0
    counts = torch.as_tensor(counts)
    got = dedup.used_slot_presence(idx, counts, t)
    assert got.shape == (l, k, t) and got.dtype == torch.bool
    assert torch.equal(got, _presence_nonzero(idx, counts, t))
    assert bool(got.any()) == (fill == "random")


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_epoch_copies_nothing_from_the_host(route, monkeypatch):
    """After the first epoch, neither forward nor run_epoch makes a tensor
    from a numpy array (on the card each such copy waits for the device)."""
    exp, statics, batches, params = _setup(route)
    opt = make_optimizer(exp.optimizer, params)
    prev, min_poss = tts.initial_collision_state(exp, statics, "cpu")
    prev = tts.run_epoch(params, opt, batches, exp, statics, prev, min_poss).collisions_device
    made = []
    for name in ("as_tensor", "tensor", "from_numpy"):
        real = getattr(torch, name)

        def spy(*args, _real=real, _name=name, **kw):
            if args and isinstance(args[0], np.ndarray):
                made.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(torch, name, spy)
    m = tts.run_epoch(params, opt, batches, exp, statics, prev, min_poss)
    tts.run_span(params, opt, batches, exp, statics, m.collisions_device, min_poss, 2)
    gngf.forward(params, batches.x[0], exp.model, statics, dedup=batches.dedup[0])
    assert made == []
