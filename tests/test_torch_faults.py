"""The port's repaired faults against the reference, on the CPU: the
grayscale load of a ``.npy`` image, the CLI's omitted ``-e``, ``fit``
acting on ``save_params`` and ``histograms_rate`` (it once only warned),
and the fixed-order table gradients of the encoding's gathers.
"""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from collision_handling_in_instantngp_tpu.data import load_image as jax_load_image
from collision_handling_in_instantngp_tpu_torch import cli, config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import image_dataset, load_image, rgb_to_gray
from collision_handling_in_instantngp_tpu_torch.train import trainer
from collision_handling_in_instantngp_tpu_torch.utils.logging import MetricLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bw_npy_equals_jax_bw_jpeg():
    """The port's grayscale ``.npy`` load equals the JAX package's grayscale
    decode of the same image (cv2; the JAX loader's PIL fallback weighs
    the channels differently)."""
    pytest.importorskip("cv2")
    npy = load_image(os.path.join(REPO, "images", "strawberry.npy"), bw=True)
    ref = jax_load_image(os.path.join(REPO, "images", "strawberry.jpeg"), bw=True)
    assert npy.dtype == np.uint8 and npy.shape == ref.shape == (508, 339)
    np.testing.assert_array_equal(npy, ref)


def test_gray_formula_equals_cv2_on_every_colour():
    """rgb_to_gray equals cv2's RGB2GRAY on all 2^24 8-bit colours, laid out
    as one 4096 x 4096 image."""
    cv2 = pytest.importorskip("cv2")
    code = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(code >> 16) & 255, (code >> 8) & 255, code & 255], axis=-1)
    rgb = rgb.astype(np.uint8).reshape(4096, 4096, 3)
    del code
    np.testing.assert_array_equal(rgb_to_gray(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


def _record_fit_ids(monkeypatch):
    ids = []

    def fake_fit(exp, data, **kw):
        ids.append(exp.grid_id)
        return trainer.FitResult(0.0, 0.0, 0.0, 0, False, False, None, None, [])

    monkeypatch.setattr(trainer, "fit", fake_fit)
    return ids


def test_cli_without_end_id_runs_through_the_last_grid_id(tmp_path, monkeypatch):
    """An omitted ``-e`` means the last id of the grid (the JAX CLI passes
    None and its grid driver runs start through 47,999)."""
    np.save(tmp_path / "tiny.npy", np.zeros((4, 4, 3), np.uint8))
    monkeypatch.chdir(tmp_path)           # each id's JSONL log
    ids = _record_fit_ids(monkeypatch)
    last = len(tcfg.get_grid_search_configs()) - 1
    assert last == 47999
    assert cli.main(["-f", "tiny.npy", "--images_dir", str(tmp_path), "-s", str(last - 2),
                     "--device", "cpu"]) == 0
    assert ids == [last - 2, last - 1, last]
    ids.clear()
    assert cli.main(["-f", "tiny.npy", "--images_dir", str(tmp_path), "-s", "4061", "-e", "4061",
                     "--device", "cpu"]) == 0
    assert ids == [4061]
    ids.clear()
    for bad in (["-s", str(last), "-e", str(last + 1)], ["-s", str(last + 1)], ["-s", "5", "-e", "4"]):
        with pytest.raises(ValueError, match="grid ids"):
            cli.main(["-f", "tiny.npy", "--images_dir", str(tmp_path), *bad, "--device", "cpu"])
    assert ids == []


def test_fit_warns_once_about_ignored_fields(monkeypatch, tmp_path):
    """fit once warned that it ignored save_params and histograms_rate; it
    now acts on both and warns nothing: the default config writes the
    best-PSNR checkpoint and logs the slot counts of its counts epochs
    (epoch 0 and the last), and a config that asks for neither gets
    neither."""
    monkeypatch.chdir(tmp_path)           # the default checkpoint_dir, "weights"
    img = np.random.default_rng(0).integers(0, 256, size=(6, 5, 3)).astype(np.uint8)
    data = image_dataset(img)
    exp = tcfg.experiment_from_grid_id(4061)
    assert exp.train.save_params and exp.train.histograms_rate > 0
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = trainer.fit(exp, data, epochs=2, device="cpu", verbose=False)
    assert not [w for w in rec if issubclass(w.category, UserWarning)], [str(w.message) for w in rec]
    assert res.run_dir.startswith(os.path.join("weights", "4061_"))
    assert os.path.exists(os.path.join(res.run_dir, "whole_opt.pkl"))
    assert not hasattr(trainer, "_warn_ignored_fields")

    quiet = dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, save_params=False, histograms_rate=0))
    rows = []

    class Rows(MetricLogger):
        def log(self, metrics, step=None):
            rows.append(metrics)

    with warnings.catch_warnings(record=True) as none:
        warnings.simplefilter("always")
        res = trainer.fit(quiet, data, epochs=2, device="cpu", verbose=False, logger=Rows())
    assert not [w for w in none if issubclass(w.category, UserWarning)]
    assert res.run_dir is None
    # without histograms_rate only the last epoch is a counts epoch
    assert [any(k.startswith("hist_counts_level") for k in r) for r in rows] == [False, True]


def _serial_sum(g, flat, slots):
    """dt[t] = sum of g[n] over n with flat[n] = t, added one row at a time
    in ascending n, in float32."""
    out = np.zeros((slots, g.shape[1]), np.float32)
    for n, t in enumerate(flat):
        out[t] += g[n]
    return out


@pytest.mark.parametrize("gather", ["gather_rows", "blend_unique", "lookup_topk_blend"])
def test_table_gradients_fixed_order(gather, monkeypatch):
    """The encoding's gathers take their table gradient from the serial
    row-order sum (``scatter_add_serial``, K12 on the card): allclose to
    the JAX package's gradient, bitwise equal to the row-order sum, and
    bitwise equal run to run. Many rows share a slot (a hot slot as at
    random init)."""
    import jax
    import jax.numpy as jnp
    from collision_handling_in_instantngp_tpu import config as jcfg
    from collision_handling_in_instantngp_tpu.models import encoding as jenc
    from collision_handling_in_instantngp_tpu_torch.models import encoding
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import scatter

    calls = []

    def counted(rows, idx, t, **kw):
        calls.append(tuple(rows.shape))
        return scatter.scatter_add_serial(rows, idx, t, **kw)

    monkeypatch.setattr(encoding, "scatter_add_serial", counted)
    rng = np.random.default_rng(11)
    l, t, f, u, k, p = 3, 64, 2, 40, 4, 300
    hot = lambda size, n: np.where(rng.random(size) < 0.5, 5, rng.integers(0, n, size=size))
    tables = rng.standard_normal((l, t, f)).astype(np.float32)
    tcfg_, jcfg_ = tcfg.ModelConfig(), jcfg.ModelConfig()
    if gather == "gather_rows":
        table = rng.standard_normal((l, u, f)).astype(np.float32)
        ids = hot((p, l, 4), u).astype(np.int32)
        g = rng.standard_normal((p, l, 4, f)).astype(np.float32)
        t_fn = lambda tab: encoding.gather_rows(tab, torch.from_numpy(ids))
        j_fn = lambda tab: jenc.gather_rows(tab, jnp.asarray(ids))
        flat = (ids + np.arange(l)[None, :, None] * u).reshape(-1)
        rows_g, slots = g.reshape(-1, f), l * u
    elif gather == "blend_unique":
        table = tables
        idx = np.stack([rng.permutation(t)[:k] for _ in range(u)]).astype(np.int32)
        idx[::2, 0] = 5
        vals = (rng.random((u, k)) + 0.1).astype(np.float32)
        g = rng.standard_normal((l, u, f)).astype(np.float32)
        t_fn = lambda tab: encoding.blend_unique(tab, torch.from_numpy(idx), torch.from_numpy(vals), tcfg_)
        j_fn = lambda tab: jenc.blend_unique(tab, jnp.asarray(idx), jnp.asarray(vals), jcfg_)
        # rows (u, k) of the (T, L * F) view, each scaled by its blend weight
        w = encoding.blend_weights(torch.from_numpy(vals), tcfg_).numpy()
        flat = idx.reshape(-1)
        rows_g = (w[:, :, None] * g.transpose(1, 0, 2).reshape(u, 1, l * f)).reshape(-1, l * f)
        slots = t
    else:
        table = tables
        idx = hot((p, l, 4, k), t).astype(np.int32)
        vals = (rng.random((p, l, 4, k)) + 0.1).astype(np.float32)
        g = rng.standard_normal((p, l, 4, f)).astype(np.float32)
        t_fn = lambda tab: encoding.lookup_topk_blend(tab, torch.from_numpy(idx), torch.from_numpy(vals), tcfg_)
        j_fn = lambda tab: jenc.lookup_topk_blend(tab, jnp.asarray(idx), jnp.asarray(vals), jcfg_)
        flat = (idx + np.arange(l)[None, :, None, None] * t).reshape(-1)
        w = encoding.blend_weights(torch.from_numpy(vals), tcfg_).numpy()
        rows_g = (w[..., None] * g[:, :, :, None, :]).reshape(-1, f)
        slots = l * t
    grads = []
    for _ in range(2):
        tt = torch.from_numpy(table.copy()).requires_grad_()
        (t_fn(tt) * torch.from_numpy(g)).sum().backward()
        grads.append(tt.grad)
    assert calls == [(len(flat), rows_g.shape[1])] * 2
    assert torch.equal(grads[0], grads[1])
    ref = jax.grad(lambda tab: jnp.sum(j_fn(tab) * g))(jnp.asarray(table))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    serial = _serial_sum(rows_g, flat, slots)
    if gather == "blend_unique":        # (T, L * F) -> (L, T, F)
        serial = serial.reshape(t, l, f).transpose(1, 0, 2)
    np.testing.assert_array_equal(grads[0].numpy(), serial.reshape(grads[0].shape))
