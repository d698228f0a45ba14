"""The port's ``tools/roofline.py`` against the JAX package's, and
``fit(compact_dedup=False)`` against the JAX ``fit``, on the CPU.

* ``epoch_ledger``: every term the two tools share is equal, for grid 4061
  at the default geometry and at ``instantngp_scaled_model()`` with 1/3
  batches; the table gradient is the port's own count (K12's rows read and
  added, the table written), in place of JAX's one-hot product; the
  compacted row count is the one the JAX ``build_epoch_batches`` gives.
* ``kernel_work``: each kernel's bound equals its formula (the operations at
  the unit's published peak against the bytes at 3.35 TB/s) at the shapes
  ``chip_smoke.py`` gives it.
* ``fit(compact_dedup=False)`` on the small streamed geometry where the
  compaction engages: losses rtol 1e-5, PSNR and collisions equal, params
  atol 1e-5 (``test_torch_slice.py``'s tolerances).
"""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from collision_handling_in_instantngp_tpu import config as jcfg
from collision_handling_in_instantngp_tpu.data import ImageData as JImageData
from collision_handling_in_instantngp_tpu.data import load_image_dataset as jax_load_dataset
from collision_handling_in_instantngp_tpu.data import make_shuffle_permutations as jax_perms
from collision_handling_in_instantngp_tpu.models import gngf as jgngf
from collision_handling_in_instantngp_tpu.train.train_step import (
    build_epoch_batches as jax_build_epoch_batches,
)
from collision_handling_in_instantngp_tpu.train.trainer import fit as jax_fit
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.data import image_dataset, load_image_dataset
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.tools import roofline
from collision_handling_in_instantngp_tpu_torch.train.train_step import build_epoch_batches
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TF32, BF16, FP32, HBM = 495e12, 989e12, 67e12, 3.35e12


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_roofline_tool", os.path.join(REPO, "tools", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_exp(mode):
    exp = jcfg.experiment_from_grid_id(4061)
    if mode == "scaled":
        exp = dataclasses.replace(exp, model=jcfg.instantngp_scaled_model(),
                                  train=dataclasses.replace(exp.train, batch_fraction=1 / 3))
    return exp


@pytest.fixture(scope="module")
def strawberry():
    return load_image_dataset(os.path.join(REPO, "images", "strawberry.npy"))


def _jax_u_compact(exp):
    """The compacted row count of the JAX ``build_epoch_batches`` (None
    where it keeps the shared grid)."""
    data = jax_load_dataset(os.path.join(REPO, "images", "strawberry.jpeg"))
    shuffled, _ = jax_perms(data.num_pixels, exp.train.seed, True)
    b = jax_build_epoch_batches(data.coords, data.targets, exp.train.batch_fraction, shuffled,
                                data.image, model_cfg=exp.model,
                                statics=jgngf.make_statics(exp.model))
    return None if b.dedup_active is None else int(b.dedup_active.shape[1])


@pytest.mark.parametrize("mode", ["gngf", "scaled"])
def test_epoch_ledger_matches_jax(mode, strawberry):
    texp, jexp = roofline.experiment(mode), _jax_exp(mode)
    u_c = roofline.compacted_rows(texp, strawberry)
    assert u_c == _jax_u_compact(jexp)
    assert (u_c is None) == (mode == "gngf")       # the 4061 grid is 89 % touched
    t = roofline.epoch_ledger(texp, strawberry.num_pixels, u_compact=u_c)
    j = _jax_tool().epoch_ledger(jexp, strawberry.num_pixels, u_compact=u_c)
    for key in ("unique_vertices", "rows_per_batch", "num_batches"):
        assert t[key] == j[key], key
    m, nb, u = texp.model, t["num_batches"], t["unique_vertices"]
    l, k, tt, f = m.num_levels, m.topk_k, m.hash_table_size, m.feature_dim
    # JAX's one-hot table gradient (2 L U T F flops a batch), not run by the port
    assert t["matmul_flops"] == j["matmul_flops"] - nb * 2 * l * u * tt * f
    grad = t["terms"]["table_grad"]
    assert grad == {"vpu_flops": nb * u * k * l * f, "hbm_bytes": nb * 4 * (u * k * l * f + l * tt * f)}
    assert t["vpu_flops"] == j["vpu_flops"] + grad["vpu_flops"]
    assert t["hbm_bytes"] == j["hbm_bytes"] + grad["hbm_bytes"]
    for key in ("matmul_flops", "kernel_matmul_flops", "vpu_flops"):
        assert sum(term.get(key, 0) for term in t["terms"].values()) == t[key]
    # the kernels' products: none on the dense route at 4061's geometry; at
    # --scaled the HPD (K3, K1/K2) and the marginal, all but the decoder's
    dense = t["terms"]["decoder"]["matmul_flops"] if mode == "scaled" else t["matmul_flops"]
    assert t["kernel_matmul_flops"] == t["matmul_flops"] - dense
    assert (sum(term.get("hbm_bytes", 0) for term in t["terms"].values())
            + 4 * strawberry.num_pixels * m.out_channels * 2 == t["hbm_bytes"])


def test_scaled_bound_and_fraction(strawberry):
    """At --scaled, 'highest': about 6.4e12 product flops an epoch, the
    kernels' as 3xTF32 at 495 / 3 TFLOP/s, cuBLAS's (the decoder) as fp32
    at 67; a bound near 40 ms, products bound."""
    exp = roofline.experiment("scaled")
    ledger = roofline.epoch_ledger(exp, strawberry.num_pixels,
                                   roofline.compacted_rows(exp, strawberry))
    assert 6.3e12 < ledger["matmul_flops"] < 6.5e12
    kernels = ledger["kernel_matmul_flops"]
    library = ledger["matmul_flops"] - kernels
    peaks = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    sol = roofline.sol(ledger, "highest", peaks)
    assert sol["sol_bound"] == "compute"
    assert (sol["kernel_matmul_rate"], sol["library_matmul_rate"]) == (TF32 / 3, FP32)
    assert sol["sol_epoch_ms"] == pytest.approx(
        1e3 * (kernels / (TF32 / 3) + library / FP32 + ledger["vpu_flops"] / FP32))
    assert 35 < sol["sol_epoch_ms"] < 45
    high = roofline.sol(ledger, "high", peaks)
    assert high["kernel_matmul_rate"] == high["library_matmul_rate"] == BF16 / 3
    measured = {"highest": 46e12, "hbm_stream": 3.16e12}
    cal = roofline.sol(ledger, "highest", peaks, measured)
    assert (cal["kernel_matmul_rate"], cal["library_matmul_rate"]) == (TF32 / 3, 46e12)
    assert cal["sol_epoch_ms"] > sol["sol_epoch_ms"]


def test_gngf_bound_prices_cublas_at_the_fp32_rate(strawberry):
    """At 4061's default geometry every product runs in cuBLAS (the dense
    HPD, its marginal, the decoder): at 'highest' fp32 SGEMM at 67 TFLOP/s,
    not 3xTF32."""
    exp = roofline.experiment("gngf")
    ledger = roofline.epoch_ledger(exp, strawberry.num_pixels)
    assert ledger["kernel_matmul_flops"] == 0
    sol = roofline.sol(ledger, "highest", roofline.PEAKS["NVIDIA H100 80GB HBM3"])
    assert sol["sol_matmul_ms"] == pytest.approx(1e3 * ledger["matmul_flops"] / FP32)
    assert sol["sol_epoch_ms"] == pytest.approx(
        1e3 * (ledger["matmul_flops"] + ledger["vpu_flops"]) / FP32)


def test_compacted_rows_follow_the_flag(strawberry):
    exp = roofline.experiment("scaled")
    assert roofline.compacted_rows(exp, strawberry) == 161_792
    assert roofline.compacted_rows(exp, strawberry, compact_dedup=False) is None


def _b(ops, nbytes, peak):
    t_ops, t_bytes = ops / peak, nbytes / HBM
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def test_kernel_work_bounds_at_the_smoke_shapes():
    u, H, T, L, k = 161_792, 128, 16_384, 16, 4
    ints = torch.ones(L, u)
    frac = torch.full((L, u), 0.5)

    def check(name, want, **shapes):
        got = roofline.kernel_work(name, **shapes)
        assert (got["bound_ms"], got["bound_by"]) == pytest.approx(want, rel=1e-12), name
        return got

    f = 2.0 * u * H * T
    k1 = 4.0 * (u * H + H * T + T + L * u + L * T + 2 * u * k + 2 * u)
    got = check("K1", _b(3 * f + 2 * 2.0 * L * u * T, k1, TF32), u=u, h=H, t=T, l=L, k=k, counts=ints)
    assert got["bound_fp32_ms"] == pytest.approx(_b(f + 2.0 * L * u * T, k1, FP32)[0])
    assert got["bound_ms"] == pytest.approx(4.455486275749495, rel=1e-12)   # the smoke's K1
    check("K1", _b(3 * f + 3 * 2.0 * L * u * T, k1, TF32), u=u, h=H, t=T, l=L, k=k, counts=frac)
    bwd = 6.0 * u * H * T + 4.0 * L * u * T
    bwd_bytes = 4.0 * (2 * u * H + 2 * H * T + 2 * T + L * u + 3 * u * k + 2 * u + L * T)
    for name in ("K2", "K6"):
        got = check(name, _b(3 * bwd, bwd_bytes, TF32), u=u, h=H, t=T, l=L, k=k)
        assert got["bound_fp32_ms"] == pytest.approx(_b(bwd, bwd_bytes, FP32)[0])
    assert roofline.kernel_work("K2", u=u, h=H, t=T, l=L, k=k)["bound_ms"] == pytest.approx(
        13.366458827248485, rel=1e-12)
    check("K4", _b(3 * f, 4.0 * (u * H + 2 * u * k + 2 * u) + 4.0 * (H * T + T), TF32),
          u=u, h=H, t=T, k=k)
    check("K5", _b(3 * f + 3 * 2.0 * L * u * T,
                   4.0 * (u * H + L * u + 2 * u + L * T) + 4.0 * (H * T + T), TF32),
          u=u, h=H, t=T, l=L, k=k, counts=frac)
    check("K7", _b(3 * f, 4.0 * (u * H + H * T + T + 2 * u), TF32), u=u, h=H, t=T)
    widths = (2, 32, 64, 128)
    mac, dmac = 2 * 32 + 32 * 64 + 64 * 128, 32 * 64 + 64 * 128
    n_params = mac + 32 + 64 + 128
    check("K3a", _b(3 * 2.0 * u * mac, 4.0 * (u * 2 + u * 128 + n_params), TF32), u=u, widths=widths)
    check("K3b", _b(3 * 2.0 * u * (2 * mac + dmac), 4.0 * (u * 2 + u * 128 + 2 * n_params), TF32),
          u=u, widths=widths)
    n, c = u * k, L * 2
    check("K12", _b(1.0 * n * c, 4.0 * (n * c + T * c) + 8 * n, FP32), n=n, c=c, t=T)
    # over a slot range: the rows in range read and added, every id read
    check("K12", _b(1.0 * n * c, 4.0 * (n * c + T * c) + 8 * 3 * n, FP32), n=n, c=c, t=T, ids=3 * n)
    # the per-row route's batch 0: 918,464 rows at T = 256, the default stack
    rows, t2, stack = 918_464, 256, (2, 32, 64, 128, 256)
    head = 2.0 * rows * 128 * t2
    macs = sum(a * b for a, b in zip(stack[:-1], stack[1:]))
    dx = sum(a * b for a, b in zip(stack[1:-1], stack[2:]))
    params = macs + sum(stack[1:])
    out = 4.0 * (4 * t2 + 2 * rows * k)
    check("K8", _b(head, 4.0 * rows * 128 + 4.0 * (128 * t2 + t2) + out, FP32),
          rows=rows, h=128, t=t2, l=4, k=k)
    check("K9", _b(9 * head, 4.0 * (2 * rows * 128 + 2 * 128 * t2 + 2 * t2 + 4 * t2 + 2 * rows * k),
                   TF32), rows=rows, h=128, t=t2, l=4, k=k)
    fwd_ops = 3 * head / TF32 + (2.0 * rows * macs - head) / FP32
    fwd_bytes = 4.0 * (rows * 2 + params) + out
    check("K10", (1e3 * max(fwd_ops, fwd_bytes / HBM), "operations"), rows=rows, widths=stack, l=4, k=k)
    # K11: the replay of the hidden stack as fp32, every other product
    # (the head's three, the hidden layers' dW and dh) as 3xTF32
    replay = 2.0 * rows * macs - head
    bwd_ops = 3 * (2.0 * rows * (2 * macs + dx) - replay) / TF32 + replay / FP32
    bwd_bytes = 4.0 * (rows * 2 + 2 * params + 4 * t2 + 2 * rows * k)
    check("K11", (1e3 * max(bwd_ops, bwd_bytes / HBM), "operations"), rows=rows, widths=stack,
          l=4, k=k)
    U2 = 162_304
    check("K13", _b(2.0 * U2 * H * T, 4.0 * (U2 * H + H * T + U2), FP32), u=U2, h=H, t=T,
          regime="highest")
    check("K13", _b(3 * 2.0 * U2 * H * T, 4.0 * (U2 * H + H * T + U2), BF16), u=U2, h=H, t=T,
          regime="bf16x3")
    nbytes = 4.0 * U2 * (T // 4)
    check("K14", _b(0.0, nbytes, FP32), nbytes=nbytes)
    check("K15", _b(0.0, 2 * nbytes, FP32), nbytes=nbytes)
    with pytest.raises(ValueError, match="unknown kernel"):
        roofline.kernel_work("K99")


def test_roofline_tool_on_the_cpu(capsys, strawberry):
    """``--device cpu`` counts and times the plain versions and reports no
    bound (the peaks are the card's); without a card the default raises."""
    out = roofline.main(["--device", "cpu", "--mode", "gngf", "--measure", "--span", "2",
                         "--epochs", "2"])
    assert out["device_kind"] == "cpu" and "sol_epoch_ms" not in out
    assert "fraction_of_roofline" not in out and out["measured_epoch_ms"] > 0
    assert capsys.readouterr().out.strip().startswith('{"mode": "gngf"')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            roofline.main(["--mode", "gngf"])


# ----------------------- fit(compact_dedup=False) -------------------------- #
STREAM = dict(hash_table_size=2048, num_levels=4, n_min=8, n_max=48,
              hpd_backend="unique_stream", mlp_hidden=(16,))
EPOCHS = 3


def _image():
    return np.random.default_rng(65535).integers(0, 256, size=(24, 20, 3)).astype(np.uint8)


def test_uncompacted_batches_keep_the_whole_grid():
    texp = tcfg.experiment_from_grid_id(4061, base_model=tcfg.ModelConfig(**STREAM))
    data = image_dataset(_image(), "synthetic")
    statics = gngf.make_statics(texp.model)
    perm = np.arange(data.num_pixels, dtype=np.int32)
    args = (data.coords, data.targets, texp.train.batch_fraction, perm, data.image, texp.model,
            statics, "cpu")
    u = statics.unique_coords.shape[0]
    compact = build_epoch_batches(*args)
    whole = build_epoch_batches(*args, compact_dedup=False)
    assert all(g.active is not None and g.counts.shape[1] < u for g in compact.dedup)
    assert all(g.active is None and g.counts.shape[1] == u for g in whole.dedup)


@pytest.fixture(scope="module")
def uncompacted_runs():
    jexp = jcfg.experiment_from_grid_id(4061, base_model=jcfg.ModelConfig(**STREAM))
    jexp = dataclasses.replace(jexp, train=dataclasses.replace(jexp.train, save_params=False))
    texp = tcfg.experiment_from_grid_id(4061, base_model=tcfg.ModelConfig(**STREAM),
                                        base_train=tcfg.TrainConfig(save_params=False))
    data = image_dataset(_image(), "synthetic")
    jdata = JImageData(coords=data.coords, targets=data.targets, height=data.height,
                       width=data.width, image=data.image, name=data.name)
    jparams = jgngf.init_params(jax.random.PRNGKey(jexp.train.seed), jexp.model)
    start = gngf.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jres = jax_fit(jexp, jdata, epochs=EPOCHS, verbose=False, compact_dedup=False)
    tres = fit(texp, data, epochs=EPOCHS, device="cpu", params=start, verbose=False,
               compact_dedup=False)
    return texp, jres, tres


def test_fit_uncompacted_epochs_match_jax(uncompacted_runs):
    texp, jres, tres = uncompacted_runs
    assert len(tres.history) == len(jres.history) == EPOCHS
    for ep, (j, t) in enumerate(zip(jres.history, tres.history)):
        np.testing.assert_allclose(t["train_loss"], j["train_loss"], rtol=1e-5, err_msg=f"epoch {ep}")
        assert t["train_psnr"] == j["train_psnr"], ep
        for lv in range(texp.model.num_levels):
            assert t[f"collisions_level{lv}"] == j[f"collisions_level{lv}"], (ep, lv)


def test_fit_uncompacted_params_match_jax(uncompacted_runs):
    _, jres, tres = uncompacted_runs
    jp = jax.tree_util.tree_map(np.asarray, jres.state.params)
    tp = gngf.params_to_numpy(tres.params)
    np.testing.assert_allclose(tp["tables"], jp["tables"], rtol=0, atol=1e-5)
    for group in ("hpd", "mlp"):
        for i, (a, b) in enumerate(zip(tp[group], jp[group])):
            for key in ("w", "b"):
                np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-5,
                                           err_msg=f"{group}[{i}].{key}")
