"""The port's CUDA kernels on the card, against their plain PyTorch versions
on the same inputs, at small shapes that reach the kernels' edges (ragged
row tiles, T not a multiple of 2048, K up to 16, other hidden stacks).

Needs an NVIDIA GPU and nvcc; elsewhere every test skips. This file imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances at 'highest' (normwise: max |kernel - plain| <= tol * max |plain|;
fp32 both sides, only the summation order differs): forward 1e-5,
gradients 1e-4, top-K indices exactly equal. At 'high' and 'default' a
1-ulp input difference can move a bf16 hi/lo split, so those modes are
held to 1e-3 and 1e-2.
"""

import math

import numpy as np
import pytest
import torch

from collision_handling_in_instantngp_tpu_torch import cli
from collision_handling_in_instantngp_tpu_torch.config import ModelConfig, experiment_from_grid_id
from collision_handling_in_instantngp_tpu_torch.data import image_dataset
from collision_handling_in_instantngp_tpu_torch.models import gngf
from collision_handling_in_instantngp_tpu_torch.ops.cuda import hidden, hpd_stream
from collision_handling_in_instantngp_tpu_torch.train.trainer import fit

pytestmark = pytest.mark.cuda
TOL = {"highest": (1e-5, 1e-4), "high": (1e-3, 1e-3), "default": (1e-2, 1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, ref, tol, name=""):
    err = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    assert torch.isfinite(got).all(), name
    assert err <= tol * max(scale, 1e-30), f"{name}: {err} > {tol} * {scale}"


def _tail_inputs(dev, u, t, l, k, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return dict(
        h=f32(rng.random((u, 128)) * 0.2),
        w=f32(rng.standard_normal((128, t)) * 0.3),
        b=f32(rng.standard_normal(t) * 0.1),
        counts=f32(rng.integers(0, 5, size=(l, u))),
        g_marg=f32(rng.standard_normal((l, t))),
        g_vals=f32(rng.standard_normal((u, k))),
    )


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
# (200, 128, 2, 16): 8 columns per per-thread sub-stream, fewer than K
@pytest.mark.parametrize("u,t,l,k", [(300, 256, 3, 1), (300, 2048, 16, 4), (1000, 384, 5, 16),
                                     (200, 128, 2, 16)])
def test_tail_kernels_match_plain(dev, u, t, l, k, precision):
    x = _tail_inputs(dev, u, t, l, k)
    args = (x["h"], x["w"], x["b"], x["counts"], k, precision)
    out = hpd_stream.hpd_stream_fused_fwd(*args)
    ref = hpd_stream.hpd_stream_fused_fwd_plain(*args)
    fwd_tol, grad_tol = TOL[precision]
    if precision == "highest":
        assert torch.equal(out[2], ref[2])
    for name, a, r in zip(("marg", "vals", "m", "s"), (out[0], out[1], *out[3:]),
                          (ref[0], ref[1], *ref[3:])):
        _close(a, r, fwd_tol, name)
    _, vals, idx, m, s = ref
    for noop in (False, True):
        bargs = (x["h"], x["w"], x["b"], x["counts"], idx, vals, m, s, x["g_marg"],
                 x["g_vals"], k, precision, noop)
        got = hpd_stream.hpd_stream_fused_bwd(*bargs)
        want = hpd_stream.hpd_stream_fused_bwd_plain(*bargs)
        for name, a, r in zip(("dh", "dw", "db"), got, want):
            _close(a, r, grad_tol, f"{name} noop={noop}")


def test_tail_kernels_are_bitwise_stable(dev):
    x = _tail_inputs(dev, 700, 512, 4, 4)
    args = (x["h"], x["w"], x["b"], x["counts"], 4)
    first, second = hpd_stream.hpd_stream_fused_fwd(*args), hpd_stream.hpd_stream_fused_fwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _, vals, idx, m, s = first
    bargs = (*args[:4], idx, vals, m, s, x["g_marg"], x["g_vals"], 4)
    first, second = hpd_stream.hpd_stream_fused_bwd(*bargs), hpd_stream.hpd_stream_fused_bwd(*bargs)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_tail_planted_tie_selects_lowest_index(dev):
    x = _tail_inputs(dev, 64, 2048, 2, 4)
    w, b = x["w"], x["b"]
    hi, lo = 1500, 37
    w[:, hi] = w[:, lo] = w.abs().amax(dim=1) * 3.0
    b[hi] = b[lo] = 1.0
    _, vals, idx, _, _ = hpd_stream.hpd_stream_fused_fwd(x["h"], w, b, x["counts"], 4)
    assert (idx[:, 0] == lo).all() and (idx[:, 1] == hi).all()
    assert torch.equal(vals[:, 0], vals[:, 1])


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("widths", [(2, 32, 64, 128), (8, 128), (3, 16, 24, 40, 96)])
def test_hidden_kernels_match_plain(dev, widths, precision):
    rng = np.random.default_rng(1)
    u = 1000
    x = torch.as_tensor(rng.integers(0, 514, size=(u, widths[0])).astype(np.float32), device=dev)
    layers = [
        (torch.as_tensor(rng.uniform(-1, 1, (a, c)).astype(np.float32) / math.sqrt(a), device=dev),
         torch.as_tensor(rng.uniform(-0.1, 0.1, c).astype(np.float32), device=dev))
        for a, c in zip(widths[:-1], widths[1:])
    ]
    gh = torch.as_tensor(rng.standard_normal((u, widths[-1])).astype(np.float32) * 1e-3, device=dev)
    fwd_tol, grad_tol = TOL[precision]
    _close(hidden.hidden_stack_fwd(x, layers, precision),
           hidden.hidden_stack_fwd_plain(x, layers, precision), fwd_tol, "h")
    got = hidden.hidden_stack_bwd(x, layers, gh, precision)
    again = hidden.hidden_stack_bwd(x, layers, gh, precision)
    want = hidden.hidden_stack_bwd_plain(x, layers, gh, precision)
    for i, ((dw, db), (dw2, db2), (rw, rb)) in enumerate(zip(got, again, want)):
        assert torch.equal(dw, dw2) and torch.equal(db, db2), i
        _close(dw, rw, grad_tol, f"dW{i}")
        _close(db, rb, grad_tol, f"db{i}")


def test_wrappers_count_launches_and_refuse_shapes(dev):
    x = _tail_inputs(dev, 100, 256, 2, 4)
    before = hpd_stream.hpd_stream_fused_fwd.launches
    hpd_stream.hpd_stream_fused_fwd(x["h"], x["w"], x["b"], x["counts"], 4)
    assert hpd_stream.hpd_stream_fused_fwd.launches == before + 1
    with pytest.raises(ValueError):
        hpd_stream.hpd_stream_fused_fwd(x["h"], x["w"][:, :200], x["b"][:200], x["counts"], 4)
    with pytest.raises(ValueError):
        hpd_stream.hpd_stream_fused_fwd(x["h"], x["w"], x["b"], x["counts"].cpu(), 4)
    assert hpd_stream.hpd_stream_fused_fwd.launches == before + 1


# "stream": a small geometry on the streamed tail (the kernels); "dense":
# the CLI's default grid-4061 geometry (T=2^8, 4 levels; no kernel)
GEOMETRIES = {
    "stream": dict(hash_table_size=2048, num_levels=4, n_min=8, n_max=48,
                   hpd_backend="unique_stream"),
    "dense": {},
}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_training_on_card_matches_cpu(dev, geometry):
    """Two epochs on the card and on the CPU (plain versions), same start;
    losses agree to rtol 1e-4."""
    exp = experiment_from_grid_id(4061, base_model=ModelConfig(**GEOMETRIES[geometry]))
    img = np.random.default_rng(65535).integers(0, 256, size=(24, 20, 3)).astype(np.uint8)
    data = image_dataset(img, "synthetic")
    start = gngf.init_params(exp.model, 0, "cpu")
    before = hpd_stream.hpd_stream_fused_bwd.launches
    card = fit(exp, data, epochs=2, device=dev, params=start, verbose=False)
    assert (hpd_stream.hpd_stream_fused_bwd.launches > before) == (geometry == "stream")
    cpu = fit(exp, data, epochs=2, device="cpu", params=start, verbose=False)
    for a, b in zip(card.history, cpu.history):
        assert math.isclose(a["train_loss"], b["train_loss"], rel_tol=1e-4), (a, b)


def test_cli_runs_on_card(dev, tmp_path, capsys):
    img = np.random.default_rng(0).integers(0, 256, size=(12, 10, 3)).astype(np.uint8)
    np.save(tmp_path / "tiny.npy", img)
    assert cli.main(["-f", "tiny.npy", "--images_dir", str(tmp_path), "-s", "4061",
                     "--epochs", "2"]) == 0
    assert "grid 4061: best PSNR" in capsys.readouterr().out
