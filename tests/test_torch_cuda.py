"""The port's CUDA kernels on the card, against their plain PyTorch versions
on the same inputs, at small shapes that reach the kernels' edges (ragged
row tiles, T not a multiple of 2048, K up to 16, other hidden stacks; for
the per-row kernels K8-K11, T from 128 to 2048, K up to 32 (K10/K11) or 128
(K8/K9), ragged N, other stacks; for the split kernels K4-K6, T from 2048
to 65536, L from 1 to 32; for the tail backward on the tensor cores (K2,
K6), T from 2048 to 65536, L 1 to 32, K 1 to 16, all three precisions,
heads of 37 and 100; for
the serial scatter K12, one slot, a 100,000-row slot, empty slots, C = 2
and 32, short and long slots of narrow rows, one rank's slot range of a
table sharded by slot; for the rows pass's guard,
planted ties and near-tie clusters (its fp32 fix-up); for the encoding,
its fixed-order table gradients; for the probes K7 and K13, ragged U and
T from 128 (K13 also U ragged against its 128- and 256-row tiles, H from
16 to 128, exact integer inputs held bit for bit to float64, 'default'
bit for bit 'bf16');
K14/K15 at sizes not a multiple of 4 and from an unaligned address, K14
also at the probe's 2.66 GB; the chunked unique tail of K > 16, no kernel,
against the same call on the CPU at K = 20 and 128), plus training on the
card against the CPU on the dedup route (fused and split) and the per-row
routes.

Needs an NVIDIA GPU and nvcc; elsewhere every test skips. This file imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances at 'highest' (normwise: max |kernel - plain| <= tol * max |plain|;
fp32 both sides, only the summation order differs): forward 1e-5,
gradients 1e-4, top-K indices exactly equal. At 'high' and 'default' a
1-ulp input difference can move a bf16 hi/lo split, so those modes are
held to 1e-3 and 1e-2. The K7 "dots" row sum (T mixed-sign logits) is
held to 1e-4 at 'highest'. K13: 1e-5 in every regime but bf16x3, 1e-4
there (three tensor-core products per term into one accumulator, against
three fp32 products summed after); K14/K15 exactly.
"""

import math

import numpy as np
import pytest
import torch

from collision_handling_in_instantngp_tpu_torch import cli
from collision_handling_in_instantngp_tpu_torch.config import (
    ModelConfig, TrainConfig, experiment_from_grid_id,
)
from collision_handling_in_instantngp_tpu_torch.data import image_dataset
from collision_handling_in_instantngp_tpu_torch.models import encoding, gngf
from collision_handling_in_instantngp_tpu_torch.ops import fused_hpd
from collision_handling_in_instantngp_tpu_torch.ops.cuda import (
    hidden, hpd_full, hpd_stream, hpd_tail, probe, scatter,
)
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


def _tail_inputs(dev, u, t, l, k, seed=0, hd=128):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return dict(
        h=f32(rng.random((u, hd)) * 0.2),
        w=f32(rng.standard_normal((hd, t)) * 0.3),
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
def _hidden_inputs(dev, widths, u=1000):
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.integers(0, 514, size=(u, widths[0])).astype(np.float32), device=dev)
    layers = [
        (torch.as_tensor(rng.uniform(-1, 1, (a, c)).astype(np.float32) / math.sqrt(a), device=dev),
         torch.as_tensor(rng.uniform(-0.1, 0.1, c).astype(np.float32), device=dev))
        for a, c in zip(widths[:-1], widths[1:])
    ]
    gh = torch.as_tensor(rng.standard_normal((u, widths[-1])).astype(np.float32) * 1e-3, device=dev)
    return x, layers, gh


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("widths", [(2, 32, 64, 128), (8, 128), (3, 16, 24, 40, 96)])
def test_hidden_kernels_match_plain(dev, widths, precision):
    x, layers, gh = _hidden_inputs(dev, widths)
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


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
# 256 and 512 wide (the backward's weights read from L2, not staged), and
# (2,) + (512,) * 8 (its activations in device memory too)
@pytest.mark.parametrize("widths", [(2, 256, 512, 256), (2, 512, 256, 512, 128, 64),
                                    (2,) + (512,) * 8])
def test_hidden_kernels_match_plain_wide(dev, widths, precision):
    """At 'highest' the tolerances above. At 'high' / 'default' the plain
    version itself is off the exact (float64) gradients by up to 3e-2 / 1e-1
    normwise on these deep stacks (sums of |x| up to 514 that cancel; the
    contract drops lo*lo, or rounds every term to bf16), and the kernel
    carries an error of the same size, of unrelated sign: the kernel is held
    to its mode's tolerance or to twice the plain version's own error
    against float64, whichever is larger."""
    x, layers, gh = _hidden_inputs(dev, widths)
    fwd_tol, grad_tol = TOL[precision]
    h = hidden.hidden_stack_fwd(x, layers, precision)
    assert torch.equal(h, hidden.hidden_stack_fwd(x, layers, precision))
    _close(h, hidden.hidden_stack_fwd_plain(x, layers, precision), fwd_tol, "h")
    got = hidden.hidden_stack_bwd(x, layers, gh, precision)
    again = hidden.hidden_stack_bwd(x, layers, gh, precision)
    want = hidden.hidden_stack_bwd_plain(x, layers, gh, precision)
    exact = hidden.hidden_stack_bwd_plain(
        x.double(), [(w.double(), b.double()) for w, b in layers], gh.double(), "highest")
    for i, ((dw, db), (dw2, db2), (rw, rb), (ew, eb)) in enumerate(zip(got, again, want, exact)):
        assert torch.equal(dw, dw2) and torch.equal(db, db2), i
        for name, a, r, e in ((f"dW{i}", dw, rw, ew), (f"db{i}", db, rb, eb)):
            own = (r.double() - e).abs().max().item() / max(e.abs().max().item(), 1e-30)
            _close(a, r, max(grad_tol, 2 * own), name)


def test_hidden_bwd_chunks_match_plain(dev):
    """A stack whose act / g scratch takes several chunks of rows (eight
    512-wide layers: 8,736 rows a chunk, 3 chunks at 20,000 rows), each
    chunk's dW kernel adding to the partials of the last: equal, within
    1e-5 normwise, to the sum of the gradients of the chunks' rows taken
    apart (one chunk each), and bitwise stable run to run."""
    widths = (2,) + (512,) * 8
    x, layers, gh = _hidden_inputs(dev, widths, u=20_000)
    got = hidden.hidden_stack_bwd(x, layers, gh)
    again = hidden.hidden_stack_bwd(x, layers, gh)
    bounds = (0, 8_736, 17_472, 20_000)
    parts = [hidden.hidden_stack_bwd(x[a:b], layers, gh[a:b]) for a, b in zip(bounds, bounds[1:])]
    for i, ((dw, db), (dw2, db2)) in enumerate(zip(got, again)):
        assert torch.equal(dw, dw2) and torch.equal(db, db2), i
        _close(dw, sum(p[i][0].double() for p in parts), 1e-5, f"dW{i}")
        _close(db, sum(p[i][1].double() for p in parts), 1e-5, f"db{i}")


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
    "vanilla": dict(use_hash_function=True),     # no HPD: K12 alone
}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_training_on_card_matches_cpu(dev, geometry):
    """Two epochs on the card and on the CPU (plain versions), same start;
    losses agree to rtol 1e-4."""
    exp = experiment_from_grid_id(4061, base_model=ModelConfig(**GEOMETRIES[geometry]),
                                  base_train=TrainConfig(save_params=False))
    img = np.random.default_rng(65535).integers(0, 256, size=(24, 20, 3)).astype(np.uint8)
    data = image_dataset(img, "synthetic")
    start = gngf.init_params(exp.model, 0, "cpu")
    before = hpd_stream.hpd_stream_fused_bwd.launches
    card = fit(exp, data, epochs=2, device=dev, params=start, verbose=False)
    assert (hpd_stream.hpd_stream_fused_bwd.launches > before) == (geometry == "stream")
    if geometry == "vanilla":
        assert card.params.hpd is None
    cpu = fit(exp, data, epochs=2, device="cpu", params=start, verbose=False)
    for a, b in zip(card.history, cpu.history):
        assert math.isclose(a["train_loss"], b["train_loss"], rel_tol=1e-4), (a, b)


def test_cli_runs_on_card(dev, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)           # its logs and checkpoints
    img = np.random.default_rng(0).integers(0, 256, size=(12, 10, 3)).astype(np.uint8)
    np.save(tmp_path / "tiny.npy", img)
    assert cli.main(["-f", "tiny.npy", "--images_dir", str(tmp_path), "-s", "4061",
                     "-e", "4061", "--epochs", "2"]) == 0
    assert "grid 4061: best PSNR" in capsys.readouterr().out


def _per_row_tail_inputs(dev, l, n, t, k, seed=0, hd=128):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return dict(
        h=f32(rng.random((l, n, hd)) * 0.5),
        w=f32(rng.standard_normal((hd, t)) * 0.2),
        b=f32(rng.standard_normal(t) * 0.1),
        g_marg=f32(rng.standard_normal((l, t))),
        g_vals=f32(rng.standard_normal((l, n, k))),
    )


@pytest.mark.parametrize("l,n,t,k", [(2, 700, 128, 1), (3, 1100, 256, 4), (2, 333, 2048, 20),
                                     (4, 1000, 256, 32), (2, 500, 256, 128), (1, 77, 1000, 128)])
def test_per_row_tail_kernels_match_plain(dev, l, n, t, k):
    """K8/K9 against their plain versions: identical indices, normwise
    1e-5 forward and 1e-4 gradients, bitwise equal run to run."""
    x = _per_row_tail_inputs(dev, l, n, t, k)
    out = hpd_tail.hpd_tail_fwd(x["h"], x["w"], x["b"], k)
    ref = hpd_tail.hpd_tail_fwd_plain(x["h"], x["w"], x["b"], k)
    assert torch.equal(out[2], ref[2])
    _close(out[0], ref[0], 1e-5, "marg")
    _close(out[1], ref[1], 1e-5, "vals")
    assert all(torch.equal(a, b) for a, b in zip(out, hpd_tail.hpd_tail_fwd(x["h"], x["w"], x["b"], k)))
    bargs = (x["h"], x["w"], x["b"], ref[2], x["g_marg"], x["g_vals"], k)
    got = hpd_tail.hpd_tail_bwd(*bargs)
    want = hpd_tail.hpd_tail_bwd_plain(*bargs)
    for name, a, r in zip(("dh", "dw", "db"), got, want):
        _close(a, r, 1e-4, name)
    assert all(torch.equal(a, b) for a, b in zip(got, hpd_tail.hpd_tail_bwd(*bargs)))


@pytest.mark.parametrize("l,n,t,k,hd", [(2, 300, 256, 4, 100), (1, 150, 200, 8, 37), (2, 90, 2048, 4, 1),
                                        (3, 400, 512, 4, 128)])
def test_per_row_tail_bwd_on_tensor_cores_at_odd_widths(dev, l, n, t, k, hd):
    """K9 (3xTF32 on the tensor cores) at head input widths and T that are
    not multiples of 32, and at T = 512 (a narrower tile than the forward's):
    dh, dw and db within 1e-4 normwise of the plain version, bitwise equal
    run to run."""
    x = _per_row_tail_inputs(dev, l, n, t, k, hd=hd)
    ref = hpd_tail.hpd_tail_fwd_plain(x["h"], x["w"], x["b"], k)
    bargs = (x["h"], x["w"], x["b"], ref[2], x["g_marg"], x["g_vals"], k)
    got = hpd_tail.hpd_tail_bwd(*bargs)
    want = hpd_tail.hpd_tail_bwd_plain(*bargs)
    for name, a, r in zip(("dh", "dw", "db"), got, want):
        _close(a, r, 1e-4, name)
    assert all(torch.equal(a, b) for a, b in zip(got, hpd_tail.hpd_tail_bwd(*bargs)))


def _full_layers(dev, widths, seed=1):
    rng = np.random.default_rng(seed)
    layers = []
    for i, (din, dout) in enumerate(zip(widths[:-1], widths[1:])):
        scale = 0.5 / math.sqrt(din) if i < len(widths) - 2 else 0.2
        layers.append((torch.as_tensor((rng.standard_normal((din, dout)) * scale).astype(np.float32), device=dev),
                       torch.as_tensor((rng.standard_normal(dout) * 0.1).astype(np.float32), device=dev)))
    return layers


@pytest.mark.parametrize("widths,k,n", [((2, 32, 64, 128, 256), 4, 1000), ((2, 32, 64, 128, 128), 1, 700),
                                        ((2, 32, 64, 128, 2048), 20, 333), ((2, 32, 64, 128, 256), 32, 555),
                                        ((3, 16, 24, 40, 96, 512), 4, 400), ((2, 1000), 8, 300),
                                        ((3, 24, 37, 203), 8, 77), ((3, 150, 37, 96), 4, 333)])
def test_per_row_full_kernels_match_plain(dev, widths, k, n):
    """K10/K11 against their plain versions (the hidden stack, then the
    chunked tail): identical indices, normwise 1e-5 forward and 1e-4
    gradients of every layer, bitwise equal run to run. The last two
    cases' rows fill no tile and their hidden widths (and T) are not
    multiples of 8: K11's tensor-core products bound their reads there (the
    head's read zero padding); the last is past 128 wide, the WIDE
    instance."""
    l = 2
    rng = np.random.default_rng(2)
    verts = torch.as_tensor(rng.integers(0, 33, size=(l, n, widths[0])).astype(np.float32), device=dev)
    layers = _full_layers(dev, widths)
    t = widths[-1]
    out = hpd_full.hpd_full_fwd(verts, layers, k)
    ref = hpd_full.hpd_full_fwd_plain(verts, layers, k)
    assert torch.equal(out[2], ref[2])
    _close(out[0], ref[0], 1e-5, "marg")
    _close(out[1], ref[1], 1e-5, "vals")
    assert all(torch.equal(a, b) for a, b in zip(out, hpd_full.hpd_full_fwd(verts, layers, k)))
    g_marg = torch.as_tensor(rng.standard_normal((l, t)).astype(np.float32), device=dev)
    g_vals = torch.as_tensor(rng.standard_normal((l, n, k)).astype(np.float32), device=dev)
    got = hpd_full.hpd_full_bwd(verts, layers, ref[2], g_marg, g_vals, k)
    again = hpd_full.hpd_full_bwd(verts, layers, ref[2], g_marg, g_vals, k)
    want = hpd_full.hpd_full_bwd_plain(verts, layers, ref[2], g_marg, g_vals, k)
    for i, ((dw, db), (dw2, db2), (rw, rb)) in enumerate(zip(got, again, want)):
        assert torch.equal(dw, dw2) and torch.equal(db, db2), i
        _close(dw, rw, 1e-4, f"dW{i}")
        _close(db, rb, 1e-4, f"db{i}")


def test_k11_phases_tool(dev, tmp_path):
    """tools/k11_phases: the -DHPD_FULL_PHASES build of hpd_full.cu builds,
    launches and splits K11's ticks into its seven phases and K10's into its
    seven, every one of them taking some."""
    import json
    from collision_handling_in_instantngp_tpu_torch.tools import k11_phases

    assert k11_phases.main(["--n", "3000", "--reps", "2", "--out", str(tmp_path)]) == 0
    with open(tmp_path / "k11_phases.json") as f:
        result = json.load(f)
    shares = [p["share"] for p in result["phases"].values()]
    assert len(shares) == 7 and all(x > 0 for x in shares)
    assert abs(sum(shares) - 1) < 1e-9 and result["k11_ms"] > 0
    shares = [p["share"] for p in result["k10_phases"].values()]
    assert len(shares) == 7 and all(x > 0 for x in shares)
    assert abs(sum(shares) - 1) < 1e-9 and result["k10_ms"] > 0


def test_per_row_kernels_select_on_p(dev):
    """Two logits that differ but give equal p (exp(-2^-26) rounds to 1):
    K8 and K10 select the lower column first, as the TPU kernels do."""
    t, k = 256, 4
    lo, hi = 37, t - 5
    b = torch.full((t,), -1.0, device=dev)
    b[lo], b[hi] = -(2.0 ** -26), 0.0
    w = torch.randn(128, t, device=dev)
    _, _, idx = hpd_tail.hpd_tail_fwd(torch.zeros(2, 50, 128, device=dev), w, b, k)
    assert (idx[..., 0] == lo).all() and (idx[..., 1] == hi).all()
    layers = [(torch.rand(2, 16, device=dev), torch.full((16,), -100.0, device=dev)), (w[:16].contiguous(), b)]
    verts = torch.randint(0, 9, (2, 50, 2), device=dev).float()
    _, _, idx = hpd_full.hpd_full_fwd(verts, layers, k)
    assert (idx[..., 0] == lo).all() and (idx[..., 1] == hi).all()


def _planted_network(dev):
    """A planted [2 -> 128 -> 256] network on 1,024 rows (as
    tests/test_torch_tf32_per_row.py plants it): an exact tie at the top,
    a near-tie at the 4th place in both orders, and on every 8th row (lift)
    a cluster of 8 columns within 1.4e-4 at the top. (verts, layers, lift)."""
    rng = np.random.default_rng(65535)
    n, hd, t = 1024, 128, 256
    v = rng.uniform(0.0, 0.75, size=n)
    v = np.where(v < 0.375, v, v + 0.25)
    lift = (np.arange(n) % 8 == 0).astype(np.float64)
    w0, b0 = rng.standard_normal((2, hd)) * 0.5, rng.standard_normal(hd) * 0.3
    w0[:, :4], b0[:4] = [[0, 0, 0.8, -0.8], [0, 1, 0, 0]], [1, 0, 0.2, 1]
    w, b = rng.standard_normal((hd, t)) * 0.05, rng.standard_normal(t) * 0.05
    w[:4] = 0.0
    base = w[:, 30].copy()
    for col, bias in ((30, 3.0), (70, 3.0), (150, 2.9), (120, 2.0), (45, 2.0)):
        w[:, col], b[col] = base, bias
    w[2, 45], w[3, 45] = 2e-5, -2e-5
    for j, col in enumerate((200, 6, 99, 123, 77, 160, 41, 101)):
        w[:, col], w[1, col], b[col] = base, 10.0, (j * 37 % 8) * 2e-5
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return f32(np.stack([v, lift], axis=-1)[None]), [(f32(w0), f32(b0)), (f32(w), f32(b))], lift


def test_full_fwd_guard_hands_near_ties_to_the_redo(dev):
    """K10 on the planted network (_planted_network): top-K identical to
    the plain version on every row, exactly the cluster rows redone in
    fp32, bitwise equal run to run."""
    verts, layers, lift = _planted_network(dev)
    ref = hpd_full.hpd_full_fwd_plain(verts, layers, 4)
    assert set(ref[2][0, lift == 0, 3].tolist()) == {120, 45}
    out = hpd_full.hpd_full_fwd(verts, layers, 4)
    assert int(hpd_full.hpd_full_fwd.fixup_rows.item()) == int(lift.sum())
    assert torch.equal(out[2], ref[2])
    _close(out[0], ref[0], 1e-5, "marg")
    _close(out[1], ref[1], 1e-5, "vals")
    assert all(torch.equal(a, b_) for a, b_ in zip(out, hpd_full.hpd_full_fwd(verts, layers, 4)))


@pytest.mark.parametrize("k", [4, 8])
def test_tail_fwd_planted_near_ties(dev, k):
    """K8 on the planted network's head input (its hidden layer's ReLU
    output): at K = 4 the near-tie at the 4th place in both orders, at K = 8
    the clusters of 8 within 1.4e-4; top-K identical to the plain version
    on every row, bitwise equal run to run."""
    verts, layers, lift = _planted_network(dev)
    h = torch.relu(verts @ layers[0][0] + layers[0][1]).contiguous()
    w, b = layers[1]
    ref = hpd_tail.hpd_tail_fwd_plain(h, w, b, k)
    if k == 4:
        assert set(ref[2][0, lift == 0, 3].tolist()) == {120, 45}
    out = hpd_tail.hpd_tail_fwd(h, w, b, k)
    assert torch.equal(out[2], ref[2])
    _close(out[0], ref[0], 1e-5, "marg")
    _close(out[1], ref[1], 1e-5, "vals")
    assert all(torch.equal(a, b_) for a, b_ in zip(out, hpd_tail.hpd_tail_fwd(h, w, b, k)))


def test_per_row_wrappers_refuse_shapes(dev):
    x = _per_row_tail_inputs(dev, 1, 10, 256, 4)
    before = (hpd_tail.hpd_tail_fwd.launches, hpd_full.hpd_full_fwd.launches)
    with pytest.raises(ValueError):
        hpd_tail.hpd_tail_fwd(x["h"], torch.zeros(128, 4096, device=dev), torch.zeros(4096, device=dev), 4)
    layers = _full_layers(dev, (2, 32, 256))
    with pytest.raises(ValueError):
        hpd_full.hpd_full_fwd(torch.zeros(1, 10, 2, device=dev), layers, 33)
    with pytest.raises(ValueError):                                   # a layer on the CPU
        hpd_full.hpd_full_fwd(torch.zeros(1, 10, 2, device=dev), [layers[0], tuple(t.cpu() for t in layers[1])], 4)
    assert (hpd_tail.hpd_tail_fwd.launches, hpd_full.hpd_full_fwd.launches) == before


PER_ROW = {
    "full": (dict(batchnorm_input=True), hpd_full.hpd_full_bwd),
    "tail": (dict(batchnorm_input=True, hpd_backend="pallas"), hpd_tail.hpd_tail_bwd),
}


@pytest.mark.parametrize("route", sorted(PER_ROW))
def test_per_row_training_on_card_matches_cpu(dev, route):
    """Two epochs of the per-row route (batch-normalized raw coords, the
    default geometry) on the card and on the CPU, same start; the route's
    kernels launched; losses agree to rtol 1e-4."""
    kw, wrapper = PER_ROW[route]
    exp = experiment_from_grid_id(4061, base_model=ModelConfig(**kw), base_train=TrainConfig(save_params=False))
    img = np.random.default_rng(65535).integers(0, 256, size=(24, 20, 3)).astype(np.uint8)
    data = image_dataset(img, "synthetic", normalize=False)
    start = gngf.init_params(exp.model, 0, "cpu")
    before = wrapper.launches
    card = fit(exp, data, epochs=2, device=dev, params=start, verbose=False)
    assert wrapper.launches > before
    cpu = fit(exp, data, epochs=2, device="cpu", params=start, verbose=False)
    for a, b in zip(card.history, cpu.history):
        assert math.isclose(a["train_loss"], b["train_loss"], rel_tol=1e-4), (a, b)


@pytest.mark.parametrize("u,t,l,k", [(300, 2048, 1, 1), (1000, 4096, 16, 4), (333, 2048, 32, 16),
                                     (257, 65536, 16, 4), (130, 65536, 32, 16)])
def test_split_kernels_match_plain(dev, u, t, l, k):
    """K4, K5 and K6 (noop both ways) against their plain versions:
    identical indices, normwise 1e-5 forward and 1e-4 gradients, bitwise
    equal run to run."""
    x = _tail_inputs(dev, u, t, l, k)
    h, w, b, counts = x["h"], x["w"], x["b"], x["counts"]
    out = hpd_stream.hpd_stream_select(h, w, b, k)
    ref = hpd_stream.hpd_stream_select_plain(h, w, b, k, "highest")
    assert torch.equal(out[1], ref[1])
    for name, a, r in zip(("vals", "m", "s"), (out[0], *out[2:]), (ref[0], *ref[2:])):
        _close(a, r, 1e-5, name)
    assert all(torch.equal(a, b_) for a, b_ in zip(out, hpd_stream.hpd_stream_select(h, w, b, k)))
    vals, idx, m, s = ref
    marg = hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s)
    _close(marg, hpd_stream.hpd_stream_marginal_plain(h, w, b, counts, m, s, "highest"), 1e-5, "marg")
    assert torch.equal(marg, hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s))
    for noop in (False, True):
        bargs = (h, w, b, counts, idx, vals, m, s, x["g_marg"], x["g_vals"], k, "highest", noop)
        got = hpd_stream.hpd_tail_unique_bwd(*bargs)
        want = hpd_stream.hpd_tail_unique_bwd_plain(*bargs)
        for name, a, r in zip(("dh", "dw", "db"), got, want):
            _close(a, r, 1e-4, f"{name} noop={noop}")
        assert all(torch.equal(a, b_) for a, b_ in zip(got, hpd_stream.hpd_tail_unique_bwd(*bargs)))


@pytest.mark.parametrize("c", [2, 32])
@pytest.mark.parametrize("layout", ["random", "one_slot", "empty_slots"])
def test_scatter_serial_matches_plain(dev, c, layout):
    """K12 is bitwise its plain version, the serial row-order sum, and
    equal run to run."""
    rng = np.random.default_rng(3)
    n, t = 5000, 1024
    rows_np = rng.standard_normal((n, c)).astype(np.float32)
    idx_np = {"random": rng.integers(0, t, size=n),
              "one_slot": np.full(n, 7),
              "empty_slots": rng.integers(0, t // 4, size=n) * 4}[layout].astype(np.int32)
    rows, idx = torch.as_tensor(rows_np, device=dev), torch.as_tensor(idx_np, device=dev)
    before = scatter.scatter_add_serial.launches
    variant = "narrow" if c == 2 else "ring"
    before_variant = scatter.scatter_add_serial.variant_launches[variant]
    got = scatter.scatter_add_serial(rows, idx, t)
    assert scatter.scatter_add_serial.launches == before + 1
    assert scatter.scatter_add_serial.variant_launches[variant] == before_variant + 1
    assert torch.equal(got, scatter.scatter_add_serial(rows, idx, t))
    assert torch.equal(got, scatter.scatter_add_serial_plain(rows, idx, t))


@pytest.mark.parametrize("c", [2, 32])
def test_scatter_serial_hot_slot_matches_plain(dev, c):
    """K12 with one slot of 100,000 rows (longer than the path's 84,069)
    among a ragged tail of short and empty slots: bitwise its plain version
    and equal run to run."""
    rng = np.random.default_rng(11)
    t = 4099
    idx_np = np.concatenate([np.full(100_000, 17), rng.integers(0, t, size=30_001)])
    rng.shuffle(idx_np)
    rows = torch.as_tensor(rng.standard_normal((idx_np.size, c)).astype(np.float32), device=dev)
    idx = torch.as_tensor(idx_np.astype(np.int32), device=dev)
    got = scatter.scatter_add_serial(rows, idx, t)
    assert torch.equal(got, scatter.scatter_add_serial(rows, idx, t))
    assert torch.equal(got, scatter.scatter_add_serial_plain(rows, idx, t))


@pytest.mark.parametrize("c, t, rank, ranks", [(32, 16_384, 0, 2), (32, 16_384, 1, 2),
                                                (2, 1024, 3, 4), (32, 4099, 1, 3)])
def test_scatter_serial_slot_range_matches_plain(dev, c, t, rank, ranks):
    """K12 over one rank's slot range of a table sharded by slot (the
    blend's gradient under TP: 647,168 rows of 32 columns on 16,384 slots;
    a hot slot in range): bitwise its plain version over that range, rows
    lo..hi of the whole scatter, and equal run to run; counted as a ranged
    launch."""
    rng = np.random.default_rng(13)
    n = 647_168 if c == 32 and t == 16_384 else 50_000
    lo, hi = rank * t // ranks, (rank + 1) * t // ranks
    idx_np = rng.integers(0, t, size=n)
    idx_np[: n // 10] = (lo + hi) // 2
    rows = torch.as_tensor(rng.standard_normal((n, c)).astype(np.float32), device=dev)
    idx = torch.as_tensor(idx_np, device=dev)
    before = scatter.scatter_add_serial.range_launches
    got = scatter.scatter_add_serial(rows, idx, t, ids_checked=True, slot_range=(lo, hi))
    assert scatter.scatter_add_serial.range_launches == before + 1
    assert got.shape == (hi - lo, c)
    assert torch.equal(got, scatter.scatter_add_serial(rows, idx, t, slot_range=(lo, hi)))
    assert torch.equal(got, scatter.scatter_add_serial_plain(rows, idx, t, slot_range=(lo, hi)))
    assert torch.equal(got, scatter.scatter_add_serial_plain(rows, idx, t)[lo:hi])


def test_scatter_serial_long_narrow_slots_match_plain(dev):
    """Rows of 2 columns in long slots (2,000 a slot on average, as in the
    per-row blend's gradient) take the ring, not the thread-per-slot path
    of short slots: bitwise the plain version and equal run to run."""
    rng = np.random.default_rng(5)
    t = 64
    idx = torch.as_tensor(rng.integers(0, t, size=128_000).astype(np.int32), device=dev)
    rows = torch.as_tensor(rng.standard_normal((idx.numel(), 2)).astype(np.float32), device=dev)
    before = scatter.scatter_add_serial.variant_launches["ring"]
    got = scatter.scatter_add_serial(rows, idx, t)
    assert scatter.scatter_add_serial.variant_launches["ring"] == before + 1
    assert torch.equal(got, scatter.scatter_add_serial(rows, idx, t))
    assert torch.equal(got, scatter.scatter_add_serial_plain(rows, idx, t))


# ragged U; T from 2048 to 2^16; L 1, 16, 32; K 1, 4, 16; heads of 128, and of
# 37 and 100 (the logits' contraction, split between two warpgroups, leaves
# one half partly or wholly empty)
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("u,t,l,k,hd", [(1000, 2048, 1, 1, 128), (777, 16384, 16, 4, 128),
                                        (333, 65536, 32, 16, 128), (130, 2048, 16, 16, 128),
                                        (300, 4096, 16, 4, 37), (300, 4096, 16, 4, 100)])
def test_tail_bwd_on_tensor_cores_matches_plain(dev, u, t, l, k, hd, precision):
    """K2 and K6 (their products on the tensor cores) against the plain
    version at each precision's gradient tolerance, both noop ways, bitwise
    equal run to run; the forward kernels' top-K (K1, K4, on the CUDA cores)
    identical to the plain version's at 'highest'."""
    x = _tail_inputs(dev, u, t, l, k, hd=hd)
    h, w, b, counts = x["h"], x["w"], x["b"], x["counts"]
    ref = hpd_stream.hpd_stream_fused_fwd_plain(h, w, b, counts, k, precision)
    if precision == "highest":
        assert torch.equal(hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, k)[2], ref[2])
        assert torch.equal(hpd_stream.hpd_stream_select(h, w, b, k)[1], ref[2])
    _, vals, idx, m, s = ref
    grad_tol = TOL[precision][1]
    for noop in (False, True):
        bargs = (h, w, b, counts, idx, vals, m, s, x["g_marg"], x["g_vals"], k, precision, noop)
        want = hpd_stream.hpd_stream_fused_bwd_plain(*bargs)
        for fn in (hpd_stream.hpd_stream_fused_bwd, hpd_stream.hpd_tail_unique_bwd):
            got = fn(*bargs)
            for name, a, r in zip(("dh", "dw", "db"), got, want):
                _close(a, r, grad_tol, f"{fn.__name__} {name} noop={noop}")
            assert all(torch.equal(a, b_) for a, b_ in zip(got, fn(*bargs)))


# heads past 128 (ROADMAP §3.1): K1, K4 and K5 and K2's and K6's own launches
# on the tensor cores with the contraction over H in 128-deep chunks (136,
# 200, 1000: a partial last chunk; 384-1000: heads of 3 to 8 chunks); the
# rows pass's fix-up settles the rows its guard lists, at most u (printed)
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("u,t,l,k,hd", [(300, 2048, 3, 4, 256), (200, 4096, 16, 16, 512),
                                        (77, 256, 2, 1, 136), (300, 2048, 3, 4, 640),
                                        (100, 2048, 2, 4, 1000), (250, 2048, 5, 4, 200),
                                        (150, 4096, 8, 8, 384)])
def test_stream_kernels_match_plain_wide(dev, u, t, l, k, hd, precision):
    x = _tail_inputs(dev, u, t, l, k, hd=hd)
    h, w, b, counts = x["h"], x["w"], x["b"], x["counts"]
    fwd_tol, grad_tol = TOL[precision]
    ref = hpd_stream.hpd_stream_fused_fwd_plain(h, w, b, counts, k, precision)
    outs = [hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, k, precision)]
    if t % hpd_stream.LANE_TILE == 0:
        sel = hpd_stream.hpd_stream_select(h, w, b, k, precision)
        outs.append((hpd_stream.hpd_stream_marginal(h, w, b, counts, *sel[2:], precision), *sel))
    for out in outs:
        if precision == "highest":
            assert torch.equal(out[2], ref[2])
        for name, a, r in zip(("marg", "vals", "m", "s"), (out[0], out[1], *out[3:]),
                              (ref[0], ref[1], *ref[3:])):
            _close(a, r, fwd_tol, name)
    n_fix = int(hpd_stream.hpd_stream_fused_fwd.fixup_rows.item())
    print(f"H={hd} {precision}: rows settled by the fp32 fix-up: {n_fix} of {u}")
    assert 0 <= n_fix <= u
    _, vals, idx, m, s = ref
    fns = [hpd_stream.hpd_stream_fused_bwd]
    if t % hpd_stream.LANE_TILE == 0:
        fns.append(hpd_stream.hpd_tail_unique_bwd)
    for noop in (False, True):
        bargs = (h, w, b, counts, idx, vals, m, s, x["g_marg"], x["g_vals"], k, precision, noop)
        want = hpd_stream.hpd_stream_fused_bwd_plain(*bargs)
        for fn in fns:
            got = fn(*bargs)
            for name, a, r in zip(("dh", "dw", "db"), got, want):
                _close(a, r, grad_tol, f"{fn.__name__} {name} noop={noop}")
            assert all(torch.equal(a, b_) for a, b_ in zip(got, fn(*bargs)))


@pytest.mark.parametrize("hd", [128, 256, 1000])
def test_tail_bwd_runs_its_own_launches_at_every_width(dev, hd):
    """K2 runs its row and columns kernels, K6 B1, B2's rows kernel and the
    columns kernel, at every head width (no CUDA-core pass, and K2 never
    K6's launches)."""
    from torch.profiler import ProfilerActivity, profile

    u, t, l, k = 300, 2048, 3, 4
    x = _tail_inputs(dev, u, t, l, k, hd=hd)
    h, w, b, counts = x["h"], x["w"], x["b"], x["counts"]
    _, vals, idx, m, s = hpd_stream.hpd_stream_fused_fwd_plain(h, w, b, counts, k, "highest")
    bargs = (h, w, b, counts, idx, vals, m, s, x["g_marg"], x["g_vals"], k)
    for fn, want in ((hpd_stream.hpd_stream_fused_bwd, {"hpd_bwd_rows_kernel", "hpd_bwd_cols_kernel"}),
                     (hpd_stream.hpd_tail_unique_bwd,
                      {"hpd_b1_kernel", "hpd_b2_rows_kernel", "hpd_bwd_cols_kernel"})):
        fn(*bargs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(*bargs)
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()}
        ran = {n for n in ("hpd_bwd_rows_kernel", "hpd_bwd_cols_kernel", "hpd_b1_kernel",
                           "hpd_b2_rows_kernel", "hpd_wide") if any(n in e for e in names)}
        assert ran == want, (fn.__name__, hd, ran)


@pytest.mark.parametrize("hd", [128, 256, 1000])
def test_stream_fwd_runs_its_own_launches_at_every_width(dev, hd):
    """K1 and K4 run the tensor-core rows pass and the fix-up, K1 and K5 the
    tensor-core columns pass, K7 its probe kernel, at every head width (no
    CUDA-core wide pass)."""
    from torch.profiler import ProfilerActivity, profile

    u, t, l, k = 300, 2048, 3, 4
    x = _tail_inputs(dev, u, t, l, k, hd=hd)
    h, w, b, counts = x["h"], x["w"], x["b"], x["counts"]
    _, vals, idx, m, s = hpd_stream.hpd_stream_fused_fwd_plain(h, w, b, counts, k, "highest")
    rows = {"hpd_fwd_rows_kernel", "hpd_fix_rows_kernel"}
    for fn, want in ((lambda: hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, k),
                      rows | {"hpd_fwd_cols_kernel"}),
                     (lambda: hpd_stream.hpd_stream_select(h, w, b, k), rows),
                     (lambda: hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s),
                      {"hpd_fwd_cols_kernel"}),
                     (lambda: hpd_stream.hpd_stream_fused_probe(h, w, b), {"hpd_probe_kernel"})):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()}
        ran = {n for n in ("hpd_fwd_rows_kernel", "hpd_fix_rows_kernel", "hpd_fwd_cols_kernel",
                           "hpd_probe_kernel", "hpd_wide") if any(n in e for e in names)}
        assert ran == want, (hd, ran)


def _dyadic(rng, shape, lo, hi, scale, dev):
    return torch.as_tensor(rng.integers(lo, hi, size=shape) * scale, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("hd", [256, 640, 1000])
def test_stream_fwd_wide_matches_plain_at_every_precision(dev, hd, precision):
    """K1, K4, K5 and K7 past 128 at each precision on inputs whose logits
    are exact in fp32 and bf16 (h, w, b multiples of 1/8, 1/128, 1/512):
    top-K identical to the plain version on every row (exact ties among
    them, which send rows to the fix-up: printed), vals, m, s within 1e-5
    normwise (m, s of K7 too), marg within the precision's tolerance (its
    p is rounded to the precision's operands), bitwise run to run."""
    rng = np.random.default_rng(hd)
    u, t, l, k = 1000, 2048, 4, 4
    h = _dyadic(rng, (u, hd), 0, 8, 1 / 8, dev)
    w = _dyadic(rng, (hd, t), -8, 9, 1 / 128, dev)
    b = _dyadic(rng, (t,), -64, 65, 1 / 512, dev)
    counts = _dyadic(rng, (l, u), 0, 5, 1, dev)
    ref = hpd_stream.hpd_stream_fused_fwd_plain(h, w, b, counts, k, precision)
    fused = hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, k, precision)
    n_fix = int(hpd_stream.hpd_stream_fused_fwd.fixup_rows.item())
    sel = hpd_stream.hpd_stream_select(h, w, b, k, precision)
    marg = hpd_stream.hpd_stream_marginal(h, w, b, counts, *ref[3:], precision)
    print(f"H={hd} {precision}: rows settled by the fp32 fix-up: {n_fix} of {u}")
    assert torch.equal(fused[2], ref[2]) and torch.equal(sel[1], ref[2])
    for name, a, r in zip(("vals", "m", "s"), (fused[1], *fused[3:]), (ref[1], *ref[3:])):
        _close(a, r, 1e-5, f"K1 {name}")
    for name, a, r in zip(("vals", "m", "s"), (sel[0], *sel[2:]), (ref[1], *ref[3:])):
        _close(a, r, 1e-5, f"K4 {name}")
    _close(fused[0], ref[0], TOL[precision][0], "K1 marg")
    _close(marg, ref[0], TOL[precision][0], "K5 marg")
    assert all(torch.equal(a, b_) for a, b_ in
               zip(fused, hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, k, precision)))
    assert torch.equal(marg, hpd_stream.hpd_stream_marginal(h, w, b, counts, *ref[3:], precision))
    for variant in hpd_stream.PROBE_VARIANTS:
        got = hpd_stream.hpd_stream_fused_probe(h, w, b, precision, variant)
        want = hpd_stream.hpd_stream_fused_probe_plain(h, w, b, precision, variant)
        for name, a, r in zip(("m", "s"), got, want):
            _close(a, r, 1e-5, f"K7 {variant} {name}")
        assert all(torch.equal(a, b_) for a, b_ in
                   zip(got, hpd_stream.hpd_stream_fused_probe(h, w, b, precision, variant)))


@pytest.mark.parametrize("l,n,t,k,hd", [(2, 500, 256, 4, 256), (3, 333, 2048, 20, 512),
                                        (1, 77, 1000, 8, 200)])
def test_per_row_tail_kernels_match_plain_wide(dev, l, n, t, k, hd):
    """K8/K9 at head inputs past 128: as test_per_row_tail_kernels_match_plain."""
    x = _per_row_tail_inputs(dev, l, n, t, k, hd=hd)
    out = hpd_tail.hpd_tail_fwd(x["h"], x["w"], x["b"], k)
    ref = hpd_tail.hpd_tail_fwd_plain(x["h"], x["w"], x["b"], k)
    assert torch.equal(out[2], ref[2])
    _close(out[0], ref[0], 1e-5, "marg")
    _close(out[1], ref[1], 1e-5, "vals")
    bargs = (x["h"], x["w"], x["b"], ref[2], x["g_marg"], x["g_vals"], k)
    got = hpd_tail.hpd_tail_bwd(*bargs)
    want = hpd_tail.hpd_tail_bwd_plain(*bargs)
    for name, a, r in zip(("dh", "dw", "db"), got, want):
        _close(a, r, 1e-4, name)
    assert all(torch.equal(a, b) for a, b in zip(got, hpd_tail.hpd_tail_bwd(*bargs)))


@pytest.mark.parametrize("t", [256, 2048])
@pytest.mark.parametrize("k", [4, 32, 128])
@pytest.mark.parametrize("hd", [128, 256, 640, 1000])
def test_per_row_tail_fwd_matches_plain_any_width(dev, hd, k, t):
    """K8 at head inputs to 1000 (past 512: h through the tile in chunks
    where the whole tile does not fit), K up to 128, T = 256 and 2048:
    identical indices, normwise 1e-5, bitwise equal run to run. h, w and b
    are multiples of 1/8, 1/64 and 1/512, so every logit is exact in fp32
    whatever the summation order: two columns differ by 1/512 or tie
    exactly, and the kernel's fma chains and the plain version's cuBLAS
    sums (whose rounding differs at 1000 terms) rank them alike."""
    rng = np.random.default_rng(hd + k + t)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    h = f32(rng.integers(0, 8, size=(2, 333, hd)) / 8)
    w = f32(rng.integers(-8, 9, size=(hd, t)) / 64 * (1 if hd < 512 else 0.5))
    b = f32(rng.integers(-64, 65, size=t) / 512)
    out = hpd_tail.hpd_tail_fwd(h, w, b, k)
    ref = hpd_tail.hpd_tail_fwd_plain(h, w, b, k)
    assert torch.equal(out[2], ref[2])
    _close(out[0], ref[0], 1e-5, "marg")
    _close(out[1], ref[1], 1e-5, "vals")
    assert all(torch.equal(a, b_) for a, b_ in zip(out, hpd_tail.hpd_tail_fwd(h, w, b, k)))


@pytest.mark.parametrize("k", [4, 8])
def test_per_row_tail_fwd_random_data_in_chunks(dev, k):
    """K8 where h goes through the tile in chunks (H = 1000, T = 2048) on
    random data, where the summation order moves the logits: marg and vals
    normwise 1e-5, bitwise equal run to run, and the indices held to the
    float64 top-K on every row whose top K + 1 float64 logits are apart by
    more than any two fp32 sums of H + 1 terms can err (gamma_{H+1} times
    each logit's sum of |terms|); at least half the rows are."""
    hd, t = 1000, 2048
    rng = np.random.default_rng(hd + k + t + 1)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    h = f32(rng.random((2, 500, hd)) * 0.2)
    w = f32(rng.standard_normal((hd, t)) * 0.3 * math.sqrt(128 / hd))
    b = f32(rng.standard_normal(t) * 0.1)
    out = hpd_tail.hpd_tail_fwd(h, w, b, k)
    ref = hpd_tail.hpd_tail_fwd_plain(h, w, b, k)
    _close(out[0], ref[0], 1e-5, "marg")
    _close(out[1], ref[1], 1e-5, "vals")
    assert all(torch.equal(a, b_) for a, b_ in zip(out, hpd_tail.hpd_tail_fwd(h, w, b, k)))
    top = (h.double() @ w.double() + b.double()).topk(k + 1, dim=-1)
    terms = (h.double() @ w.double().abs() + b.double().abs()).gather(-1, top.indices)
    u = (hd + 1) * 2.0**-24
    clear = ((top.values[..., :-1] - top.values[..., 1:]) >
             u / (1 - u) * (terms[..., :-1] + terms[..., 1:])).all(dim=-1)
    assert clear.float().mean().item() >= 0.5
    want = top.indices[..., :k][clear]
    assert torch.equal(ref[2].long()[clear], want)
    assert torch.equal(out[2].long()[clear], want)


@pytest.mark.parametrize("t", [256, 2048])
def test_tail_bwd_up_to_its_tile_limit(dev, t):
    """K9 at the widest head input its 16-row tile holds (3,040 at T = 256,
    1,152 at T = 2048) against its plain version; one past it the wrapper
    raises naming the figure and the kernels' own check refuses it too."""
    hd = hpd_tail.bwd_max_h(t)
    x = _per_row_tail_inputs(dev, 1, 100, t, 4, hd=hd)
    x["w"] *= math.sqrt(128 / hd)
    ref = hpd_tail.hpd_tail_fwd_plain(x["h"], x["w"], x["b"], 4)
    bargs = (x["h"], x["w"], x["b"], ref[2], x["g_marg"], x["g_vals"], 4)
    for name, a, r in zip(("dh", "dw", "db"), hpd_tail.hpd_tail_bwd(*bargs), hpd_tail.hpd_tail_bwd_plain(*bargs)):
        _close(a, r, 1e-4, name)
    lib = hpd_tail._lib()
    assert lib.hpd_tail_blocks(1, 100, hd, t, 4, 1) > 0 and lib.hpd_tail_blocks(1, 100, hd + 1, t, 4, 1) == 0
    wide = torch.zeros(1, 100, hd + 1, device=dev)
    before = hpd_tail.hpd_tail_bwd.launches
    with pytest.raises(ValueError, match=f"H <= {hd} at T={t}"):
        hpd_tail.hpd_tail_bwd(wide, torch.zeros(hd + 1, t, device=dev), x["b"], ref[2], x["g_marg"],
                              x["g_vals"], 4)
    assert hpd_tail.hpd_tail_bwd.launches == before


FULL_GATE_STACKS = [(2, 32, 64, 128, 256), (2, 256, 512, 256, 256), (2, 512, 512, 512, 512, 2048),
                    (2, 512, 2048), (2, 512, 512, 2048), (2, 512, 512, 512, 256),
                    (2, 512, 512, 512, 512, 256), (2, 128, 128, 128, 128, 128, 128, 2048),
                    (3, 384, 384, 1024), (2, 512, 512, 512, 1024), (2, 64, 512, 64, 2048), (2, 2048),
                    (8, 256, 256, 256, 256, 512)]


def test_full_gate_matches_the_kernels(dev):
    """hpd_full.supports (models/hpd.py's gate, decided from the shapes) says
    of every stack what hpd_full.cu's own plan says (hpd_full_blocks)."""
    import ctypes
    lib = hpd_full._lib()
    for widths in FULL_GATE_STACKS:
        cw = (ctypes.c_int * len(widths))(*widths)
        assert (lib.hpd_full_blocks(len(widths) - 1, cw, 2, 100, 4) > 0) == hpd_full.supports(widths, 4), widths


def test_auto_routes_overflowing_stack_to_the_tail(dev):
    """[2 -> 512 -> 512 -> 512 -> 512 -> 2048] on "auto": a plain stack and
    K8/K9 on the card (one launch each, K10/K11 none), against the chunked
    PyTorch tail on the card (the same plain stack, then K8/K9's plain
    versions): identical indices, 1e-5 forward, 1e-4 gradients."""
    import dataclasses
    from collision_handling_in_instantngp_tpu_torch.models import hpd as port_hpd
    from collision_handling_in_instantngp_tpu_torch.models.mlp import MLP, init_layers
    from collision_handling_in_instantngp_tpu_torch.utils import prng
    cfg = ModelConfig(hpd_hidden=(512,) * 4, hash_table_size=2048, topk_k=4)
    verts = torch.randint(0, 33, (200, 2, 4, 2), generator=torch.Generator().manual_seed(3)).float().to(dev)
    wrappers = (hpd_tail.hpd_tail_fwd, hpd_tail.hpd_tail_bwd, hpd_full.hpd_full_fwd, hpd_full.hpd_full_bwd)
    outs, grads = [], []
    for backend in ("auto", "jax"):
        net = MLP(init_layers(prng.prng_key(3), (2, *cfg.hpd_hidden, 2048)), dev)
        counts = [f.launches for f in wrappers]
        marg, vals, idx = port_hpd.apply_hpd_fused(net, verts, dataclasses.replace(cfg, hpd_backend=backend))
        (marg.sum() * 3 + (vals * torch.arange(4.0, device=dev)).sum()).backward()
        launched = [f.launches - c for f, c in zip(wrappers, counts)]
        assert launched == ([1, 1, 0, 0] if backend == "auto" else [0, 0, 0, 0])
        outs.append((marg.detach(), vals.detach(), idx))
        grads.append([p.grad for p in net.parameters()])
    assert torch.equal(outs[0][2], outs[1][2])
    _close(outs[0][0], outs[1][0], 1e-5, "marg")
    _close(outs[0][1], outs[1][1], 1e-5, "vals")
    for i, (a, r) in enumerate(zip(*grads)):
        _close(a, r, 1e-4, f"grad{i}")


@pytest.mark.parametrize("widths,k,n", [((2, 256, 512, 256, 256), 4, 700),
                                        ((2, 512, 2048), 20, 200), ((3, 200, 136, 96), 8, 77)])
def test_per_row_full_kernels_match_plain_wide(dev, widths, k, n):
    """K10/K11 on stacks past 128 wide: as test_per_row_full_kernels_match_plain."""
    l = 2
    rng = np.random.default_rng(2)
    verts = torch.as_tensor(rng.integers(0, 33, size=(l, n, widths[0])).astype(np.float32), device=dev)
    layers = _full_layers(dev, widths)
    t = widths[-1]
    out = hpd_full.hpd_full_fwd(verts, layers, k)
    ref = hpd_full.hpd_full_fwd_plain(verts, layers, k)
    assert torch.equal(out[2], ref[2])
    _close(out[0], ref[0], 1e-5, "marg")
    _close(out[1], ref[1], 1e-5, "vals")
    g_marg = torch.as_tensor(rng.standard_normal((l, t)).astype(np.float32), device=dev)
    g_vals = torch.as_tensor(rng.standard_normal((l, n, k)).astype(np.float32), device=dev)
    got = hpd_full.hpd_full_bwd(verts, layers, ref[2], g_marg, g_vals, k)
    again = hpd_full.hpd_full_bwd(verts, layers, ref[2], g_marg, g_vals, k)
    want = hpd_full.hpd_full_bwd_plain(verts, layers, ref[2], g_marg, g_vals, k)
    for i, ((dw, db), (dw2, db2), (rw, rb)) in enumerate(zip(got, again, want)):
        assert torch.equal(dw, dw2) and torch.equal(db, db2), i
        _close(dw, rw, 1e-4, f"dW{i}")
        _close(db, rb, 1e-4, f"db{i}")


@pytest.mark.parametrize("stack", ["route", "rpt2", "odd", "wide", "compact"])
def test_per_row_full_kernels_at_the_digest_stacks(dev, stack):
    """K10/K11 against their plain versions on the seeded inputs that
    tools/per_row_digests.py hashes: the per-row route's stack at its size
    (64-row tiles), a 32-row tile, widths that are not multiples of 8, a
    stack past 128 wide (16-row tiles) and one whose backward takes the
    compact layout (strides w + 1, the vertices' d + 1): identical top-K,
    normwise 1e-5 forward and 1e-4 gradients of every layer, bitwise equal
    run to run."""
    from collision_handling_in_instantngp_tpu_torch.tools import per_row_digests

    verts, layers, g_marg, g_vals, k = per_row_digests.stack_inputs(stack, dev)
    out = hpd_full.hpd_full_fwd(verts, layers, k)
    ref = hpd_full.hpd_full_fwd_plain(verts, layers, k)
    assert torch.equal(out[2], ref[2])
    _close(out[0], ref[0], 1e-5, "marg")
    _close(out[1], ref[1], 1e-5, "vals")
    assert all(torch.equal(a, b) for a, b in zip(out, hpd_full.hpd_full_fwd(verts, layers, k)))
    got = hpd_full.hpd_full_bwd(verts, layers, out[2], g_marg, g_vals, k)
    again = hpd_full.hpd_full_bwd(verts, layers, out[2], g_marg, g_vals, k)
    want = hpd_full.hpd_full_bwd_plain(verts, layers, out[2], g_marg, g_vals, k)
    for i, ((dw, db), (dw2, db2), (rw, rb)) in enumerate(zip(got, again, want)):
        assert torch.equal(dw, dw2) and torch.equal(db, db2), i
        _close(dw, rw, 1e-4, f"dW{i}")
        _close(db, rb, 1e-4, f"db{i}")


def test_split_wrappers_refuse_shapes(dev):
    x = _tail_inputs(dev, 100, 2048, 2, 4)
    h, w, b, counts = x["h"], x["w"], x["b"], x["counts"]
    vals, idx, m, s = hpd_stream.hpd_stream_select_plain(h, w, b, 4, "highest")
    rows = torch.zeros(10, 4, device=dev)
    wrappers = (hpd_stream.hpd_stream_select, hpd_stream.hpd_stream_marginal,
                hpd_stream.hpd_tail_unique_bwd, scatter.scatter_add_serial)
    before = [fn.launches for fn in wrappers]
    with pytest.raises(ValueError):                                   # T not a multiple of 2048
        hpd_stream.hpd_stream_select(h, w[:, :1024].contiguous(), b[:1024].contiguous(), 4)
    with pytest.raises(ValueError):                                   # K > 16
        hpd_stream.hpd_stream_select(h, w, b, 17)
    with pytest.raises(ValueError):                                   # m of the wrong rows
        hpd_stream.hpd_stream_marginal(h, w, b, counts, m[:50], s)
    with pytest.raises(ValueError):                                   # int64 indices
        hpd_stream.hpd_tail_unique_bwd(h, w, b, counts, idx.long(), vals, m, s, x["g_marg"],
                                       x["g_vals"], 4)
    with pytest.raises(ValueError):
        scatter.scatter_add_serial(rows, torch.zeros(9, dtype=torch.int32, device=dev), 8)
    with pytest.raises(ValueError):
        scatter.scatter_add_serial(rows.double(), torch.zeros(10, dtype=torch.int32, device=dev), 8)
    for bad in (-1, 8):                                               # idx outside [0, T)
        with pytest.raises(ValueError):
            scatter.scatter_add_serial(rows, torch.full((10,), bad, dtype=torch.int32, device=dev), 8)
    assert [fn.launches for fn in wrappers] == before


def test_split_training_on_card_matches_cpu(dev, monkeypatch):
    """Two epochs through the split route (gate forced off) with the serial
    scatter of the table gradients, on the card and on the CPU, same start;
    K4, K5, K6 and K12 launched, K1/K2 did not; losses agree to rtol 1e-4."""
    monkeypatch.setattr(hpd_stream, "FUSED_W_MAX_BYTES", 0)
    exp = experiment_from_grid_id(4061, base_model=ModelConfig(
        hash_table_size=4096, num_levels=4, n_min=8, n_max=48, hpd_backend="unique_stream"),
        base_train=TrainConfig(save_params=False))
    img = np.random.default_rng(65535).integers(0, 256, size=(24, 20, 3)).astype(np.uint8)
    data = image_dataset(img, "synthetic")
    start = gngf.init_params(exp.model, 0, "cpu")
    launched = (hpd_stream.hpd_stream_select, hpd_stream.hpd_stream_marginal,
                hpd_stream.hpd_tail_unique_bwd, scatter.scatter_add_serial)
    absent = (hpd_stream.hpd_stream_fused_fwd, hpd_stream.hpd_stream_fused_bwd)
    before = [fn.launches for fn in launched + absent]
    card = fit(exp, data, epochs=2, device=dev, params=start, verbose=False)
    after = [fn.launches for fn in launched + absent]
    assert all(a > b_ for a, b_ in zip(after[:4], before[:4])) and after[4:] == before[4:]
    cpu = fit(exp, data, epochs=2, device="cpu", params=start, verbose=False)
    for a, b_ in zip(card.history, cpu.history):
        assert math.isclose(a["train_loss"], b_["train_loss"], rel_tol=1e-4), (a, b_)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("variant", ["softmax", "dots"])
@pytest.mark.parametrize("u,t", [(333, 256), (1000, 2048), (61, 128)])
def test_fused_probe_matches_plain(dev, u, t, variant, precision):
    """K7 against its plain version (U not a multiple of 64), bitwise equal
    run to run; b taken as (T,) and as (1, T)."""
    x = _tail_inputs(dev, u, t, 1, 1)
    before = hpd_stream.hpd_stream_fused_probe.launches
    m, s = hpd_stream.hpd_stream_fused_probe(x["h"], x["w"], x["b"], precision, variant)
    again = hpd_stream.hpd_stream_fused_probe(x["h"], x["w"], x["b"][None], precision, variant)
    assert hpd_stream.hpd_stream_fused_probe.launches == before + 2
    rm, rs = hpd_stream.hpd_stream_fused_probe_plain(x["h"], x["w"], x["b"], precision, variant)
    tol = max(TOL[precision][0], 1e-4 if variant == "dots" else 0.0)
    _close(m, rm, tol, "m")
    _close(s, rs, tol, "s")
    assert torch.equal(m, again[0]) and torch.equal(s, again[1])


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("variant", ["softmax", "dots"])
@pytest.mark.parametrize("u,t,hd", [(333, 256, 256), (100, 2048, 512)])
def test_fused_probe_matches_plain_wide(dev, u, t, hd, variant, precision):
    """K7's wide pass (heads past 128) against its plain version, bitwise
    equal run to run; tolerances as test_fused_probe_matches_plain."""
    x = _tail_inputs(dev, u, t, 1, 1, hd=hd)
    m, s = hpd_stream.hpd_stream_fused_probe(x["h"], x["w"], x["b"], precision, variant)
    again = hpd_stream.hpd_stream_fused_probe(x["h"], x["w"], x["b"], precision, variant)
    rm, rs = hpd_stream.hpd_stream_fused_probe_plain(x["h"], x["w"], x["b"], precision, variant)
    tol = max(TOL[precision][0], 1e-4 if variant == "dots" else 0.0)
    _close(m, rm, tol, "m")
    _close(s, rs, tol, "s")
    assert torch.equal(m, again[0]) and torch.equal(s, again[1])


@pytest.mark.parametrize("regime", probe.REGIMES)
@pytest.mark.parametrize("u,hd,t", [(333, 128, 2048), (1001, 64, 384), (77, 16, 128)])
def test_rowsum_matches_plain(dev, u, hd, t, regime):
    """K13 against its plain version (U not a multiple of 16 or 64; one
    column tile up to 16), bitwise equal run to run."""
    rng = np.random.default_rng(4)
    h = torch.as_tensor((rng.standard_normal((u, hd)) * 0.3).astype(np.float32), device=dev)
    w = torch.as_tensor((rng.standard_normal((hd, t)) * 0.1).astype(np.float32), device=dev)
    before = probe.rowsum_dot.launches
    got = probe.rowsum_dot(h, w, regime)
    assert probe.rowsum_dot.launches == before + 1 and got.shape == (u, 1)
    _close(got, probe.rowsum_dot_plain(h, w, regime), 1e-4 if regime == "bf16x3" else 1e-5, regime)
    assert torch.equal(got, probe.rowsum_dot(h, w, regime))


def test_rowsum_refuses_shapes(dev):
    """H not a multiple of 16 or over 128, T not a multiple of 128: the
    kernel's ERR_SHAPE, raised, nothing counted."""
    before = probe.rowsum_dot.launches
    for hd, t in ((120, 256), (144, 256), (64, 200)):
        with pytest.raises(RuntimeError, match="shape not supported"):
            probe.rowsum_dot(torch.zeros(50, hd, device=dev), torch.zeros(hd, t, device=dev), "bf16")
    with pytest.raises(ValueError):
        probe.rowsum_dot(torch.zeros(50, 64, device=dev), torch.zeros(32, 256, device=dev))
    assert probe.rowsum_dot.launches == before


@pytest.mark.parametrize("n", [1, 7, 1_000_003])
def test_hbm_probes_exact(dev, n):
    """K14 writes exact ones, K15 exactly 2 x, also from an address that is
    not 16-byte aligned (the scalar path)."""
    before = (probe.hbm_write.launches, probe.hbm_scale_copy.launches)
    ones = probe.hbm_write((n,), dev)
    assert torch.equal(ones, torch.ones(n, device=dev))
    assert torch.equal(probe.hbm_write((n, 3), dev), torch.ones(n, 3, device=dev))
    base = torch.randn(n + 1, device=dev)
    for x in (base[:n], base[1:]):
        y = probe.hbm_scale_copy(x)
        assert torch.equal(y, x * 2) and y.data_ptr() != x.data_ptr()
    assert (probe.hbm_write.launches, probe.hbm_scale_copy.launches) == (before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 7, 1_000_003, 4 * 4 * 256 * 1056 + 9])
def test_hbm_write_edges(dev, n, offset):
    """K14 exactly ones at sizes below one float4, not a multiple of 4, and
    of 1,056 whole blocks (1,024 float4 each) plus a partial one and a
    scalar tail, from 16-byte aligned and unaligned addresses (the scalar
    path), and nothing written outside its span."""
    base = torch.zeros(n + 4, device=dev)
    before = probe.hbm_write.launches
    probe._write_ones(base[offset:offset + n])
    assert torch.equal(base[offset:offset + n], torch.ones(n, device=dev))
    assert not base[:offset].any() and not base[offset + n:].any()
    assert probe.hbm_write.launches == before + 1


def test_hbm_write_at_the_probe_shape(dev):
    """K14 at tools/mxu_probe.py's shape, (162,304, 4,096) fp32 (2.66 GB):
    every element exactly 1."""
    out = probe.hbm_write((162_304, 4_096), dev)
    assert out.shape == (162_304, 4_096) and bool((out == 1.0).all())


@pytest.mark.parametrize("k,t,u", [(20, 2048, 5000), (128, 2048, 5000), (128, 16384, 1500)])
def test_chunked_unique_tail_on_card_matches_cpu(dev, k, t, u):
    """The chunked unique tail (K > 16, no kernel: PyTorch on whichever
    device) on the card against the same call on the CPU: top-K identical
    on every row (dyadic inputs: exact logits, ties or gaps of at least
    1/64), marg and vals 1e-5, dh / dW / db 1e-4 (normwise), and bitwise
    equal run to run on the card."""
    rng = np.random.default_rng(k + t)
    h = (rng.integers(0, 5, (u, 64)) / 8).astype(np.float32)
    w = (rng.integers(-4, 5, (64, t)) / 16).astype(np.float32)
    b = (rng.integers(-8, 9, t) / 64).astype(np.float32)
    counts = rng.integers(0, 5, (4, u)).astype(np.float32)
    g_marg = rng.standard_normal((4, t)).astype(np.float32)
    g_vals = rng.standard_normal((u, k)).astype(np.float32)

    def run(device):
        x = [torch.tensor(a, device=device, requires_grad=i < 3)
             for i, a in enumerate((h, w, b, counts))]
        marg, vals, idx = fused_hpd.hpd_tail_unique(*x, k, "highest", False, "jax")
        (torch.sum(marg * torch.tensor(g_marg, device=device))
         + torch.sum(vals * torch.tensor(g_vals, device=device))).backward()
        return [marg.detach(), vals.detach(), idx] + [a.grad for a in x[:3]]

    card, cpu = run(dev), run("cpu")
    assert torch.equal(card[2].cpu(), cpu[2])
    for name, a, r, tol in zip(("marg", "vals", "", "dh", "dw", "db"), card, cpu,
                               (1e-5, 1e-5, 0, 1e-4, 1e-4, 1e-4)):
        if name:
            _close(a.cpu(), r, tol, name)
    assert all(torch.equal(a, c) for a, c in zip(card, run(dev)))


def _rowsum_inputs(dev, u, hd, t, seed=5, ints=False):
    rng = np.random.default_rng(seed)
    if ints:
        h, w = rng.integers(-3, 4, size=(u, hd)), rng.integers(-3, 4, size=(hd, t))
    else:
        h, w = rng.standard_normal((u, hd)) * 0.3, rng.standard_normal((hd, t)) * 0.1
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return f32(h), f32(w)


@pytest.mark.parametrize("regime", probe.REGIMES)
@pytest.mark.parametrize("hd,t", [(hd, t) for hd in (16, 64, 128) for t in (128, 384, 2048)]
                         + [(48, 384)])
@pytest.mark.parametrize("u", [1, 127, 129, 257, 333, 1001])
def test_rowsum_tilings_match_plain(dev, u, hd, t, regime):
    """K13's tilings (128-row blocks for 'highest' and 'bf16x3', 256 for
    'default' / 'bf16'; 128-column tiles) on U ragged against both, one to
    16 column tiles and the narrowest to the widest h (16 and 48: the fp32
    SGEMM's 32-deep slabs zero-filled past H), against the plain version,
    bitwise equal run to run. Each row is held to 1e-5 (bf16x3
    1e-4) of the sum of its products' magnitudes, sum_k,t |h| |w|: a row
    sum of H T mixed-sign products can cancel far below them (a single
    row's normwise scale), and only the order of the fp32 sums differs."""
    h, w = _rowsum_inputs(dev, u, hd, t)
    got = probe.rowsum_dot(h, w, regime)
    assert got.shape == (u, 1) and torch.isfinite(got).all()
    err = (got.double() - probe.rowsum_dot_plain(h, w, regime).double()).abs()
    mag = h.double().abs() @ w.double().abs().sum(1, keepdim=True)
    tol = 1e-4 if regime == "bf16x3" else 1e-5
    assert (err <= tol * mag).all(), f"{regime}: {(err / mag).max().item()} > {tol}"
    assert torch.equal(got, probe.rowsum_dot(h, w, regime))


@pytest.mark.parametrize("regime", probe.REGIMES)
@pytest.mark.parametrize("u,hd,t", [(333, 128, 2048), (129, 16, 384), (1, 64, 128)])
def test_rowsum_exact_on_small_integers(dev, u, hd, t, regime):
    """h, w integers in [-3, 3]: every product, every partial sum and every
    row sum is an integer below 2^24 (at most 9 * 128 * 2048), exact in fp32
    and in bf16 operands (lo = 0), so each regime must equal the float64
    result bit for bit, whatever its order of summation."""
    h, w = _rowsum_inputs(dev, u, hd, t, ints=True)
    got = probe.rowsum_dot(h, w, regime)
    assert torch.equal(got.double()[:, 0], (h.double() @ w.double()).sum(1))


@pytest.mark.parametrize("u,hd,t", [(1001, 64, 384), (333, 128, 2048), (129, 16, 128)])
def test_rowsum_default_is_bf16(dev, u, hd, t):
    """'default' and 'bf16' compute one function (bf16 products are exact in
    fp32) and run one kernel: equal bit for bit."""
    h, w = _rowsum_inputs(dev, u, hd, t)
    assert torch.equal(probe.rowsum_dot(h, w, "default"), probe.rowsum_dot(h, w, "bf16"))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 7, 1_000_003, 4 * 4 * 256 * 1056 + 9])
def test_scale_copy_edges(dev, n, offset):
    """K15 exactly 2 x at sizes below one float4, not a multiple of 4, and
    of 1,056 whole blocks (1,024 float4 each) plus a partial one and a
    scalar tail, from 16-byte aligned and unaligned addresses (the scalar
    path)."""
    base = torch.randn(n + 3, device=dev)
    x = base[offset:offset + n]
    before = probe.hbm_scale_copy.launches
    y = probe.hbm_scale_copy(x)
    assert torch.equal(y, x * 2) and probe.hbm_scale_copy.launches == before + 1


def _planted_select_inputs(dev, u=1024, t=2048, hd=128, gap=2e-5):
    """h, w, b whose rows 0, 8, 16, ... lift 8 columns above all others,
    within 1.4e-4 of each other (bias steps of 2e-5, below the rows pass's
    guard), and whose other rows hold an exact tie at the top (columns 300
    and 700) and a near tie at the 4th place (1200 and 450, 0.2 gap to gap
    apart) that only the fp32 recompute orders; w scaled by sqrt(128 /
    hd), so that the logits spread as at H = 128."""
    rng = np.random.default_rng(65535)
    h = rng.random((u, hd), dtype=np.float32) * 0.5
    h[:, 0], h[:, 1] = 1.0, 0.0
    h[::8, 1] = 1.0
    h[:, 2] = rng.choice([-1.0, 1.0], size=u) * rng.uniform(0.2, 1.0, size=u)
    w = rng.standard_normal((hd, t)).astype(np.float32) * np.float32(0.05 * (128 / hd) ** 0.5)
    w[0:3] = 0.0
    b = rng.standard_normal(t).astype(np.float32) * 0.05
    base = w[:, 300].copy()
    for col, bias in ((300, 3.0), (700, 3.0), (1500, 2.9), (1200, 2.0), (450, 2.0)):
        w[:, col], b[col] = base, bias
    w[2, 450] = gap
    for j, col in enumerate((1800, 60, 999, 1234, 77, 1600, 401, 1001)):
        w[:, col], w[1, col], b[col] = base, 10.0, (j * 37 % 8) * 2e-5
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return f32(h), f32(w), f32(b), (u + 7) // 8


@pytest.mark.parametrize("hd", [128, 256, 640])
def test_select_guard_hands_near_ties_to_the_fixup(dev, hd):
    """K4 and K1 on planted ties: top-K identical to the plain version on
    every row, exactly the lifted rows settled by the fp32 fix-up, bitwise
    equal run to run; past 128 on the chunked rows pass and the fix-up's
    chunked sweep, with near ties 2e-5 to 1e-4 apart (the fp32 sums of the
    kernel and of the plain version differ by a few 1e-6 at 640 terms)."""
    h, w, b, lifted = _planted_select_inputs(dev, hd=hd, gap=2e-5 if hd == 128 else 1e-4)
    counts = torch.ones(2, h.shape[0], device=dev)
    ref = hpd_stream.hpd_stream_select_plain(h, w, b, 4, "highest")
    assert (ref[1][1::8, :2] == torch.tensor([300, 700], device=dev, dtype=torch.int32)).all()
    out = hpd_stream.hpd_stream_select(h, w, b, 4)
    assert int(hpd_stream.hpd_stream_select.fixup_rows.item()) == lifted
    assert torch.equal(out[1], ref[1])
    for name, a, r in zip(("vals", "m", "s"), (out[0], *out[2:]), (ref[0], *ref[2:])):
        _close(a, r, 1e-5, name)
    assert all(torch.equal(a, b_) for a, b_ in zip(out, hpd_stream.hpd_stream_select(h, w, b, 4)))
    fused = hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, 4)
    assert int(hpd_stream.hpd_stream_fused_fwd.fixup_rows.item()) == lifted
    assert torch.equal(fused[2], ref[1])


@pytest.mark.parametrize("gather", ["gather_rows", "blend_unique", "lookup_topk_blend"])
def test_table_gradients_bitwise_on_card(dev, gather):
    """The encoding's gathers on the card: the table gradient (K12, the
    serial row-order sum) bitwise equal run to run and to the CPU's plain
    version, with a hot slot (raw-sum blend: the blend weights are the
    inputs themselves on both devices)."""
    from collision_handling_in_instantngp_tpu_torch.config import TopkBlendMode

    rng = np.random.default_rng(3)
    l, t, f, u, k, p = 4, 256, 2, 3000, 4, 20000
    cfg = ModelConfig(topk_blend=TopkBlendMode.RAW_SUM)
    tables = rng.standard_normal((l, t, f)).astype(np.float32)
    if gather == "gather_rows":
        table = rng.standard_normal((l, u, f)).astype(np.float32)
        ids = np.where(rng.random((p, l, 4)) < 0.3, 7, rng.integers(0, u, size=(p, l, 4)))
        g = rng.standard_normal((p, l, 4, f)).astype(np.float32)
        fn = lambda tab, d: encoding.gather_rows(tab, torch.as_tensor(ids, device=d))
    elif gather == "blend_unique":
        table = tables
        idx = np.where(rng.random((u, k)) < 0.3, 7, rng.integers(0, t, size=(u, k))).astype(np.int32)
        vals = (rng.random((u, k)) + 0.1).astype(np.float32)
        g = rng.standard_normal((l, u, f)).astype(np.float32)
        fn = lambda tab, d: encoding.blend_unique(tab, torch.as_tensor(idx, device=d),
                                                  torch.as_tensor(vals, device=d), cfg)
    else:
        table = tables
        idx = np.where(rng.random((p, l, 4, k)) < 0.3, 7, rng.integers(0, t, size=(p, l, 4, k)))
        vals = (rng.random((p, l, 4, k)) + 0.1).astype(np.float32)
        g = rng.standard_normal((p, l, 4, f)).astype(np.float32)
        fn = lambda tab, d: encoding.lookup_topk_blend(tab, torch.as_tensor(idx, device=d),
                                                       torch.as_tensor(vals, device=d), cfg)

    def grad(d):
        tab = torch.as_tensor(table, device=d).requires_grad_()
        (fn(tab, d) * torch.as_tensor(g, device=d)).sum().backward()
        return tab.grad

    before = scatter.scatter_add_serial.launches
    first, second = grad(dev), grad(dev)
    assert scatter.scatter_add_serial.launches == before + 2
    assert torch.equal(first, second)
    assert torch.equal(first.cpu(), grad("cpu"))
