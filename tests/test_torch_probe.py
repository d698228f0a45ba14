"""The port's measurement path on the CPU: the probe kernels' plain versions
(K7 against the JAX package's Pallas kernel in interpret mode; K13 against
the jnp expressions of ``tools/mxu_probe.py``'s ``rowsum_kernel`` body;
K14, K15), the three ported tools at tiny shapes, and the profiling and
memory helpers.

Tolerances, normwise (max |port - ref| <= tol * max |ref|; fp32 both
sides, only the summation order differs): softmax m, s 1e-5; the dots row
sum 1e-4 (a sum of T mixed-sign logits, as the JAX package's own test of
the probe); K13 1e-5. At 'high' the bf16 hi/lo split of both sides is the
same, so 'high' is held to the same limits.
"""

import json
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from collision_handling_in_instantngp_tpu.ops.pallas import hpd_stream as jax_stream
from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_stream, probe
from collision_handling_in_instantngp_tpu_torch.ops.precision import bf16_round
from collision_handling_in_instantngp_tpu_torch.tools import (
    k11_phases, mxu_probe, probe_phases, profile_epoch, sweep_probe,
)
from collision_handling_in_instantngp_tpu_torch.utils import memory, profiling

SWEEP_KEYS = {"dots_ms", "softmax_ms", "select_ms", "full_ms", "exp_max_cost_ms",
              "topk_cache_cost_ms", "marginal_cost_ms"}
CAL_KEYS = {"highest", "default", "high", "hbm_stream", "hbm_rw", "fused_fwd_highest",
            "fused_bwd_highest"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _normwise(got, ref, tol, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert np.isfinite(got).all(), name
    assert err <= tol * np.abs(ref).max(), f"{name}: {err} > {tol} * {np.abs(ref).max()}"


def _probe_inputs(u, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(u, 8)).astype(np.float32)
    w = rng.normal(size=(8, 4096)).astype(np.float32)
    b = rng.normal(size=(1, 4096)).astype(np.float32)
    return h, w, b


@pytest.fixture
def one_torch_thread():
    """The port's side on one intra-op thread. With several, the first
    multi-threaded torch.exp of a process on a loaded machine computed one
    thread's chunk (65,536 of these 393,216 elements) with an exp about
    7e-5 off in relative terms, in 3 of about 500 fresh processes, the
    same wrong values each time: s then misses 1e-5 below. Repeats in one
    process never differed, nor any fresh run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("u", [96, 77])
@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("variant", ["softmax", "dots"])
def test_fused_probe_plain_matches_pallas(u, precision, variant, one_torch_thread):
    h, w, b = _probe_inputs(u)
    m_j, s_j = jax_stream.hpd_stream_fused_probe(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b),
                                                 precision, variant, interpret=True)
    m, s = hpd_stream.hpd_stream_fused_probe(_t(h), _t(w), _t(b), precision, variant)
    assert m.shape == s.shape == (u, 1)
    tol = 1e-4 if variant == "dots" else 1e-5
    _normwise(m.numpy(), m_j, tol, "m")
    _normwise(s.numpy(), s_j, tol, "s")
    if variant == "dots":
        assert torch.equal(m, s)


@pytest.mark.parametrize("variant", ["softmax", "dots"])
def test_fused_probe_plain_default_is_bf16_products(variant):
    """'default': one bf16-rounded product per term (JAX's CPU 'default'
    runs full fp32, so the reference is the rounded expression in fp64)."""
    h, w, b = _probe_inputs(96, seed=1)
    logits = (bf16_round(_t(h)).double() @ bf16_round(_t(w)).double() + _t(b).double()).numpy()
    m, s = hpd_stream.hpd_stream_fused_probe(_t(h), _t(w), _t(b[0]), "default", variant)
    if variant == "dots":
        ref_m = ref_s = logits.sum(1, keepdims=True)
    else:
        ref_m = logits.max(1, keepdims=True)
        ref_s = np.exp(logits - ref_m).sum(1, keepdims=True)
    tol = 1e-4 if variant == "dots" else 1e-5
    _normwise(m.numpy(), ref_m, tol, "m")
    _normwise(s.numpy(), ref_s, tol, "s")


def test_fused_probe_refuses_unknown_variant():
    h, w, b = _probe_inputs(8)
    with pytest.raises(ValueError, match="variant"):
        hpd_stream.hpd_stream_fused_probe(_t(h), _t(w), _t(b), "highest", "topk")


def _jax_rowsum(h, w, regime):
    """The body of tools/mxu_probe.py's rowsum_kernel over the whole array.
    The port's 'default' regime is one bf16 product per term, the bf16
    body (JAX's CPU 'default' dot runs full fp32)."""
    hh, ww = jnp.asarray(h), jnp.asarray(w)
    mm = lambda a, b_: jnp.dot(a, b_, preferred_element_type=jnp.float32, precision="default")
    if regime in ("bf16", "default"):
        d = mm(hh.astype(jnp.bfloat16), ww.astype(jnp.bfloat16))
    elif regime == "bf16x3":
        h_hi = hh.astype(jnp.bfloat16)
        h_lo = (hh - h_hi.astype(jnp.float32)).astype(jnp.bfloat16)
        w_hi = ww.astype(jnp.bfloat16)
        w_lo = (ww - w_hi.astype(jnp.float32)).astype(jnp.bfloat16)
        d = mm(h_hi, w_hi) + mm(h_hi, w_lo) + mm(h_lo, w_hi)
    else:
        d = jnp.dot(hh, ww, preferred_element_type=jnp.float32, precision="highest")
    return np.asarray(jnp.sum(d, axis=-1, keepdims=True))


@pytest.mark.parametrize("regime", probe.REGIMES)
def test_rowsum_plain_matches_jax_body(regime, monkeypatch):
    rng = np.random.default_rng(2)
    h = (rng.normal(size=(301, 32)) * 0.3).astype(np.float32)
    w = (rng.normal(size=(32, 512)) * 0.1).astype(np.float32)
    monkeypatch.setattr(probe, "PLAIN_CHUNK_ELEMS", 512 * 64)   # several row chunks, one ragged
    got = probe.rowsum_dot(_t(h), _t(w), regime)
    assert got.shape == (301, 1)
    _normwise(got.numpy(), _jax_rowsum(h, w, regime), 1e-5, regime)


def test_rowsum_regimes_differ_and_refuse_unknown():
    rng = np.random.default_rng(3)
    h, w = _t(rng.normal(size=(64, 16)).astype(np.float32)), _t(rng.normal(size=(16, 256)).astype(np.float32))
    exact = (h.double() @ w.double()).sum(1, keepdim=True)
    err = {r: (probe.rowsum_dot(h, w, r).double() - exact).abs().max().item() for r in probe.REGIMES}
    assert err["bf16"] == err["default"]                  # one function
    assert err["highest"] < err["bf16x3"] < err["bf16"]   # bf16x3 drops only lo * lo
    with pytest.raises(ValueError, match="regime"):
        probe.rowsum_dot(h, w, "tf32")


def test_hbm_plain_versions():
    ones = probe.hbm_write((3, 5), "cpu")
    assert ones.dtype == torch.float32 and torch.equal(ones, torch.ones(3, 5))
    x = torch.randn(7, 9)
    y = probe.hbm_scale_copy(x)
    assert torch.equal(y, x * 2) and y.data_ptr() != x.data_ptr()
    with pytest.raises(ValueError):
        probe.hbm_scale_copy(x.double())


def test_sweep_probe_main_cpu(tmp_path):
    out = tmp_path / "sweep.json"
    res = sweep_probe.main(["--device", "cpu", "--u", "96", "--hd", "8", "--t", "2048", "--l", "2",
                            "--reps", "1", "--json-out", str(out)])
    saved = json.loads(out.read_text())
    assert saved["device"] == {"platform": "cpu", "kind": "cpu", "gpu": None, "timer": "host_clock"}
    for prec in sweep_probe.PRECISIONS:
        assert set(saved[prec]) == SWEEP_KEYS
        assert saved[prec]["marginal_cost_ms"] == pytest.approx(
            res[prec]["full_ms"] - res[prec]["select_ms"])


def test_sweep_probe_data_is_the_jax_tools():
    """The JAX tool's numpy draw order: h, w, then counts."""
    rng = np.random.default_rng(65535)
    h_ref = rng.normal(size=(10, 4)).astype(np.float32)
    w_ref = rng.normal(size=(4, 2048), scale=0.1).astype(np.float32)
    c_ref = rng.integers(1, 5, size=(3, 10)).astype(np.float32)
    h, w, b, counts = sweep_probe.make_inputs(10, 4, 2048, 3, "cpu")
    assert np.array_equal(h.numpy(), h_ref) and np.array_equal(w.numpy(), w_ref)
    assert np.array_equal(counts.numpy(), c_ref) and b.shape == (1, 2048) and not b.any()


def test_mxu_probe_main_cpu(tmp_path):
    out = tmp_path / "cal.json"
    out.write_text(json.dumps({"other card": {"highest": 1.0}}))
    res = mxu_probe.main(["--device", "cpu", "--u", "100", "--hd", "16", "--t", "256",
                          "--reps", "1", "--json-out", str(out)])
    assert set(res) == CAL_KEYS
    cal = json.loads(out.read_text())
    assert set(cal) == {"other card", "cpu"}             # merged by device name
    assert CAL_KEYS <= set(cal["cpu"]) and cal["cpu"]["probe_shape"] == [100, 16, 256]


@pytest.mark.parametrize("mode", ["gngf", "gngf-dense", "vanilla", "scaled"])
def test_profile_epoch_main_cpu(tmp_path, capsys, mode):
    img = np.random.default_rng(0).integers(0, 256, size=(12, 10, 3)).astype(np.uint8)
    np.save(tmp_path / "tiny.npy", img)
    res = profile_epoch.main(["--device", "cpu", "--mode", mode, "--epochs", "1",
                              "--image", str(tmp_path / "tiny.npy"), "--logdir", str(tmp_path / "tr")])
    assert res["pixels_per_s"] > 0 and (tmp_path / "tr" / "trace.json").exists()
    assert len(res["epoch_seconds"]) == 1 and res["seconds"] == sum(res["epoch_seconds"])
    assert res["memory_gb"] == dict(allocated_gb=0.0, peak_gb=0.0, limit_gb=0.0)
    out = capsys.readouterr().out
    assert "px/s" in out and f"[mem] profile_epoch {mode}: allocated 0.00 GB" in out


@pytest.mark.parametrize("tool", [sweep_probe, mxu_probe, profile_epoch, k11_phases, probe_phases])
def test_tools_default_to_the_card(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["--json-out", ""] if tool in (sweep_probe, mxu_probe) else [])


def test_memory_stats_zero_on_cpu(capsys):
    assert memory.device_memory_stats("cpu") == dict(allocated_gb=0.0, peak_gb=0.0, limit_gb=0.0)
    assert memory.print_allocated_memory("tag") is None and capsys.readouterr().out == ""
    stats = memory.print_allocated_memory("tag", log=True, device="cpu")
    assert stats["allocated_gb"] == 0.0 and "[mem] tag: allocated 0.00 GB" in capsys.readouterr().out


def test_trace_and_device_time_on_cpu(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert (tmp_path / "trace.json").exists()
    summary = profiling.device_time_by_kernel(prof, 5.0)
    assert summary == dict(wall_ms=5.0, busy_ms=0.0, idle_share=1.0, kernels=[])


def test_device_time_by_kernel_sums_kernels_and_skips_annotations():
    from torch.autograd import DeviceType

    ev = lambda name, us, ann=False, dt=DeviceType.CUDA: types.SimpleNamespace(
        name=name, device_time_total=us, device_type=dt, is_user_annotation=ann)
    prof = types.SimpleNamespace(events=lambda: [
        ev("k1", 3000.0), ev("k2", 1000.0), ev("k1", 2000.0),
        ev("Optimizer.step", 9000.0, ann=True), ev("cpu_op", 7000.0, dt=DeviceType.CPU)])
    s = profiling.device_time_by_kernel(prof, 10.0)
    assert s["busy_ms"] == 6.0 and s["idle_share"] == pytest.approx(0.4)
    assert [(r["name"], r["ms"], r["calls"]) for r in s["kernels"]] == [("k1", 5.0, 2), ("k2", 1.0, 1)]
    assert s["kernels"][0]["share"] == pytest.approx(5 / 6)


def test_step_timer_syncs_through_a_host_copy():
    timer = profiling.StepTimer()
    timer.start()
    assert timer.stop(torch.ones(3)) >= 0.0
    with pytest.raises(RuntimeError):
        timer.stop()


_FAKE_SMOKE = '''import json, os, sys
ms = float(sys.argv[1]) if len(sys.argv) > 1 else {ms}
os.makedirs("chiprun_out", exist_ok=True)
fit = [dict(seconds={ms} / 100)] * 3
json.dump(dict(gpu="card, 700 W", fit=fit, profile=dict(idle_share=0.01), split_fit=fit,
               split_profile=dict(idle_share=0.02), per_row_fits=dict(auto=dict(history=fit)),
               per_row_profile=dict(idle_share=0.03)), open("chiprun_out/chip_smoke.json", "w"))
print(json.dumps(dict(kernels=[dict(name="{name}", ms={ms})])))
print(json.dumps(dict(ok=True)))
sys.exit({rc})
'''


def test_ab_smoke_orders_runs_and_tables_them(tmp_path, capsys):
    """tools/ab_smoke runs each checkout's chip_smoke.py in the given order,
    keeps each run's log and JSON, tables the kernels by name (a name one
    run lacks shows "-") and the epochs by phase; a failing run fails it."""
    from collision_handling_in_instantngp_tpu_torch.tools import ab_smoke

    dirs = {}
    for label, name, ms, rc in (("a", "k[ring]", 2.5, 0), ("b", "k", 4.0, 0), ("bad", "k", 1.0, 3)):
        d = tmp_path / label
        d.mkdir()
        (d / "chip_smoke.py").write_text(_FAKE_SMOKE.format(name=name, ms=ms, rc=rc))
        dirs[label] = str(d)
    out = tmp_path / "out"
    runs = [f"--run={k}={v}" for k, v in dirs.items()]
    assert ab_smoke.main([*runs, "--order", "b,a,a,b", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert [line.split()[1] for line in text.splitlines() if line.startswith("run ")] == \
        ["0_b:", "1_a:", "2_a:", "3_b:"]
    assert any(line.split() == ["k", "4.000", "-", "-", "4.000"] for line in text.splitlines())
    assert any(line.split() == ["k[ring]", "-", "2.500", "2.500", "-"] for line in text.splitlines())
    saved = json.loads((out / "ab.json").read_text())
    assert saved["order"] == ["b", "a", "a", "b"]
    assert saved["runs"][1]["phases"]["dedup T=2^14"] == dict(epoch_s=[0.025] * 3, idle_share=0.01)
    assert (out / "3_b.log").exists() and (out / "2_a.json").exists()
    with pytest.raises(RuntimeError, match="2_bad"):
        ab_smoke.main([*runs, "--order", "a,b,bad", "--out", str(out)])
    with pytest.raises(SystemExit):
        ab_smoke.main([*runs, "--order", "a,c"])


def test_ab_smoke_tables_digests_and_the_wide_fit(capsys):
    """tools/ab_smoke: the wide stack's --scaled fit joins the phases where
    a smoke has it (epoch s, idle share, K2's ms); the K2 / K6 digest table
    passes only where every run's sha256 is the same."""
    from collision_handling_in_instantngp_tpu_torch.tools import ab_smoke

    fit = [dict(seconds=0.5)] * 3
    smoke = dict(fit=fit, profile=dict(idle_share=0.01), split_fit=fit,
                 split_profile=dict(idle_share=0.02), per_row_fits=dict(auto=dict(history=fit)),
                 per_row_profile=dict(idle_share=0.03),
                 wide_fit=dict(dedup=dict(history=fit, profile=dict(idle_share=0.04, k2_ms=12.5))))
    assert ab_smoke.phases(smoke)[ab_smoke.WIDE_PHASE] == dict(epoch_s=[0.5] * 3, idle_share=0.04,
                                                                k2_ms=12.5)
    del smoke["wide_fit"]
    assert ab_smoke.WIDE_PHASE not in ab_smoke.phases(smoke)
    cell = lambda sha, ms: dict(sha256=sha, ms=ms)
    run = lambda sha: dict(digests=dict(shapes=dict(scaled128=dict(K2=cell(sha, 80.0),
                                                                   K6=cell("b" * 16, 90.0)))))
    assert ab_smoke.digest_table([run("a" * 16), run("a" * 16)], ("scaled128",))
    assert not ab_smoke.digest_table([run("a" * 16), run("c" * 16)], ("scaled128",))
    assert ab_smoke.digest_table([run("a" * 16), run("c" * 16)], ())   # timed only
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("K2 scaled128") and lines[0].endswith("(equal)")
    assert any(line.endswith("(DIFFER)") for line in lines)
