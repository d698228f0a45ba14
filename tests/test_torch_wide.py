"""The width contract on the CPU: every kernel route of the port at a head
input of 256 (and K3 at widths up to 512) against the JAX package, on the
same numpy inputs; and the hidden-stack gate, which sends a stack to K3
exactly where the JAX package's gate (``ops/pallas/hidden.py: supports``)
sends it to its kernel, and to the plain stack elsewhere.

Each kernel's plain version (what its wrapper runs for a CPU tensor) is
held against the JAX Pallas kernel in interpret mode. Tolerances, normwise
(max |port - JAX| <= tol * max |JAX|; fp32 both sides, the summation order
differs): forward 1e-5, gradients 1e-4, top-K indices exactly equal.
"""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from collision_handling_in_instantngp_tpu.ops.pallas import hidden as jax_hidden
from collision_handling_in_instantngp_tpu.ops.pallas import hpd_full as jax_full
from collision_handling_in_instantngp_tpu.ops.pallas import hpd_stream as jax_stream
from collision_handling_in_instantngp_tpu.ops.pallas import hpd_tail as jax_tail
from collision_handling_in_instantngp_tpu_torch import config as tcfg
from collision_handling_in_instantngp_tpu_torch.models import hpd as port_hpd
from collision_handling_in_instantngp_tpu_torch.models.mlp import MLP, init_layers
from collision_handling_in_instantngp_tpu_torch.ops.cuda import hidden, hpd_full, hpd_stream, hpd_tail
from collision_handling_in_instantngp_tpu_torch.utils import prng

FWD, GRAD = 1e-5, 1e-4
WIDE = (2, 512, 256, 512, 128, 64)
HD, L, T = 256, 4, 2048          # the Pallas stream kernels need T % 2048 == 0


def _t(a):
    return torch.from_numpy(np.array(a))


def _normwise(got, ref, tol, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    assert np.isfinite(got).all(), name
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), f"{name}: {err} > {tol} * {np.abs(ref).max()}"


def _stack_inputs(rng, widths, u=300):
    x = rng.integers(0, 4, size=(u, widths[0])).astype(np.float32)
    layers = []
    for din, dout in zip(widths[:-1], widths[1:]):
        bound = 1.0 / np.sqrt(din)
        layers.append((rng.uniform(-bound, bound, (din, dout)).astype(np.float32),
                       rng.uniform(-bound, bound, dout).astype(np.float32)))
    return x, layers


def test_hidden_wide_fwd_matches_pallas(rng):
    x, layers = _stack_inputs(rng, WIDE)
    ref = jax_hidden.hidden_stack_pallas(
        jnp.asarray(x), tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in layers), "highest", True)
    out = hidden.hidden_stack_fwd(_t(x), [(_t(w), _t(b)) for w, b in layers])
    _normwise(out.numpy(), ref, FWD, "h")


def test_hidden_wide_bwd_matches_pallas(rng):
    x, layers = _stack_inputs(rng, WIDE)
    gh = rng.standard_normal((x.shape[0], WIDE[-1])).astype(np.float32) * 0.1
    jl = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in layers)
    ref = jax.grad(
        lambda ls: jnp.sum(jax_hidden.hidden_stack_pallas(jnp.asarray(x), ls, "highest", True) * gh)
    )(jl)
    params = [_t(a).requires_grad_() for pair in layers for a in pair]
    out = hidden.hidden_stack(_t(x), list(zip(params[0::2], params[1::2])))
    torch.sum(out * _t(gh)).backward()
    for i, (rw, rb) in enumerate(ref):
        _normwise(params[2 * i].grad.numpy(), rw, GRAD, f"dW{i}")
        _normwise(params[2 * i + 1].grad.numpy(), rb, GRAD, f"db{i}")


@pytest.mark.parametrize("widths,kernel", [((2, 32, 64, 128), True), ((2, 512, 8), True),
                                           ((2, 36, 64), False), ((2, 520), False),
                                           ((2, 64, 520, 64), False)])
def test_hidden_gate_routes_like_jax(monkeypatch, widths, kernel):
    """apply_hpd_unique takes K3 exactly where the JAX gate holds, and the
    plain stack (JAX's XLA stack) elsewhere, with the same result."""
    assert hidden.supports(widths) == jax_hidden.supports(widths) == kernel
    calls = []
    real = hidden.hidden_stack
    monkeypatch.setattr(hidden, "hidden_stack", lambda *a: calls.append(a) or real(*a))
    cfg = tcfg.ModelConfig(hash_table_size=2048, hpd_backend="unique_stream", topk_k=4,
                           hpd_hidden=widths[1:])
    net = MLP(init_layers(prng.prng_key(0), [widths[0], *widths[1:], cfg.hash_table_size]))
    rng = np.random.default_rng(3)
    ucoords = _t(rng.integers(0, 40, size=(50, widths[0])).astype(np.float32))
    counts = _t(rng.integers(0, 3, size=(2, 50)).astype(np.float32))
    marg, vals, idx = port_hpd.apply_hpd_unique(net, ucoords, cfg, counts)
    assert len(calls) == int(kernel)
    h = port_hpd.relu_stack(ucoords, net.layers()[:-1], "highest")
    ref = hpd_stream.hpd_stream_fused_fwd(h, *net.layers()[-1], counts, 4)
    _normwise(marg.detach().numpy(), ref[0].detach().numpy(), FWD, "marg")
    assert torch.equal(idx, ref[2])


def _stream_inputs(rng, k, u=300):
    h = (rng.random((u, HD)) * 0.2 / np.sqrt(2)).astype(np.float32)   # post-ReLU, O(1) logits
    w = rng.standard_normal((HD, T)).astype(np.float32) * 0.3
    b = rng.standard_normal(T).astype(np.float32) * 0.1
    counts = rng.integers(0, 5, size=(L, u)).astype(np.float32)
    g_marg = rng.standard_normal((L, T)).astype(np.float32)
    g_vals = rng.standard_normal((u, k)).astype(np.float32)
    return h, w, b, counts, g_marg, g_vals


@pytest.mark.parametrize("noop", [False, True])
def test_stream_fused_wide_matches_pallas(rng, noop):
    """K1/K2 at H = 256 (the fused gate holds at T = 2048)."""
    k = 4
    h, w, b, counts, g_marg, g_vals = _stream_inputs(rng, k)
    assert hpd_stream.fused_supports(T, k, HD)
    jh, jw, jb, jc = map(jnp.asarray, (h, w, b, counts))
    ref = jax_stream.hpd_stream_fused_fwd(jh, jw, jb, jc, k, interpret=True)
    out = hpd_stream.hpd_stream_fused_fwd(_t(h), _t(w), _t(b), _t(counts), k)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    for name, a, r in zip(("marg", "vals", "idx", "m", "s"), out, ref):
        if name != "idx":
            _normwise(a.numpy(), r, FWD, name)
    _, vals, idx, m, s = ref
    ref_b = jax_stream.hpd_stream_fused_bwd(jh, jw, jb, jc, idx, vals, m, s, jnp.asarray(g_marg),
                                            jnp.asarray(g_vals), k, noop_topk=noop, interpret=True)
    out_b = hpd_stream.hpd_stream_fused_bwd(
        _t(h), _t(w), _t(b), _t(counts), _t(idx), _t(vals), _t(m), _t(s), _t(g_marg),
        _t(g_vals), k, noop_topk=noop)
    for name, a, r in zip(("dh", "dw", "db"), out_b, ref_b):
        _normwise(a.numpy(), r, GRAD, name)


def test_stream_split_wide_matches_pallas(rng):
    """K4, K5 and K6 at H = 256."""
    k = 4
    h, w, b, counts, g_marg, g_vals = _stream_inputs(rng, k)
    jh, jw, jb, jc = map(jnp.asarray, (h, w, b, counts))
    ref = jax_stream.hpd_stream_select(jh, jw, jb, k, interpret=True)
    out = hpd_stream.hpd_stream_select(_t(h), _t(w), _t(b), k)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    for name, a, r in zip(("vals", "idx", "m", "s"), out, ref):
        if name != "idx":
            _normwise(a.numpy(), r, FWD, name)
    vals, idx, m, s = ref
    ref_m = jax_stream.hpd_stream_marginal(jh, jw, jb, jc, m, s, interpret=True)
    out_m = hpd_stream.hpd_stream_marginal(_t(h), _t(w), _t(b), _t(counts), _t(m), _t(s))
    _normwise(out_m.numpy(), ref_m, FWD, "marg")
    ref_b = jax_stream.hpd_tail_unique_pallas_bwd(
        jh, jw, jb, jc, idx, vals, m, s, jnp.asarray(g_marg), jnp.asarray(g_vals), k,
        interpret=True)
    out_b = hpd_stream.hpd_tail_unique_bwd(
        _t(h), _t(w), _t(b), _t(counts), _t(idx), _t(vals), _t(m), _t(s), _t(g_marg),
        _t(g_vals), k)
    for name, a, r in zip(("dh", "dw", "db"), out_b, ref_b):
        _normwise(a.numpy(), r, GRAD, name)


def test_per_row_tail_wide_matches_pallas(rng):
    """The "pallas" per-row route's K8/K9 at H = 256."""
    k, t, n = 4, 256, 600
    h = rng.standard_normal((2, n, HD)).astype(np.float32) * 0.5
    w = (rng.standard_normal((HD, t)) * 0.2 / np.sqrt(2)).astype(np.float32)
    b = rng.standard_normal(t).astype(np.float32) * 0.1
    g_marg = rng.standard_normal((2, t)).astype(np.float32)
    g_vals = rng.standard_normal((2, n, k)).astype(np.float32)
    jh, jw, jb = map(jnp.asarray, (h, w, b))
    ref = jax_tail.hpd_tail_pallas_fwd(jh, jw, jb, k, interpret=True)
    out = hpd_tail.hpd_tail_fwd(_t(h), _t(w), _t(b), k)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    _normwise(out[0].numpy(), ref[0], FWD, "marg")
    _normwise(out[1].numpy(), ref[1], FWD, "vals")
    ref_b = jax_tail.hpd_tail_pallas_bwd(jh, jw, jb, ref[2], jnp.asarray(g_marg),
                                         jnp.asarray(g_vals), k, interpret=True)
    out_b = hpd_tail.hpd_tail_bwd(_t(h), _t(w), _t(b), _t(ref[2]), _t(g_marg), _t(g_vals), k)
    for name, a, r in zip(("dh", "dw", "db"), out_b, ref_b):
        _normwise(a.numpy(), r, GRAD, name)


def test_per_row_full_wide_matches_pallas(rng):
    """The "pallas_full" per-row route's K10/K11 on the stack [2 -> 256 ->
    512 -> 256 -> T]: outputs, and the gradients of every layer."""
    k, n = 4, 400
    widths = (2, 256, 512, 256, 256)
    verts = rng.integers(0, 33, size=(2, n, 2)).astype(np.float32)
    layers = []
    for i, (din, dout) in enumerate(zip(widths[:-1], widths[1:])):
        scale = 0.5 / np.sqrt(din) if i < len(widths) - 2 else 0.2 / np.sqrt(2)
        layers.append(((rng.standard_normal((din, dout)) * scale).astype(np.float32),
                       (rng.standard_normal(dout) * 0.1).astype(np.float32)))
    gm = rng.standard_normal((2, widths[-1])).astype(np.float32)
    gv = rng.standard_normal((2, n, k)).astype(np.float32)
    jl = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in layers)
    ref = jax_full.hpd_full(jnp.asarray(verts), jl, k, True)
    ref_g = jax.grad(lambda ls: (lambda o: jnp.sum(o[0] * gm) + jnp.sum(o[1] * gv))(
        jax_full.hpd_full(jnp.asarray(verts), ls, k, True)))(jl)
    params = [_t(a).requires_grad_() for pair in layers for a in pair]
    marg, vals, idx = hpd_full.hpd_full(_t(verts), list(zip(params[0::2], params[1::2])), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[2]))
    _normwise(marg.detach().numpy(), ref[0], FWD, "marg")
    _normwise(vals.detach().numpy(), ref[1], FWD, "vals")
    (torch.sum(marg * _t(gm)) + torch.sum(vals * _t(gv))).backward()
    for i, (rw, rb) in enumerate(ref_g):
        _normwise(params[2 * i].grad.numpy(), rw, GRAD, f"dW{i}")
        _normwise(params[2 * i + 1].grad.numpy(), rb, GRAD, f"db{i}")


def test_wrappers_refuse_past_the_contract():
    """The wrappers' width limits, checked before any launch: the streamed
    tail takes a head input of 520 (any width to its grid limit), the
    per-row tail too, its backward raising only past its tile, naming the
    figure; K3 still refuses a hidden width past the JAX kernel's 512."""
    hpd_stream._check_inputs(torch.zeros(4, 520), torch.zeros(520, 2048), torch.zeros(2048),
                             torch.zeros(2, 4), 4)
    with pytest.raises(ValueError, match=f"H <= {hpd_stream.MAX_H}"):
        hpd_stream._check_inputs(torch.zeros(4, hpd_stream.MAX_H + 1), torch.zeros(1, 2048),
                                 torch.zeros(2048), torch.zeros(2, 4), 4)
    hpd_tail.check_inputs(torch.zeros(1, 4, 520), torch.zeros(520, 256), torch.zeros(256), 4, bwd=True)
    with pytest.raises(ValueError, match="H <= 3040 at T=256"):
        hpd_tail.check_inputs(torch.zeros(1, 4, 3041), torch.zeros(3041, 256), torch.zeros(256), 4,
                              bwd=True)
    with pytest.raises(ValueError, match="512"):
        hidden.hidden_stack_fwd(torch.zeros(4, 2), [(torch.zeros(2, 520), torch.zeros(520))])
