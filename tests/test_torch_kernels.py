"""The port's kernel modules on the CPU: each kernel's plain PyTorch version
(what the wrapper runs for a CPU tensor) against the JAX package's Pallas
kernel in interpret mode, on the same numpy inputs.

Tolerances at 'highest' (fp32 both sides, summation order differs):
forward rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5, top-K
indices exactly equal. Inputs are scaled so every product term is O(1):
then an fp32 reordering error stays near 1e-7 of the term size and these
absolute floors hold even for outputs near zero.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from collision_handling_in_instantngp_tpu.ops.fused_hpd import hpd_tail_unique as jax_tail
from collision_handling_in_instantngp_tpu.ops.pallas import hidden as jax_hidden
from collision_handling_in_instantngp_tpu.ops.pallas import hpd_stream as jax_stream
from collision_handling_in_instantngp_tpu_torch.ops.cuda import hidden, hpd_stream
from collision_handling_in_instantngp_tpu_torch.ops.fused_hpd import hpd_tail_unique
from collision_handling_in_instantngp_tpu_torch.ops.precision import pdot

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
U, H, L, T = 300, 128, 4, 2048   # T: the Pallas kernels need T % 2048 == 0


def _t(a):
    return torch.from_numpy(np.array(a))


def _stream_inputs(rng, k, u=U):
    h = rng.random((u, H), dtype=np.float32) * 0.2           # post-ReLU, O(1) logits
    w = rng.standard_normal((H, T)).astype(np.float32) * 0.3
    b = rng.standard_normal(T).astype(np.float32) * 0.1
    counts = rng.integers(0, 5, size=(L, u)).astype(np.float32)
    g_marg = rng.standard_normal((L, T)).astype(np.float32)
    g_vals = rng.standard_normal((u, k)).astype(np.float32)
    return h, w, b, counts, g_marg, g_vals


@pytest.mark.parametrize("k", [1, 4])
def test_fused_fwd_plain_matches_pallas(rng, k):
    h, w, b, counts, _, _ = _stream_inputs(rng, k)
    ref = jax_stream.hpd_stream_fused_fwd(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), jnp.asarray(counts), k,
        interpret=True,
    )
    out = hpd_stream.hpd_stream_fused_fwd(_t(h), _t(w), _t(b), _t(counts), k)
    names = ("marg", "vals", "idx", "m", "s")
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    for name, a, r in zip(names, out, ref):
        if name != "idx":
            np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name, **FWD)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("noop", [False, True])
def test_fused_bwd_plain_matches_pallas(rng, k, noop):
    h, w, b, counts, g_marg, g_vals = _stream_inputs(rng, k)
    jh, jw, jb, jc = map(jnp.asarray, (h, w, b, counts))
    _, vals, idx, m, s = jax_stream.hpd_stream_fused_fwd(jh, jw, jb, jc, k, interpret=True)
    ref = jax_stream.hpd_stream_fused_bwd(
        jh, jw, jb, jc, idx, vals, m, s, jnp.asarray(g_marg), jnp.asarray(g_vals), k,
        noop_topk=noop, interpret=True,
    )
    out = hpd_stream.hpd_stream_fused_bwd(
        _t(h), _t(w), _t(b), _t(counts), _t(idx), _t(vals), _t(m), _t(s),
        _t(g_marg), _t(g_vals), k, noop_topk=noop,
    )
    for name, a, r in zip(("dh", "dw", "db"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name, **GRAD)


def test_tail_autograd_matches_jax_vjp(rng):
    """The autograd Function wires K1/K2 like the JAX custom VJP: gradients
    of <marg, g_marg> + <vals, g_vals> agree."""
    k = 4
    h, w, b, counts, g_marg, g_vals = _stream_inputs(rng, k)

    def jax_scalar(h_, w_, b_):
        marg, vals, _ = jax_tail(h_, w_, b_, jnp.asarray(counts), k, "highest", False,
                                 None, "pallas_interpret")
        return jnp.sum(marg * g_marg) + jnp.sum(vals * g_vals)

    ref = jax.grad(jax_scalar, argnums=(0, 1, 2))(*map(jnp.asarray, (h, w, b)))
    th, tw, tb = (_t(a).clone().requires_grad_() for a in (h, w, b))
    marg, vals, _ = hpd_tail_unique(th, tw, tb, _t(counts), k, "highest", False, "fused")
    (torch.sum(marg * _t(g_marg)) + torch.sum(vals * _t(g_vals))).backward()
    for name, a, r in zip(("dh", "dw", "db"), (th.grad, tw.grad, tb.grad), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name, **GRAD)


def test_planted_tie_selects_lowest_index(rng):
    """Equal w columns AND equal b entries make exactly equal logits; the
    lowest planted index must come first, in the plain version and in the
    Pallas kernel."""
    k = 4
    h, w, b, counts, _, _ = _stream_inputs(rng, k, u=64)
    hi, lo = 1500, 37                         # planted pair, across two column tiles
    w[:, hi] = w[:, lo] = np.abs(w).max(axis=1) * 3.0   # the row's largest logit
    b[hi] = b[lo] = 1.0
    out = hpd_stream.hpd_stream_fused_fwd(_t(h), _t(w), _t(b), _t(counts), k)
    idx = out[2].numpy()
    assert (idx[:, 0] == lo).all() and (idx[:, 1] == hi).all()
    np.testing.assert_array_equal(out[1][:, 0].numpy(), out[1][:, 1].numpy())
    ref = jax_stream.hpd_stream_fused_fwd(
        *map(jnp.asarray, (h, w, b, counts)), k, interpret=True
    )
    np.testing.assert_array_equal(idx, np.asarray(ref[2]))


@pytest.mark.parametrize("precision", ["high", "default"])
def test_other_precisions_accepted(rng, precision):
    """'high' is the same 3-term bf16 split as the Pallas kernels' and agrees
    with them to ~2^-16 of a term; 'default' (one bf16 product) is only
    checked to run and stay finite: the CPU interpreter computes it in fp32."""
    k = 4
    h, w, b, counts, g_marg, g_vals = _stream_inputs(rng, k)
    out = hpd_stream.hpd_stream_fused_fwd(_t(h), _t(w), _t(b), _t(counts), k, precision)
    grads = hpd_stream.hpd_stream_fused_bwd(
        _t(h), _t(w), _t(b), _t(counts), out[2], out[1], out[3], out[4], _t(g_marg),
        _t(g_vals), k, precision,
    )
    assert all(torch.isfinite(t).all() for t in (*out[:2], *out[3:], *grads))
    x = rng.integers(0, 4, size=(200, 2)).astype(np.float32)
    layers = _hidden_layers(rng)
    h_out = hidden.hidden_stack_fwd(_t(x), layers, precision)
    assert torch.isfinite(h_out).all()
    if precision == "high":
        ref = jax_stream.hpd_stream_fused_fwd(
            *map(jnp.asarray, (h, w, b, counts)), k, precision="high", interpret=True
        )
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-4, atol=1e-5)


def test_pdot_high_is_three_bf16_terms(rng):
    a = _t(rng.standard_normal((8, 16)).astype(np.float32))
    b_ = _t(rng.standard_normal((16, 4)).astype(np.float32))
    exact = (a.double() @ b_.double()).float()
    # hi/lo rounding leaves ~2^-16 of each O(1) term; 16 terms
    np.testing.assert_allclose(pdot(a, b_, "high").numpy(), exact.numpy(), rtol=1e-4, atol=1e-4)
    assert (pdot(a, b_, "default") - exact).abs().max() > 1e-4   # bf16 really rounds


def _hidden_layers(rng, widths=(2, 32, 64, 128)):
    layers = []
    for din, dout in zip(widths[:-1], widths[1:]):
        bound = 1.0 / np.sqrt(din)
        layers.append((
            _t(rng.uniform(-bound, bound, (din, dout)).astype(np.float32)),
            _t(rng.uniform(-bound, bound, dout).astype(np.float32)),
        ))
    return layers


def test_hidden_fwd_plain_matches_pallas(rng):
    x = rng.integers(0, 4, size=(1500, 2)).astype(np.float32)   # not a block multiple
    layers = _hidden_layers(rng)
    ref = jax_hidden.hidden_stack_pallas(
        jnp.asarray(x), tuple((jnp.asarray(w.numpy()), jnp.asarray(b.numpy())) for w, b in layers),
        "highest", True,
    )
    out = hidden.hidden_stack_fwd(_t(x), layers)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)


def test_hidden_bwd_plain_matches_pallas(rng):
    x = rng.integers(0, 4, size=(1500, 2)).astype(np.float32)
    layers = _hidden_layers(rng)
    gh = rng.standard_normal((1500, 128)).astype(np.float32) * 0.1
    jl = tuple((jnp.asarray(w.numpy()), jnp.asarray(b.numpy())) for w, b in layers)
    ref = jax.grad(
        lambda ls: jnp.sum(jax_hidden.hidden_stack_pallas(jnp.asarray(x), ls, "highest", True) * gh)
    )(jl)
    params = [t.clone().requires_grad_() for pair in layers for t in pair]
    tx = _t(x).clone().requires_grad_()
    out = hidden.hidden_stack(tx, list(zip(params[0::2], params[1::2])))
    torch.sum(out * _t(gh)).backward()
    for i, (rw, rb) in enumerate(ref):
        np.testing.assert_allclose(params[2 * i].grad.numpy(), np.asarray(rw), err_msg=f"dW{i}", **GRAD)
        np.testing.assert_allclose(params[2 * i + 1].grad.numpy(), np.asarray(rb), err_msg=f"db{i}", **GRAD)
    assert (tx.grad == 0).all()   # vertex coords are data


def test_hidden_bwd_relu_mask_is_pre_ge_zero():
    """A pre-activation of exactly 0 passes the gradient (the kernel's rule),
    where torch.relu's gradient would block it."""
    x = torch.tensor([[1.0, 0.0]])
    w = torch.zeros(2, 8)                          # the kernels' least hidden width
    w[0, 0] = 1.0
    b = torch.full((8,), -1.0)                     # pre = 0 exactly in column 0
    (dw, db), = hidden.hidden_stack_bwd(x, [(w, b)], torch.ones(1, 8))
    assert db[0].item() == 1.0 and dw[0, 0].item() == 1.0
    assert (db[1:] == 0).all()                     # pre = -1 blocks it


def test_kernel_shape_checks_raise():
    """Shapes the kernels do not take raise before any launch: a head past
    the streamed tail's grid limit, T not a multiple of the column tile,
    and a K3 width that is not a multiple of 8 (or past 512) given to the
    wrapper."""
    h, w, b, c = torch.zeros(4, 520), torch.zeros(520, 2048), torch.zeros(2048), torch.zeros(2, 4)
    hpd_stream._check_inputs(h, w, b, c, 4)                 # H = 520 is taken (any H to MAX_H)
    with pytest.raises(ValueError):
        hpd_stream._check_inputs(torch.zeros(1, hpd_stream.MAX_H + 1), w[:1], b, torch.zeros(2, 1), 4)
    with pytest.raises(ValueError):
        hpd_stream._check_inputs(torch.zeros(4, 128), torch.zeros(128, 2000), torch.zeros(2000), c, 4)
    with pytest.raises(ValueError):                        # a hidden width of 36
        hidden.hidden_stack_fwd(torch.zeros(4, 2), [(torch.zeros(2, 36), torch.zeros(36))])
    with pytest.raises(ValueError):                        # a hidden width of 520
        hidden.hidden_stack_bwd(torch.zeros(4, 2), [(torch.zeros(2, 520), torch.zeros(520))],
                                torch.zeros(4, 520))
