"""The per-row kernels' shared-memory plan and the compact backward layout
on the CPU.

``hpd_full.py`` restates ``hpd_full.cu``'s plan (tile_floats, tile_rpt,
bwd_padded, supports), which decides the per-row route before any launch
(``models/hpd.py: fused_backend``). The plan is pinned here, floats and
all, for each stack K10/K11 took and for stacks whose backward takes the
compact layout (strides w + 1, as no stack of the other tests does), so
that it cannot drift without a test saying so. The plain K10 and K11 are
held to the JAX package's ``hpd_full`` (Pallas, interpret mode) at such a
stack: identical top-K indices, the forward at the reductions' tolerance
of ``tests/test_torch_per_row.py`` (rtol 1e-5 / atol 1e-6), every
gradient within 1e-5 normwise (max |port - JAX| <= 1e-5 max |JAX|, ten
times finer than the card's check). That file's forward atol 1e-6 and
elementwise gradient rtol 1e-5 / atol 5e-5 are too fine for this stack,
not for the port: its 512-wide layer takes the logits to +-17, p to 0.66
and dW to 44, where fp32 rounding leaves either side about 2e-6 of p from
float64 (plain 1.6e-6, JAX 2.0e-6) and one dW1 element of 0.38 parts by
5.8e-5 between them (normwise at most 2.9e-6), at this test's inputs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from collision_handling_in_instantngp_tpu.ops.pallas import hpd_full as jax_full
from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_full

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD_NORMWISE = 1e-5
COMPACT = (2, 13, 100, 512, 256)   # odd width, past 128 wide, 32-row tile, compact backward

# widths, K, supports, tile_rpt, (forward, backward) floats at tile_rpt (1
# where no tile fits), the padded backward's floats, bwd_padded
PLAN = [((2, 32, 64, 128, 256), 4, True, 4, (51329, 57472), 58048, True),
        ((2, 8, 16, 128), 32, True, 4, (42897, 37312), 30528, True),
        ((3, 16, 24, 40, 96, 512), 4, True, 2, (30177, 31744), 31104, True),
        ((3, 24, 37, 203), 8, True, 4, (49137, 46667), 41419, True),
        ((2, 256, 512, 256, 256), 4, True, 1, (25793, 37808), 38000, True),
        ((2, 512, 512, 2048), 4, False, 0, (56513, 64208), 64304, False),
        (COMPACT, 4, True, 2, (46721, 57984), 58592, False),
        ((2, 37, 300, 400, 2048), 4, True, 1, (53329, 58096), 58352, False)]


@pytest.mark.parametrize("widths,k,supported,rpt,floats,padded_bwd,padded", PLAN)
def test_stack_plan_is_pinned(widths, k, supported, rpt, floats, padded_bwd, padded):
    """supports, tile_rpt, tile_floats (compact and padded) and bwd_padded
    answer as pinned."""
    assert hpd_full.supports(widths, k) == supported
    assert hpd_full.tile_rpt(widths) == rpt
    at = max(rpt, 1)
    assert hpd_full.tile_floats(widths, at) == floats
    assert hpd_full.tile_floats(widths, at, padded=True) == (floats[0], padded_bwd)
    assert hpd_full.bwd_padded(widths) == padded
    if rpt:   # the route fits both tiles; the padded one where it fits too
        assert 4 * max(floats) <= hpd_full.SMEM_MAX
        assert padded == (4 * padded_bwd <= hpd_full.SMEM_MAX)


def test_a_pinned_stack_takes_the_compact_layout():
    compact = [w for w, _, ok, rpt, _, _, padded in PLAN if ok and rpt and not padded]
    assert COMPACT in compact and len(compact) >= 2


def test_full_plain_matches_pallas_at_the_compact_stack():
    """K10/K11 plain versions against hpd_full in interpret mode at the
    compact stack, 2 levels x 96 rows: outputs, and jax.grad over every
    layer through the autograd Function."""
    rng = np.random.default_rng(65535)
    l, n, k, widths = 2, 96, 4, COMPACT
    verts = rng.integers(0, 33, size=(l, n, widths[0])).astype(np.float32)
    layers = []
    for i, (din, dout) in enumerate(zip(widths[:-1], widths[1:])):
        scale = 0.5 / np.sqrt(din) if i < len(widths) - 2 else 0.2
        layers.append(((rng.standard_normal((din, dout)) * scale).astype(np.float32),
                       (rng.standard_normal(dout) * 0.1).astype(np.float32)))
    t = widths[-1]
    gm = rng.standard_normal((l, t)).astype(np.float32)
    gv = rng.standard_normal((l, n, k)).astype(np.float32)
    jl = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in layers)
    ref = jax_full.hpd_full(jnp.asarray(verts), jl, k, True)

    def jax_scalar(ls):
        marg, vals, _ = jax_full.hpd_full(jnp.asarray(verts), ls, k, True)
        return jnp.sum(marg * gm) + jnp.sum(vals * gv)

    ref_g = jax.grad(jax_scalar)(jl)
    params = [torch.from_numpy(a).clone().requires_grad_() for pair in layers for a in pair]
    tv = torch.from_numpy(verts).clone().requires_grad_()
    out = hpd_full.hpd_full(tv, list(zip(params[0::2], params[1::2])), k)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(ref[0]), err_msg="marg", **FWD)
    np.testing.assert_allclose(out[1].detach().numpy(), np.asarray(ref[1]), err_msg="vals", **FWD)
    (torch.sum(out[0] * torch.from_numpy(gm)) + torch.sum(out[1] * torch.from_numpy(gv))).backward()
    for i, (rw, rb) in enumerate(ref_g):
        for name, got, want in ((f"dW{i}", params[2 * i].grad, rw), (f"db{i}", params[2 * i + 1].grad, rb)):
            want = np.asarray(want, np.float64)
            err = np.abs(got.numpy().astype(np.float64) - want).max()
            assert err <= GRAD_NORMWISE * np.abs(want).max(), (name, err, np.abs(want).max())
    assert (tv.grad == 0).all()


def test_digest_stacks_cover_every_tile():
    """tools/per_row_digests' stacks: all taken by the kernels, one at each
    tile height, one with K11's compact layout; inputs the same bits from
    the seed, of the shapes K10/K11 take."""
    from collision_handling_in_instantngp_tpu_torch.tools import per_row_digests

    stacks = per_row_digests.STACKS
    assert all(hpd_full.supports(w, k) for w, k, _, _ in stacks.values())
    assert {hpd_full.tile_rpt(w) for w, _, _, _ in stacks.values()} == {1, 2, 4}
    assert not hpd_full.bwd_padded(stacks["compact"][0]) and stacks["compact"][0] == COMPACT
    assert stacks["route"] == ((2, 32, 64, 128, 256), 4, 4, 229_616)
    a = per_row_digests.stack_inputs("odd", torch.device("cpu"))
    b = per_row_digests.stack_inputs("odd", torch.device("cpu"))
    (widths, k, l, n) = stacks["odd"]
    assert a[0].shape == (l, n, widths[0]) and a[4] == k and a[3].shape == (l, n, k)
    assert [tuple(w.shape) for w, _ in a[1]] == list(zip(widths[:-1], widths[1:]))
    assert all(torch.equal(x, y) for x, y in zip([a[0], a[2], a[3], *[t for p in a[1] for t in p]],
                                                 [b[0], b[2], b[3], *[t for p in b[1] for t in p]]))


def test_digest_table_passes_only_equal_digests(capsys):
    from collision_handling_in_instantngp_tpu_torch.tools import per_row_digests

    cell = lambda sha: dict(sha256=sha, ms=1.0)
    run = lambda sha: dict(stacks=dict(route=dict(K10=cell("a" * 16), K11=cell(sha))),
                           K8=cell("b" * 16))
    assert per_row_digests.digest_table([run("c" * 16), run("c" * 16)])
    assert not per_row_digests.digest_table([run("c" * 16), run("d" * 16)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("K10 route") and lines[0].endswith("(equal)")
    assert any(line.startswith("K11 route") and line.endswith("(DIFFER)") for line in lines)


def test_per_row_digests_needs_the_card():
    from collision_handling_in_instantngp_tpu_torch.tools import per_row_digests

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        per_row_digests.main([])
