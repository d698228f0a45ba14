"""The port's ``tools/time_kernels.py`` on the CPU at small shapes: a row
for every kernel of the scaled step (the JAX tool's rows), each with its
bound from ``roofline.kernel_work`` and no share of it (the peaks are the
card's); without ``--device cpu`` it asks for the card and raises where
there is none."""

import pytest
import torch

from collision_handling_in_instantngp_tpu_torch.tools import roofline, time_kernels

SMALL = ["--device", "cpu", "--u", "1536", "--hd", "16", "--t", "512", "--l", "2", "--k", "4",
         "--u-compact", "1024", "--reps", "1"]


@pytest.fixture(scope="module")
def result():
    return time_kernels.main(SMALL)


def test_a_row_for_each_kernel(result):
    names = [r["name"] for r in result["rows"]]
    for tag in ("K1", "K2", "K3a", "K4", "K5", "K6", "K12"):
        assert any(f"({tag})" in n or f"({tag} " in n for n in names), tag
    assert sum("(K1)" in n for n in names) == 2 and sum("(K2)" in n for n in names) == 2
    assert any(n.startswith("blend fwd") for n in names)
    assert result["device"]["platform"] == "cpu"
    assert result["shapes"] == dict(u=1536, h=16, t=512, l=2, k=4, u_compact=1024)


def test_rows_carry_their_bounds(result):
    rows = {r["name"]: r for r in result["rows"]}
    for r in rows.values():
        assert r["ms"] > 0 and r["bound_ms"] > 0 and r["bound_by"] in ("operations", "bytes")
        assert "share_of_bound" not in r
        assert r["replaces"].startswith("collision_handling_in_instantngp_tpu/")
    want = roofline.kernel_work("K2", u=1024, h=16, t=512, l=2, k=4)
    assert rows["fused bwd @ compacted U (K2)"]["bound_ms"] == want["bound_ms"]
    want = roofline.kernel_work("K12", n=1536 * 4, c=4, t=512)
    assert rows["blend bwd (K12 ring)"]["bound_ms"] == want["bound_ms"]
    want = roofline.kernel_work("K3a", u=1536, widths=(2, 32, 64, 16))
    assert rows["hidden stack fwd (K3a)"]["bound_ms"] == want["bound_ms"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the raise where there is no card")
def test_raises_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        time_kernels.main(["--u", "1536"])


def test_rows_are_held_against_their_plain_versions(result):
    """Every kernel row carries its error against the plain version (0 on
    the CPU, where the wrapper is the plain version); the blend's gather
    has no kernel and no check."""
    for r in result["rows"]:
        if r["name"].startswith("blend fwd"):
            assert r["max_abs_err"] is None
        else:
            assert r["max_abs_err"] == 0.0, r["name"]
    ties = {r["name"]: r["near_ties"] for r in result["rows"]}
    assert ties["select kernel (K4)"] == 0 and ties["fused fwd kernel (K1)"] == 0


def test_the_checks_catch_a_disagreement():
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(64, 8, generator=gen)
    assert time_kernels.agree("same", [a], [a.clone()], 1e-5) == 0.0
    with pytest.raises(AssertionError, match="disagrees"):
        time_kernels.agree("off", [a + 1e-3 * a.abs().max()], [a], 1e-5)
    h, w, b = (torch.randn(32, 16, generator=gen), torch.randn(16, 128, generator=gen),
               torch.randn(128, generator=gen))
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_stream

    plain = hpd_stream.hpd_stream_select_plain(h, w, b, 4, "highest")
    assert time_kernels.near_ties("K4", h, w, b, plain[1], plain, "highest") == 0
    swapped = plain[1].clone()
    swapped[:, [0, 1]] = swapped[:, [1, 0]]        # two distinct values swapped: no tie
    with pytest.raises(AssertionError, match="top-K rows that differ"):
        time_kernels.near_ties("K4", h, w, b, swapped, plain, "highest")
