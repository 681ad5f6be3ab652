"""The yardstick's counts: the tile kernel's bound and the solve's
operations."""

import pytest

from portbench import flops
from portbench.peaks import H100


def test_tile_bound_at_256_tiles():
    seconds, by = flops.tile_bound_s(256)
    bytes_ = 256 * (64 * 65 // 2 + 2 * 64 * 64) * 4
    ops = 256 * 2 * 64 ** 3 / 3
    assert bytes_ / 1e6 == pytest.approx(10.52, abs=0.005)
    assert ops / 1e6 == pytest.approx(44.7, abs=0.05)
    assert by == "bytes"
    assert seconds == pytest.approx(bytes_ / H100["bytes_per_s"])
    assert seconds * 1e3 == pytest.approx(0.00314, abs=0.00001)


def test_solve_count_by_hand_at_two_nodes():
    """N = 2, no soft rows, one refinement, one SQP and one IPM iteration,
    counted term by term."""
    walk = {"N": 2, "condip_soft": False, "sqp_iters": 1, "pdip_iters": 1,
            "pdip_refine": 1}
    # dense rows: lyap widths 32, 64; mom 32; height 0, 32; boxes node 1
    # (x3) and node 2 (x3) on each side; hard rows = lyap + mom + height,
    # then box, -box
    box = [32, 32, 32, 64, 64, 64] * 2
    C = [32, 64, 32, 0, 32] + box + box
    n = 64
    cmv = 2 * (sum(C) + 2 * 40 * 24)
    newton = (sum(w * (w + 1) + w for w in C) + 2 * 40 * (24 * 25 + 24)
              + n * (n + 1) // 2)
    ipm = (newton + n ** 3 / 3 + 2 * 2 * 2 * n * n + 2 * 2 * n * n
           + 6 * cmv + 2 * n * n)
    E = 1 * 2 * 20 * 20 * 32
    hess = (1 + 3) * 2 * 32 * 20 * 32 + 3 * 20 * 32
    grad = 3 * 2 * 20 * 32 + 2 * 2 * 32 * 32
    soft = 3 * (4 * 32 * 33 + 32 * 32) + 3 * (4 * 64 * 65 + 32 * 64) \
        + 3 * 32 * 33
    rows = (4 * 20 * 32 + 32) + (4 * 20 * 64 + 32) + 6 * 32
    final = 2 * 2 * (sum(C) + 2 * 40 * 24) + 2 * n * n
    assert flops.solve_flops(walk) == pytest.approx(
        E + hess + grad + soft + rows + ipm + final)


def test_solve_count_scales_with_iterations():
    walk = {"N": 10, "condip_soft": False, "sqp_iters": 3, "pdip_iters": 8,
            "pdip_refine": 1}
    terms = flops.solve_terms(walk)
    one = flops.solve_terms(dict(walk, sqp_iters=1))
    for k, v in terms.items():
        assert v == pytest.approx(3 * one[k]), k
    assert terms["ipm.cholesky"] == pytest.approx(3 * 8 * 320 ** 3 / 3)
