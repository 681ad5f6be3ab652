"""The interior point's Newton matrix (``ops/pdip.newton_matrix``) on the
CPU: the plain expression the card's kernel (``csrc/newton_matrix.cu``) is
held to is the one the interior point always used; the wrapper's argument
check refuses what the kernel cannot take before any launch; and the rows
the kernel leaves out on a tile (``CondensedQP.C_width``, which
``condense.build`` hands on beside C) are exactly 0 there in every QP the
condip solve builds, so the kernel's sum is the dense sum.  The kernel itself is tested on the card
(``tests/test_torch_cuda.py``)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from cmpc_tpu_torch.config import WalkConfig, nominal_scenario
from cmpc_tpu_torch.ocp import assemble, condense, problem
from cmpc_tpu_torch.ops import pdip, sqp
from cmpc_tpu_torch.plan import com_ref as crm, footsteps, timing as tm

# the suite runs several worker processes per host: one intra-op thread
# each (more only oversubscribes the cores and slows every worker)
torch.set_num_threads(1)

CFG = WalkConfig()
ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "walk_x0.npz")
# stance, the tick after a landing, swing, late double support
TICKS = np.array([150, 262, 300, 420])


def _qp(seed, B=3, n=320, m_d=141, blk=True, dtype=torch.float64):
    """Random (H, C, dscale, C_blk) of the condensed QP's shapes."""
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(B, n, n, generator=g, dtype=dtype)
    H = X + X.transpose(1, 2)
    C = torch.randn(B, m_d, n, generator=g, dtype=dtype)
    Nb, rb, cb = (10, 40, 24) if blk else (0, 0, 0)
    dscale = torch.exp(torch.rand(B, m_d + Nb * rb, generator=g,
                                  dtype=dtype) * 18.0 - 9.0)
    C_blk = torch.randn(B, Nb, rb, cb, generator=g, dtype=dtype) \
        if blk else None
    return H, C, dscale, C_blk


@pytest.mark.parametrize("blk", [True, False], ids=["C_blk", "dense_only"])
def test_ref_is_the_expression_the_interior_point_used(blk):
    """newton_matrix_ref, and newton_matrix on a CPU tensor, equal bit for
    bit the expression pdip_solve formed inline before the kernel (f64)."""
    H, C, dscale, C_blk = _qp(1, blk=blk)
    B, n = H.shape[0], H.shape[-1]
    m_d, reg = C.shape[1], 1e-8
    eye_n = torch.eye(n, dtype=H.dtype)
    if blk:
        Nb, rb, cb = C_blk.shape[1:]
        bcols = torch.as_tensor((32 * np.arange(Nb))[:, None]
                                + np.arange(cb)[None])
        dd, db = dscale[:, :m_d], dscale[:, m_d:].reshape(B, Nb, rb)
        want = H + (C.transpose(-1, -2) * dd[:, None, :]) @ C + reg * eye_n
        Bk = torch.einsum("bnrc,bnr,bnrd->bncd", C_blk, db, C_blk)
        want[:, bcols[:, :, None], bcols[:, None, :]] += Bk
    else:
        want = H + (C.transpose(-1, -2) * dscale[:, None, :]) @ C \
            + reg * eye_n
    assert torch.equal(pdip.newton_matrix_ref(H, C, dscale, reg, C_blk), want)
    assert torch.equal(pdip.newton_matrix(H, C, dscale, reg, C_blk), want)


def _bad_inputs():
    H, C, dscale, C_blk = _qp(2, B=2, n=64, m_d=9, blk=False)
    Hb, Cb, db, Wb = _qp(3, B=2)
    return {
        "rank": ((H[0], C, dscale), ValueError, "takes H"),
        "H_not_square": ((H[:, :, :32], C, dscale), ValueError, "takes H"),
        "C_columns": ((H, C[:, :, :32], dscale), ValueError, "do not match"),
        "dscale_length": ((H, C, dscale[:, :5]), ValueError, "do not match"),
        "C_blk_rank": ((Hb, Cb, db, Wb[:, 0]), ValueError, "C_blk"),
        "C_blk_wider_than_a_slab": ((Hb, Cb, db[:, :141 + 400],
                                     torch.zeros(2, 10, 40, 40,
                                                 dtype=Hb.dtype)),
                                    ValueError, "do not fit"),
        "C_blk_past_n": ((Hb[:, :256, :256], Cb[:, :, :256], db, Wb),
                         ValueError, "do not fit"),
        "widths_count": ((H, C, dscale, None, (64,) * 8), ValueError,
                         "widths"),
        "widths_past_n": ((H, C, dscale, None, (65,) * 9), ValueError,
                          "widths"),
        "dtype_half": ((H.half(), C.half(), dscale.half()), TypeError,
                       "f32 or f64"),
        "dtype_mixed": ((H, C.float(), dscale), TypeError, "do not match"),
        "device": ((H, C.to("meta"), dscale), ValueError, "devices"),
        "column_stride": ((H.transpose(1, 2), C, dscale), ValueError,
                          "contiguous rows"),
        "C_column_stride": ((H, torch.randn(2, 64, 9, dtype=H.dtype)
                             .transpose(1, 2), dscale), ValueError,
                            "contiguous rows"),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_argument_check_refuses_before_any_launch(case):
    """_check_newton_matrix, which the CUDA route runs before it launches,
    refuses each of these on CPU tensors."""
    args, err, match = _bad_inputs()[case]
    with pytest.raises(err, match=match):
        pdip._check_newton_matrix(*args)


def test_argument_check_takes_strided_rows():
    """Views with longer rows and scenario strides pass, with their own
    strides handed to the kernel."""
    H, C, dscale, C_blk = _qp(4, B=2)
    Hv = torch.zeros(2, 320, 330, dtype=H.dtype)[:, :, :320]
    Cv = torch.zeros(3, 141, 320, dtype=H.dtype)[1:]
    args = pdip._check_newton_matrix(Hv, Cv, dscale, C_blk,
                                     condense.dense_row_widths(10, False))
    assert args[1:3] == (320 * 330, 330) and args[4:6] == (141 * 320, 320)
    assert args[-3:] == (10 * 40 * 24, 40 * 24, 24)


def _chain_problem(cfg, dtype=torch.float64):
    """(state, params) at the recorded TICKS, one row each, from a cold
    start, built by the port's planner."""
    timing = tm.build_timing(cfg)
    sc = nominal_scenario(cfg, device="cpu", dtype=dtype)
    plan = footsteps.plan_footsteps(sc.vref, cfg, timing, sc.foot_y,
                                    sc.step_y_offset)
    pl, pr = footsteps.contact_pose_refs(plan, timing)
    cref = crm.build_com_ref(plan, cfg, timing, sc.foot_y)
    B = len(TICKS)

    def rep(x):
        return x.expand(B, *x.shape[1:])

    refs = assemble.RefArrays(com=crm.ComRef(*(rep(x) for x in cref)),
                              pose_ref_l=rep(pl), pose_ref_r=rep(pr))
    x0 = torch.tensor(np.load(ASSET)["x0"], dtype=dtype)[TICKS]
    mass = rep(sc.mpc_mass)
    params = assemble.gather_params(torch.tensor(TICKS), x0, refs, timing,
                                    cfg, rep(sc.k1), rep(sc.k2), mass)
    return sqp.init_solver_state(cfg, x0, mass=mass), params


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_rows_are_zero_past_their_widths_in_the_solves_qps(soft,
                                                           monkeypatch):
    """Every QP two warm condip solves hand the interior point: C_width,
    which build hands on beside C, is condense.dense_row_widths, C is
    exactly 0 at and past each row's width, and for each block row I of M
    every row the kernel leaves out (_newton_rows) is exactly 0 on columns
    >= 64 I, so each tile's sum is the dense sum."""
    cfg = dataclasses.replace(CFG, condip_soft=soft)
    widths = condense.dense_row_widths(cfg.N, soft)
    seen = []
    inner = sqp.pdip_solve

    def kept(H, g, C, d, settings, **kw):
        seen.append((C, kw["C_width"]))
        return inner(H, g, C, d, settings, **kw)

    monkeypatch.setattr(sqp, "pdip_solve", kept)
    state, params = _chain_problem(cfg)
    for _ in range(2):
        state, _ = sqp.solve_mpc(state, params, cfg)
    assert len(seen) == 2 * cfg.sqp_iters
    n = 32 * cfg.N + (cfg.N + 1 if soft else 0)
    cols = torch.arange(n)
    w = torch.tensor(widths)
    past = cols[None, :] >= w[:, None]                      # (m_d, n)
    rows, level = pdip._newton_rows(len(widths), n, widths, "cpu")
    for C, C_width in seen:
        assert C_width == widths and C.shape[1:] == (len(widths), n)
        assert (C[:, past] == 0).all()
        assert (C[:, ~past] != 0).any()
        for I in range(len(level) - 1):
            kept = set(rows[level[I]:level[I + 1]].tolist())
            out = [r for r in range(len(widths)) if r not in kept]
            assert (C[:, out, 64 * I:] == 0).all()


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_build_hands_on_widths_where_structured(soft):
    """The structured QP carries one width per row of C, its dense form
    (every row in C, where the widths do not hold) none."""
    cfg = dataclasses.replace(CFG, condip_soft=soft)
    state, params = _chain_problem(cfg)
    it, (state, params, soft_q) = sqp._warm_start(state, params, None, cfg)
    qp = sqp._condense(it, params, soft_q, cfg)
    assert qp.C_width == condense.dense_row_widths(cfg.N, soft)
    assert len(qp.C_width) == qp.C.shape[1]
    dense = condense.build(problem.join_z(it.X, it.U), params, cfg, 0.1,
                           torch.ones(32 * cfg.N, dtype=it.X.dtype),
                           soft=soft)
    assert dense.C_width is None and dense.C_blk is None


def test_newton_rows_of_the_solve_cell():
    """At the benchmark's size (N = 10, hard rows: n = 320, m_d = 141) block
    rows 0..4 of M sum 140, 111, 83, 55 and 27 rows, each list in C's
    order, each the rows wider than 64 I; without widths every row in
    order, in every block row."""
    widths = np.asarray(condense.dense_row_widths(10, False))
    rows, level = pdip._newton_rows(141, 320, tuple(widths), "cpu")
    assert np.diff(level.numpy()).tolist() == [140, 111, 83, 55, 27]
    for i in range(5):
        got = rows[level[i]:level[i + 1]].numpy()
        assert got.tolist() == np.flatnonzero(widths > 64 * i).tolist()
    rows, level = pdip._newton_rows(141, 320, None, "cpu")
    assert rows.tolist() == list(range(141)) * 5
    assert level.tolist() == [141 * i for i in range(6)]
