"""The port on the card: the hand-written tile kernels against their plain
versions and numpy, and the main paths (batched solve, closed-loop ticks,
a 256-scenario sweep, whole-body ticks) through the kernel against the same
code on the CPU, both in f64; the whole-body layer also in f32, as the card
runs it; the sweep across two ranks sharing the card, and the dense
condensing in f32 against the CPU's f64.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX, so it also runs on a GPU machine that has none:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from cmpc_tpu_torch.config import WalkConfig, nominal_scenario
from cmpc_tpu_torch.ocp import assemble
from cmpc_tpu_torch.ops import batched_chol as tbc, sqp
from cmpc_tpu_torch.parallel import mesh as pmesh
from cmpc_tpu_torch.plan import com_ref as crm, footsteps, timing as tm
from cmpc_tpu_torch.rbd import urdf
from cmpc_tpu_torch.sim import closed_loop, wholebody_loop
from cmpc_tpu_torch.wholebody import (inverse_dynamics as wbid,
                                      plant as wbplant, setup as wbsetup)
from cmpc_tpu_torch.wholebody.state import retrieve_state

# tile families and the bitwise comparison (tools/tile_check.py)
_spec = importlib.util.spec_from_file_location(
    "tile_check", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "tile_check.py"))
tile_check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tile_check)

pytestmark = pytest.mark.cuda

CFG = WalkConfig()
ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "walk_x0.npz")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _spd(rng, B, n, scale=0.3, shift=5.0):
    A = rng.normal(size=(B, n, n)) * scale
    return A @ np.swapaxes(A, 1, 2) + shift * np.eye(n)


@pytest.mark.parametrize("B", [1, 7, 256])
def test_cuda_kernel_matches_plain(B, cuda):
    M = _spd(np.random.default_rng(B), B, 64)
    M32 = torch.tensor(M, dtype=torch.float32, device=cuda)
    n0 = tbc.LAUNCHES["chol_inv_tile"]
    L, X = tbc.chol_inv_tile(M32)
    assert tbc.LAUNCHES["chol_inv_tile"] == n0 + 1
    Lr, Xr = tbc.chol_inv_tile_ref(M32)
    torch.testing.assert_close(L, Lr, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(X, Xr, rtol=2e-5, atol=2e-5)
    assert torch.triu(L, 1).abs().max().item() == 0.0
    assert torch.triu(X, 1).abs().max().item() == 0.0
    L64, X64 = tbc.chol_inv_tile(torch.tensor(M, device=cuda))
    Lnp = np.linalg.cholesky(M)
    np.testing.assert_allclose(L64.cpu().numpy(), Lnp, rtol=0, atol=1e-12)
    np.testing.assert_allclose(X64.cpu().numpy(), np.linalg.inv(Lnp),
                               rtol=0, atol=1e-12)


def test_cuda_kernel_rejects_bad_input(cuda):
    good = torch.eye(64, device=cuda).expand(2, 64, 64)
    with pytest.raises(ValueError, match="contiguous"):
        tbc.chol_inv_tile(good)
    with pytest.raises(ValueError, match="tiles"):
        tbc.chol_inv_tile(torch.eye(32, device=cuda).repeat(2, 1, 1))
    with pytest.raises(TypeError):
        tbc.chol_inv_tile(good.contiguous().half())


@pytest.mark.parametrize("B", [1, 7, 256])
def test_cuda_chol_tile_matches_plain_and_fused_kernel(B, cuda):
    """The factor-only kernel against chol_tile_ref (f32, rtol=atol=2e-5)
    and numpy (f64, 1e-12), with exact zeros above the diagonal, and bit
    for bit against the L of the fused kernel on the same input."""
    M = _spd(np.random.default_rng(100 + B), B, 64)
    for dtype in (torch.float32, torch.float64):
        A = torch.tensor(M, dtype=dtype, device=cuda)
        n0 = dict(tbc.LAUNCHES)
        L = tbc.chol_tile(A)
        assert tbc.LAUNCHES["chol_tile"] == n0["chol_tile"] + 1
        assert tbc.LAUNCHES["chol_inv_tile"] == n0["chol_inv_tile"]
        assert torch.triu(L, 1).abs().max().item() == 0.0
        assert torch.equal(L, tbc.chol_inv_tile(A)[0])
        if dtype == torch.float32:
            torch.testing.assert_close(L, tbc.chol_tile_ref(A), rtol=2e-5,
                                       atol=2e-5)
        else:
            np.testing.assert_allclose(L.cpu().numpy(),
                                       np.linalg.cholesky(M), rtol=0,
                                       atol=1e-12)


def test_cuda_chol_tile_clamp_and_nan(cuda):
    """A zero pivot takes the 1e-30 clamp (sqrt: 1e-15) and a NaN is passed
    on within its tile, as in chol_tile_ref."""
    M = _spd(np.random.default_rng(5), 3, 64)
    M[1, 7, :] = 0.0
    M[1, :, 7] = 0.0
    M[2, 5, 5] = np.nan
    A = torch.tensor(M, device=cuda)
    L = tbc.chol_tile(A)
    assert L[1, 7, 7].item() == pytest.approx(1e-15)
    assert torch.isnan(L[2]).any() and torch.isfinite(L[:2]).all()
    Lr = tbc.chol_tile_ref(A.cpu())
    np.testing.assert_allclose(L[:2].cpu().numpy(), Lr[:2].numpy(), rtol=0,
                               atol=1e-12)
    assert torch.equal(torch.isnan(L[2]).cpu(), torch.isnan(Lr[2]))


@pytest.mark.parametrize("batch", ["1", "7", "256", "1280", "families"])
def test_cuda_factor_is_the_plain_elimination_bit_for_bit(batch, cuda):
    """chip_smoke.py phase 3's check: each kernel's f32 L equals the plain
    elimination's (_chol_tile_loop on the card, the JAX package's
    _chol_tile step for step) by torch.equal, on random SPD tiles and on
    the tile families of tools/tile_check.py, where NaN matches NaN."""
    if batch == "families":
        fams = tile_check.tile_families(np.random.default_rng(17), 8)
        M = np.concatenate([fams[f] for f in tile_check.FAMILIES])
    else:
        M = _spd(np.random.default_rng(int(batch)), int(batch), 64)
    A = torch.tensor(M, dtype=torch.float32, device=cuda)
    plain = tbc._chol_tile_loop(A)
    for L in (tbc.chol_inv_tile(A)[0], tbc.chol_tile(A)):
        m = tile_check.bit_mismatch(L, plain)
        assert m["n_diff"] == 0, m
        if batch != "families":
            assert torch.equal(L, plain)


@pytest.mark.parametrize("batch", ["1", "7", "256", "1280", "families"])
def test_cuda_inverse_is_the_column_substitution_bit_for_bit(batch, cuda):
    """chip_smoke.py phase 3's check of the inverse: the fused kernel's f32
    X equals tools/tile_check.tri_inv_cols of the kernel's own L, the
    kernel's column substitution in plain torch, with NaN matching NaN."""
    if batch == "families":
        fams = tile_check.tile_families(np.random.default_rng(17), 8)
        M = np.concatenate([fams[f] for f in tile_check.FAMILIES])
    else:
        M = _spd(np.random.default_rng(int(batch)), int(batch), 64)
    L, X = tbc.chol_inv_tile(torch.tensor(M, dtype=torch.float32,
                                          device=cuda))
    m = tile_check.bit_mismatch(X, tile_check.tri_inv_cols(L))
    assert m["n_diff"] == 0 and m["nan_pattern"], m


def test_cuda_chol_tile_rejects_bad_input(cuda):
    good = torch.eye(64, device=cuda).expand(2, 64, 64)
    with pytest.raises(ValueError, match="contiguous"):
        tbc.chol_tile(good)
    with pytest.raises(ValueError, match="tiles"):
        tbc.chol_tile(torch.eye(32, device=cuda).repeat(2, 1, 1))
    with pytest.raises(TypeError):
        tbc.chol_tile(good.contiguous().half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_tile_into_strided_in_place(dtype, cuda):
    """The in-place entry as blocked_cholesky uses it: a diagonal block of a
    (B, 320, 320) tensor in, L written into the same block of another and
    the inverse into Dinv[:, k], bit for bit what the contiguous call
    returns, one launch each, nothing outside the block written."""
    M = torch.tensor(_spd(np.random.default_rng(31), 5, 320, scale=0.1),
                     dtype=dtype, device=cuda)
    for k in (0, 2, 4):
        r0 = 64 * k
        blk = M[:, r0:r0 + 64, r0:r0 + 64]
        Lc, Xc = tbc.chol_inv_tile(blk.contiguous())
        Lbig = torch.full_like(M, 3.0)
        Dinv = torch.full((5, 5, 64, 64), 3.0, dtype=dtype, device=cuda)
        L2big = torch.full_like(M, 3.0)
        n0 = dict(tbc.LAUNCHES)
        tbc.chol_inv_tile_into(blk, Lbig[:, r0:r0 + 64, r0:r0 + 64],
                               Dinv[:, k])
        tbc.chol_tile_into(blk, L2big[:, r0:r0 + 64, r0:r0 + 64])
        assert tbc.LAUNCHES["chol_inv_tile"] == n0["chol_inv_tile"] + 1
        assert tbc.LAUNCHES["chol_tile"] == n0["chol_tile"] + 1
        assert torch.equal(Lbig[:, r0:r0 + 64, r0:r0 + 64], Lc)
        assert torch.equal(Dinv[:, k], Xc)
        assert torch.equal(L2big, Lbig)
        Lbig[:, r0:r0 + 64, r0:r0 + 64] = 3.0
        Dinv[:, k] = 3.0
        assert (Lbig == 3.0).all() and (Dinv == 3.0).all()


def test_cuda_blocked_cholesky_launches_no_copies(cuda):
    """blocked_cholesky on the card: 5 launches for a 320x320 matrix, and
    the factor and the tile inverses of the CPU run of the same code
    (f64, 1e-12)."""
    M = _spd(np.random.default_rng(32), 3, 320, scale=0.1)
    n0 = tbc.LAUNCHES["chol_inv_tile"]
    L, Dinv = tbc.blocked_cholesky(torch.tensor(M, device=cuda), 64)
    assert tbc.LAUNCHES["chol_inv_tile"] == n0 + 5
    Lc, Dc = tbc.blocked_cholesky(torch.tensor(M), 64)
    np.testing.assert_allclose(L.cpu().numpy(), Lc.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(Dinv.cpu().numpy(), Dc.numpy(), rtol=0,
                               atol=1e-12)
    assert torch.triu(L, 1).abs().max().item() == 0.0


def test_cuda_kernels_at_1024_tiles(cuda):
    """1024 tiles (several to an SM): both kernels against the plain
    version (f32, rtol=atol=2e-5) and each other (bit for bit)."""
    M = _spd(np.random.default_rng(33), 1024, 64)
    A = torch.tensor(M, dtype=torch.float32, device=cuda)
    L, X = tbc.chol_inv_tile(A)
    Lr, Xr = tbc.chol_inv_tile_ref(A)
    torch.testing.assert_close(L, Lr, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(X, Xr, rtol=2e-5, atol=2e-5)
    assert torch.equal(tbc.chol_tile(A), L)
    assert torch.triu(L, 1).abs().max().item() == 0.0
    assert torch.triu(X, 1).abs().max().item() == 0.0
    A64 = torch.tensor(M, device=cuda)
    L64, X64 = tbc.chol_inv_tile(A64)
    Lnp = np.linalg.cholesky(M)
    np.testing.assert_allclose(L64.cpu().numpy(), Lnp, rtol=0, atol=1e-12)
    np.testing.assert_allclose(X64.cpu().numpy(), np.linalg.inv(Lnp),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_outputs_overwrite_whatever_was_there(dtype, cuda):
    """The kernels write their outputs whole: into buffers full of NaN the
    block comes out with exact zeros above the diagonal and no NaN."""
    A = torch.tensor(_spd(np.random.default_rng(34), 9, 64), dtype=dtype,
                     device=cuda)
    L = torch.full_like(A, float("nan"))
    X = torch.full_like(A, float("nan"))
    L2 = torch.full_like(A, float("nan"))
    tbc.chol_inv_tile_into(A, L, X)
    tbc.chol_tile_into(A, L2)
    for out in (L, X, L2):
        assert torch.isfinite(out).all()
        assert torch.triu(out, 1).abs().max().item() == 0.0
    assert torch.equal(L2, L)
    Lr, Xr = tbc.chol_inv_tile(A)
    assert torch.equal(L, Lr) and torch.equal(X, Xr)


def test_cuda_tile_into_rejects_what_the_kernel_cannot_address(cuda):
    M = torch.zeros(2, 321, 321, device=cuda)
    good = torch.zeros(2, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        tbc.chol_inv_tile_into(M[:, :64, :64], good, good.clone())
    with pytest.raises(ValueError, match="match"):
        tbc.chol_inv_tile_into(good, good.double(), good.clone())
    with pytest.raises(ValueError, match="overlap"):
        tbc.chol_tile_into(good, good[:1].expand(2, 64, 64))


def test_cuda_spd_inverse64_matches_numpy(cuda):
    """The padded path (331 -> 384, 6 tiles) through the kernel."""
    M = _spd(np.random.default_rng(9), 4, 331, scale=0.1)
    inv_gpu = tbc.spd_inverse64(torch.tensor(M, device=cuda)).cpu().numpy()
    np.testing.assert_allclose(inv_gpu, np.linalg.inv(M), rtol=0,
                               atol=1e-12)


def _strided_factor(M):
    """The blocked factor of M (B, n, n) on the card, copied into views of
    larger buffers (L's rows 8 elements longer, Dinv's rows 4 longer and a
    sixth block per scenario) whose every element the substitution must not
    read is NaN: the padding, L's diagonal blocks and everything above
    them."""
    B, n, _ = M.shape
    L, Dinv = tbc.blocked_cholesky(M, 64)
    K = n // 64
    Lv = torch.full((B, n, n + 8), float("nan"), dtype=M.dtype,
                    device=M.device)[:, :, :n]
    keep = torch.ones(K, K, dtype=torch.bool, device=M.device).tril(-1)
    keep = keep.repeat_interleave(64, 0).repeat_interleave(64, 1)
    Lv.copy_(torch.where(keep, L, float("nan")))
    Dv = torch.full((B, K + 1, 64, 68), float("nan"), dtype=M.dtype,
                    device=M.device)[:, :K, :, :64]
    Dv.copy_(Dinv)
    return L, Dinv, Lv, Dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 7, 2048])
def test_cuda_chol_solve_matches_plain(B, dtype, cuda):
    """The substitution kernel against its plain version on the card, on
    the factor blocked_cholesky wrote and on strided views of it whose
    unread elements are NaN (same x bit for bit: the kernel reads nothing
    else), one launch per call.  f32 within 2e-6 of |x|'s largest (measured
    5e-7 at (2048, 320): sums taken in another order), f64 within 1e-14
    (measured 8e-16); both within the same of a f64 dense solve as the
    plain version is."""
    n = 320
    g = torch.Generator(device=cuda).manual_seed(B)
    A = torch.randn(B, n, n, generator=g, device=cuda,
                    dtype=torch.float64) / n ** 0.5
    M64 = A @ A.transpose(1, 2) + 0.1 * torch.eye(n, dtype=torch.float64,
                                                  device=cuda)
    b64 = torch.randn(B, n, generator=g, device=cuda, dtype=torch.float64)
    M, b = M64.to(dtype), b64.to(dtype)
    L, Dinv, Lv, Dv = _strided_factor(M)
    n0 = tbc.LAUNCHES["chol_solve"]
    x = tbc.chol_solve(L, Dinv, b)
    assert tbc.LAUNCHES["chol_solve"] == n0 + 1
    bv = torch.full((B, n + 10), float("nan"), dtype=dtype,
                    device=cuda)[:, :n]
    bv.copy_(b)
    assert torch.equal(tbc.chol_solve(Lv, Dv, bv), x)
    xr = tbc.chol_solve_ref(L, Dinv, b)
    tol = 2e-6 if dtype == torch.float32 else 1e-14
    scale = float(xr.abs().max())
    torch.testing.assert_close(x, xr, rtol=0, atol=tol * scale)
    xd = torch.linalg.solve(M64, b64)
    gap_plain = float((xr.double() - xd).abs().max())
    assert float((x.double() - xd).abs().max()) <= gap_plain + tol * scale


def test_cuda_chol_solve_nan_tile_poisons_its_scenario_only(cuda):
    """A NaN in a tile inverse of one scenario and in a block of L below the
    diagonal of another: those two x are wholly non-finite, the others the
    clean call's bit for bit (each scenario is its own CTA)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    A = torch.randn(5, 320, 320, generator=g, device=cuda) / 320 ** 0.5
    M = A @ A.transpose(1, 2) + 0.1 * torch.eye(320, device=cuda)
    b = torch.randn(5, 320, generator=g, device=cuda)
    L, Dinv = tbc.blocked_cholesky(M, 64)
    clean = tbc.chol_solve(L, Dinv, b)
    Dinv[1, 2, 10, 5] = float("nan")
    L[3, 300, 70] = float("nan")
    x = tbc.chol_solve(L, Dinv, b)
    assert not torch.isfinite(x[[1, 3]]).any()
    assert torch.equal(x[[0, 2, 4]], clean[[0, 2, 4]])


def test_cuda_chol_solve_rejects_bad_input(cuda):
    L = torch.zeros(2, 320, 320, device=cuda)
    D = torch.zeros(2, 5, 64, 64, device=cuda)
    b = torch.zeros(2, 320, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        tbc.chol_solve(torch.zeros(2, 320, 322, device=cuda)[:, :, :320], D,
                       b)
    with pytest.raises(TypeError, match="match"):
        tbc.chol_solve(L, D.double(), b)
    with pytest.raises(ValueError, match="match"):
        tbc.chol_solve(L.cpu(), D, b)


def _recorded_params(device, ticks):
    """MPCParams at recorded walk ticks, built by the port's own planner
    (as chip_smoke.py replays them), f64."""
    f64 = torch.float64
    timing = tm.build_timing(CFG)
    sc = nominal_scenario(CFG, device=device, dtype=f64)
    plan = footsteps.plan_footsteps(sc.vref, CFG, timing, sc.foot_y,
                                    sc.step_y_offset)
    pl, pr = footsteps.contact_pose_refs(plan, timing)
    cref = crm.build_com_ref(plan, CFG, timing, sc.foot_y)
    B = len(ticks)

    def rep(x):
        return x.expand(B, *x.shape[1:])

    refs = assemble.RefArrays(com=crm.ComRef(*(rep(x) for x in cref)),
                              pose_ref_l=rep(pl), pose_ref_r=rep(pr))
    x0 = torch.tensor(np.load(ASSET)["x0"], dtype=f64, device=device)
    tk = torch.tensor(ticks, device=device)
    return assemble.gather_params(tk, x0[tk], refs, timing, CFG,
                                  rep(sc.k1), rep(sc.k2), rep(sc.mpc_mass))


def test_cuda_solve_matches_cpu(cuda):
    """One batched solve (3 SQP x 8 IPM iterations) through the kernels:
    120 tile launches, 96 substitutions (2 right-hand sides x (1 +
    refine) per IPM iteration) and 24 Newton matrices on the card, none on
    the CPU, which runs their plain versions; the same z and residuals as
    the CPU run (f64,
    1e-8 — the tolerance the CPU solve is held to against JAX)."""
    ticks = [250, 262, 300, 420]
    out = {}
    for dev in (torch.device("cpu"), cuda):
        p = _recorded_params(dev, ticks)
        st = sqp.init_solver_state(CFG, p.x0, mass=p.mass)
        n0 = dict(tbc.LAUNCHES)
        out[dev.type] = sqp.solve_mpc(st, p, CFG)
        launches = tbc.LAUNCHES["chol_inv_tile"] - n0["chol_inv_tile"]
        solves = tbc.LAUNCHES["chol_solve"] - n0["chol_solve"]
        formed = tbc.LAUNCHES["newton_matrix"] - n0["newton_matrix"]
        assert launches == (120 if dev.type == "cuda" else 0)
        assert solves == (96 if dev.type == "cuda" else 0)
        assert formed == (24 if dev.type == "cuda" else 0)
    (sc_, ic), (sg, ig) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(sg.z.cpu().numpy(), sc_.z.numpy(), rtol=0,
                               atol=1e-8)
    for name in ("r_prim", "lyap_violation"):
        np.testing.assert_allclose(getattr(ig, name).cpu().numpy(),
                                   getattr(ic, name).numpy(), rtol=0,
                                   atol=1e-8, err_msg=name)


def test_cuda_rollout_matches_cpu(cuda):
    """The first eight closed-loop ticks under a 3 N lateral push (so the
    plant moves from rest) on the card and on the CPU, f64: the plant state
    at 1e-8."""
    res = {}
    for dev in (torch.device("cpu"), cuda):
        sc = nominal_scenario(CFG, push=(0.0, 3.0, 0.0), push_window=(-1, 8),
                              device=dev, dtype=torch.float64)
        carry, _ = closed_loop.rollout(sc, CFG, T_sim=8)
        res[dev.type] = carry.plant
    for name in res["cpu"]._fields:
        np.testing.assert_allclose(getattr(res["cuda"], name).cpu().numpy(),
                                   getattr(res["cpu"], name).numpy(),
                                   rtol=0, atol=1e-8, err_msg=name)


def test_cuda_sweep_256_matches_cpu(cuda):
    """Five ticks of the 256-scenario make_batch sweep (seed 7) on the card
    and on the CPU, f64: the per-scenario statistics at 1e-8, through 120
    launches of 256 tiles and 96 substitutions per tick."""
    out = {}
    for dev in (torch.device("cpu"), cuda):
        sc = pmesh.make_batch(CFG, 256, seed=7, device=dev,
                              dtype=torch.float64)
        n0 = dict(tbc.LAUNCHES)
        out[dev.type] = pmesh.sweep_per_scenario(sc, CFG, 5)
        launches = tbc.LAUNCHES["chol_inv_tile"] - n0["chol_inv_tile"]
        solves = tbc.LAUNCHES["chol_solve"] - n0["chol_solve"]
        assert launches == (5 * 120 if dev.type == "cuda" else 0)
        assert solves == (5 * 96 if dev.type == "cuda" else 0)
    for name in out["cpu"]._fields:
        np.testing.assert_allclose(getattr(out["cuda"], name).cpu().numpy(),
                                   getattr(out["cpu"], name).numpy(),
                                   rtol=0, atol=1e-8, err_msg=name)


def test_cuda_lanes_do_not_mix(cuda):
    """The tiny heterogeneous sweep under a permutation of the batch, f64.
    On the CPU the scenarios' results are unchanged bit for bit
    (test_torch_runtime.py).  On the card a row sum rounds differently with
    the row's position in the batch: ``Tensor.sum(dim=1)`` over rows of odd
    length (the interior-point complementarity sum, 8 x 541) — the reduce
    kernel's vectorized loads split a row at a 16-byte boundary, which
    falls elsewhere in each row.  Measured: 1e-13 on that sum, 8e-14
    relative on the statistics after 4 ticks.  So the bound here is 1e-10,
    far below what a reduction over the whole batch would leak."""
    from cmpc_tpu_torch import entry
    entry.dryrun_one_device(cuda, torch.float64, lane_tol=1e-10)


def test_cuda_oracle_functions_match_cpu(cuda):
    """The oracle's cost, gradient, constraints and Jacobian (ops/oracle
    _fns) on the card against the same on the CPU, f64, at tick 150's
    production warm start (WalkConfig(), 540 variables): within 1e-12 of
    the largest |value|."""
    from cmpc_tpu_torch.ocp import problem
    from cmpc_tpu_torch.ops import oracle
    out = {}
    for dev in (torch.device("cpu"), cuda):
        p = _recorded_params(dev, [150])
        st = sqp.init_solver_state(CFG, p.x0, mass=p.mass)
        U = sqp.prep_warmstart(st, p, CFG)
        z = problem.join_z(sqp._rollout_X(p.x0, U, p, CFG), U)[0]
        out[dev.type] = [f(z, p).cpu().numpy() for f in oracle._fns(CFG)]
    for name, got, want in zip(("cost", "grad", "con", "jac"), out["cuda"],
                               out["cpu"]):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=name)


# ------------------------------------------------------------- whole body

ID_SETTINGS = wholebody_loop.ADMMSettings(iters=90, rho=10.0, pdas_rounds=2,
                                          rho_adapt=2)


def _gate_problem(model, device, dtype):
    """Three perturbed half-sitting states with task errors (numpy noise
    from a seed, drawn in f64), one for each contact gate (1,1), (1,0),
    (0,1)."""
    rng = np.random.default_rng(2)
    dq = 0.02 * rng.normal(size=(3, model.nj))
    dp = 1e-3 * rng.normal(size=(3, 3))
    dv = 0.05 * rng.normal(size=(3, model.nv))

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    q = wbsetup.initial_q(model, settle=0.0012, batch=3, device=device,
                          dtype=dtype)
    q = q._replace(qj=q.qj + t(dq), base_pos=q.base_pos + t(dp))
    qv = t(dv)
    st = retrieve_state(model, q, qv)
    z3, z6 = torch.zeros_like(st.com_pos), torch.zeros_like(st.pose_l)
    off = 0.003
    des = wbid.WBDesired(
        pose_l=st.pose_l + off, vel_l=z6, acc_l=z6,
        pose_r=st.pose_r - off, vel_r=z6, acc_r=z6,
        com_pos=st.com_pos + off, com_vel=z3, com_acc=z3 + off,
        torso_rotvec=st.torso_rotvec, torso_omega=z3, torso_alpha=z3,
        base_rotvec=st.base_rotvec, base_omega=z3, base_alpha=z3,
        joint_pos=st.joint_pos)
    return q, qv, des, st, t([1.0, 1.0, 0.0]), t([1.0, 0.0, 1.0])


def test_cuda_joint_torques_f32_match_cpu_f64(cuda):
    """joint_torques (rigid-body layer, ID QP assembly, 90 ADMM iterations
    with two rho updates on the LU-factored KKT system, two active-set
    rounds) at the three contact gates: f64 on the card against f64 on the
    CPU at 1e-7 N m, and f32 on the card, as the whole-body loop runs it,
    against f64 on the CPU at 0.05 N m (torques up to ~1e2 N m)."""
    model = urdf.load_hrp4()
    out = {}
    for key, dev, dtype in (("cpu", torch.device("cpu"), torch.float64),
                            ("cuda64", cuda, torch.float64),
                            ("cuda32", cuda, torch.float32)):
        q, qv, des, st, gl, gr = _gate_problem(model, dev, dtype)
        tau, res = wbid.joint_torques(model, q, qv, des, st, contact_l=gl,
                                      contact_r=gr, settings=ID_SETTINGS)
        assert tau.dtype == dtype and tau.device.type == dev.type
        out[key] = tau.double().cpu().numpy()
    assert np.isfinite(out["cuda32"]).all()
    assert np.abs(out["cpu"]).max() > 10.0
    np.testing.assert_allclose(out["cuda64"], out["cpu"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(out["cuda32"], out["cpu"], rtol=0, atol=0.05)


def _wb_scenario(device, dtype, B=1):
    sc = nominal_scenario(CFG, push=(4.0, 9.0, 0.0), push_window=(1, 6),
                          device=device, dtype=dtype)
    return sc.repeat(B)


def test_cuda_wholebody_ticks_match_cpu(cuda):
    """Ten whole-body ticks (MPC through the tile kernel, ID QP, 10
    impulse-contact substeps) under a push over ticks 2-5: f64 on the card
    against f64 on the CPU, the plant state at 1e-7; f32 on the card
    finite and within 5e-3 (m, rad) and 5e-2 (m/s, rad/s) of the CPU's f64
    state (f32 on the CPU is 7e-4 and 8e-3 away: the ID QP's 90 ADMM
    iterations leave ~0.3 N m of f32 noise on the torques); 120 kernel
    launches per tick."""
    model = urdf.load_hrp4()
    res = {}
    for key, dev, dtype in (("cpu", torch.device("cpu"), torch.float64),
                            ("cuda64", cuda, torch.float64),
                            ("cuda32", cuda, torch.float32)):
        n0 = tbc.LAUNCHES["chol_inv_tile"]
        carry, tr = wholebody_loop.rollout(
            model, _wb_scenario(dev, dtype), CFG, T_sim=10)
        launches = tbc.LAUNCHES["chol_inv_tile"] - n0
        assert launches == (10 * 120 if dev.type == "cuda" else 0)
        assert all(bool(torch.isfinite(x.double()).all()) for x in tr)
        res[key] = {"qv": carry.plant.qv, **carry.plant.q._asdict()}
    for name, want in res["cpu"].items():
        for key, atol in (("cuda64", 1e-7),
                          ("cuda32", 5e-2 if name == "qv" else 5e-3)):
            np.testing.assert_allclose(
                res[key][name].double().cpu().numpy(), want.numpy(), rtol=0,
                atol=atol, err_msg=f"{key} {name}")
    # the push moved the plant
    assert float(res["cpu"]["qv"].abs().max()) > 1e-3


def test_cuda_wholebody_lanes_do_not_mix(cuda):
    """Three whole-body ticks of four differing scenarios and of the same
    four in another order, f64 on the card: every scenario's plant state
    agrees at 1e-10 (the bound of test_cuda_lanes_do_not_mix; on the CPU
    the rows are bitwise equal, tests/test_torch_wholebody.py)."""
    model = urdf.load_hrp4()
    sc = _wb_scenario(cuda, torch.float64, B=4)
    scale = torch.tensor([0.0, 0.5, 1.0, -1.0], dtype=torch.float64,
                         device=cuda)[:, None]
    sc = sc._replace(push_force=sc.push_force * scale)
    perm = torch.tensor([2, 0, 3, 1], device=cuda)
    shuffled = type(sc)(*(x[perm] for x in sc))
    a, _ = wholebody_loop.rollout(model, sc, CFG, T_sim=3)
    b, _ = wholebody_loop.rollout(model, shuffled, CFG, T_sim=3)
    for name, x, y in (("qv", a.plant.qv, b.plant.qv),
                       ("qj", a.plant.q.qj, b.plant.q.qj),
                       ("base_pos", a.plant.q.base_pos, b.plant.q.base_pos),
                       ("z", a.solver.z, b.solver.z)):
        np.testing.assert_allclose(y.cpu().numpy(), x[perm].cpu().numpy(),
                                   rtol=1e-10, atol=1e-10, err_msg=name)
    assert not torch.equal(a.plant.qv[0], a.plant.qv[2])


# ------------------------------------------------ ranks, dense condensing

def test_cuda_dryrun_multichip_two_ranks(cuda):
    """entry.dryrun_multichip at 2 ranks sharing the card (gloo), f64: its
    three criteria at the lane tolerance of test_cuda_lanes_do_not_mix."""
    from _torch_mesh_worker import run_ranks
    outs = run_ranks(["tests/_torch_mesh_worker.py", "dryrun", "cuda:0",
                      "gloo", "float64", "1e-10"])
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-3000:]
        line = json.loads(out.strip().splitlines()[-1])
        assert (line["rank"], line["world_size"], line["n"]) == (r, 2, 4)
        assert line["device"] == "cuda:0" and line["backend"] == "gloo"
        assert max(line["placement_dev"], line["shard_alone_dev"],
                   line["whole_batch_dev"]) <= 1e-10


def test_cuda_make_mesh_refuses_nccl_on_a_shared_card(cuda):
    """Two ranks asking NCCL for the same card: make_mesh raises in both
    before NCCL's first collective."""
    from _torch_mesh_worker import run_ranks
    outs = run_ranks(["tests/_torch_mesh_worker.py", "mesh", "cuda:0",
                      "nccl"])
    for rc, _, err in outs:
        assert rc != 0 and "hold the same card" in err, err[-3000:]


def test_cuda_condense_dense_f32_matches_cpu_f64(cuda):
    """condense.build's dense form (its default) at four recorded walk
    ticks with multipliers on the soft rows: f32 on the card against f64 on
    the CPU, every field finite and within 1e-4 of its largest magnitude."""
    from cmpc_tpu_torch.ocp import condense, problem
    f64 = torch.float64
    p = _recorded_params(torch.device("cpu"), [250, 262, 300, 420])
    st = sqp.init_solver_state(CFG, p.x0, mass=p.mass)
    U = sqp.prep_warmstart(st, p, CFG)
    z = problem.join_z(sqp._rollout_X(p.x0, U, p, CFG), U)
    lam = torch.full((4, CFG.N + 1), 5.0, dtype=f64)
    w = torch.ones(32 * CFG.N, dtype=f64)
    want = condense.build(z, p, CFG, 0.1, w, lam_soft=lam)

    def f32(x):
        return x.to(cuda, torch.float32) if x.is_floating_point() \
            else x.to(cuda)

    got = condense.build(f32(z), type(p)(*map(f32, p)), CFG, 0.1, f32(w),
                         lam_soft=f32(lam))
    assert got.C_blk is None and got.H.dtype == torch.float32
    for name in ("H", "g", "C", "d", "E", "row_scale"):
        a, b = getattr(got, name).double().cpu(), getattr(want, name)
        assert bool(torch.isfinite(a).all()), name
        scale = max(1.0, float(b.abs().max()))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


# ---- the Newton matrix kernel (csrc/newton_matrix.cu) ----

def _newton_qp(B, n, m_d, blk, dtype, widths, seed):
    """Random (H, C, dscale, C_blk) of the condensed QP's shapes on the
    card: H symmetric, C exactly 0 past its rows' widths where given,
    dscale spread over 1e-4 .. 1e4 as the interior point's scaling is."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(B, n, n, generator=g, device="cuda", dtype=torch.float64)
    H = X + X.transpose(1, 2)
    C = torch.randn(B, m_d, n, generator=g, device="cuda",
                    dtype=torch.float64)
    if widths is not None:
        w = torch.tensor(widths, device="cuda")
        C = C * (torch.arange(n, device="cuda")[None, :] < w[:, None])
    Nb, rb, cb = (10, 40, 24) if blk else (0, 0, 0)
    dscale = torch.exp(torch.empty(B, m_d + Nb * rb, device="cuda",
                                   dtype=torch.float64)
                       .uniform_(-9.0, 9.0, generator=g))
    C_blk = torch.randn(B, Nb, rb, cb, generator=g, device="cuda",
                        dtype=torch.float64) if blk else None
    return tuple(None if x is None else x.to(dtype)
                 for x in (H, C, dscale, C_blk))


_NEWTON_CASES = {
    "b2048_n320_blk_f32": (2048, 320, 141, True, torch.float32),
    "b2048_n320_blk_f64": (2048, 320, 141, True, torch.float64),
    "b64_n331_f32": (64, 331, 152, False, torch.float32),
    "b64_n331_f64": (64, 331, 152, False, torch.float64),
}


@pytest.mark.parametrize("case", sorted(_NEWTON_CASES))
def test_cuda_newton_matrix_within_its_bound(case, cuda):
    """The kernel's M against the plain expression in f64, entry by entry,
    within 8 (m_d + 2) u (|H| + sum dd |c||c| + |stage term| + reg), u the
    unit roundoff of the type: at the condip solve's shapes (n = 320 with
    the stage blocks and the rows' widths, as the solve launches it; the
    soft route's n = 331 without either), in f32 and f64.  Leaving out the
    rows that are 0 on a tile changes no bit."""
    from cmpc_tpu_torch.ocp import condense
    from cmpc_tpu_torch.ops import pdip
    B, n, m_d, blk, dtype = _NEWTON_CASES[case]
    widths = condense.dense_row_widths(CFG.N, False) if blk else None
    H, C, dscale, C_blk = _newton_qp(B, n, m_d, blk, dtype, widths, seed=n)
    reg = 1e-7 if dtype == torch.float32 else 1e-8
    n0 = tbc.LAUNCHES["newton_matrix"]
    M = pdip.newton_matrix(H, C, dscale, reg, C_blk, widths)
    assert tbc.LAUNCHES["newton_matrix"] == n0 + 1
    assert M.shape == (B, n, n) and M.dtype == dtype

    def f64(x, f=lambda t: t):
        return None if x is None else f(x.double())
    want = pdip.newton_matrix_ref(f64(H), f64(C), f64(dscale), reg,
                                  f64(C_blk))
    size = pdip.newton_matrix_ref(f64(H, torch.abs), f64(C, torch.abs),
                                  f64(dscale), reg, f64(C_blk, torch.abs))
    bound = 8 * (m_d + 2) * torch.finfo(dtype).eps / 2 * size
    assert bool(((M.double() - want).abs() <= bound).all())
    if widths is not None:
        assert torch.equal(pdip.newton_matrix(H, C, dscale, reg, C_blk), M)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_newton_matrix_graph_replay_is_eager_bit_for_bit(dtype, cuda):
    """The kernel captured into a CUDA graph and replayed on new inputs
    gives the eager launch's M on them bit for bit, as do strided views of
    the inputs (rows longer than n)."""
    from cmpc_tpu_torch.ocp import condense
    from cmpc_tpu_torch.ops import pdip
    widths = condense.dense_row_widths(CFG.N, False)
    args = [_newton_qp(256, 320, 141, True, dtype, widths, seed=s)
            for s in (1, 2)]
    buf = [x.clone() for x in args[0]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pdip.newton_matrix(*buf[:3], 1e-7, buf[3], widths)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = pdip.newton_matrix(*buf[:3], 1e-7, buf[3], widths)
    torch.cuda.current_stream().wait_stream(side)
    for H, C, dscale, C_blk in args:
        for x, y in zip(buf, (H, C, dscale, C_blk)):
            x.copy_(y)
        graph.replay()
        eager = pdip.newton_matrix(H, C, dscale, 1e-7, C_blk, widths)
        assert torch.equal(out, eager)
        Hv = torch.zeros(256, 320, 333, dtype=dtype, device=cuda)[:, :, :320]
        Cv = torch.zeros(256, 141, 330, dtype=dtype, device=cuda)[:, :, :320]
        Hv.copy_(H)
        Cv.copy_(C)
        assert torch.equal(pdip.newton_matrix(Hv, Cv, dscale, 1e-7, C_blk,
                                              widths), eager)


def _plain_sums_rows_in_order(device):
    """Whether the plain expression, at the condip solve's shapes (256
    scenarios, n = 320, 141 dense rows, the stage blocks), sums each
    element's rows one at a time in C's order on this card's library: row 0
    adds 2**24 and every later row 1, which a sum in that order rounds away
    (2**24 + 1 ties to 2**24) and any other order keeps in part."""
    from cmpc_tpu_torch.ops import pdip
    B, n, m_d, Nb, rb, cb = 256, 320, 141, 10, 40, 24
    C = torch.ones(B, m_d, n, device=device)
    C[:, 0] = 4096.0
    C_blk = torch.ones(B, Nb, rb, cb, device=device)
    C_blk[:, :, 0] = 4096.0
    M = pdip.newton_matrix_ref(torch.zeros(B, n, n, device=device), C,
                               torch.ones(B, m_d + Nb * rb, device=device),
                               0.0, C_blk)
    want = torch.full_like(M, 2.0 ** 24)
    for i in range(Nb):
        want[:, 32 * i:32 * i + cb, 32 * i:32 * i + cb] = 2.0 ** 25
    return torch.equal(M, want)


def test_cuda_newton_matrix_is_the_plain_expression_on_the_solve(
        cuda, monkeypatch):
    """On the condip solve's own data (256 recorded walk ticks, f32, two
    warm solves of 3 SQP x 8 IPM iterations) every M the kernel forms
    equals the plain expression's on the card bit for bit: each sum runs
    row by row in C's order with one fused multiply-add a row, as the
    library product's does, and the rows it leaves out would add exact
    zeros.  So the solve is the one the plain expression gives.

    Pinned to the library's order of summation (cuBLAS with torch 2.11 and
    CUDA 12.8 sums row by row at these shapes): where the plain
    expression's own order differs, as _plain_sums_rows_in_order shows, the
    bits cannot agree with a correct kernel and the test skips;
    test_cuda_newton_matrix_within_its_bound still holds the kernel."""
    from cmpc_tpu_torch.ops import pdip
    if not _plain_sums_rows_in_order(cuda):
        pytest.skip("the library product does not sum C's rows in order "
                    "at the solve's shapes; the kernel's bits follow that "
                    "order")
    p = _recorded_params(cuda, list(range(120, 120 + 2 * 256, 2)))
    p = type(p)(*(x.float() if x.is_floating_point() else x for x in p))
    kernel, same = pdip.newton_matrix, []

    def compared(H, C, dscale, reg, C_blk=None, C_width=None):
        M = kernel(H, C, dscale, reg, C_blk, C_width)
        same.append(torch.equal(
            M, pdip.newton_matrix_ref(H, C, dscale, reg, C_blk)))
        return M

    monkeypatch.setattr(pdip, "newton_matrix", compared)
    st = sqp.init_solver_state(CFG, p.x0, mass=p.mass)
    for _ in range(2):
        st, _ = sqp._solve_mpc_condip_eager(st, p, CFG)
    assert len(same) == 2 * CFG.sqp_iters * CFG.pdip_iters and all(same)


def test_cuda_newton_matrix_launches_24_per_condip_solve(cuda):
    """One condip solve forms the Newton matrix once an IPM iteration, 3 x
    8 = 24 kernel launches, replayed from the graphs as launched eagerly."""
    p = _recorded_params(cuda, [250, 262, 300, 420])
    p = type(p)(*(x.float() if x.is_floating_point() else x for x in p))
    st = sqp.init_solver_state(CFG, p.x0, mass=p.mass)
    per = CFG.sqp_iters * CFG.pdip_iters
    for solve in (sqp._solve_mpc_condip_eager, sqp.solve_mpc, sqp.solve_mpc):
        n0 = tbc.LAUNCHES["newton_matrix"]
        solve(st, p, CFG)
        assert tbc.LAUNCHES["newton_matrix"] - n0 == per == 24


def test_cuda_newton_matrix_rejects_bad_input(cuda):
    """A CUDA launch refuses inputs on two devices and inputs of other
    types, before it launches."""
    from cmpc_tpu_torch.ops import pdip
    H, C, dscale, _ = _newton_qp(2, 64, 9, False, torch.float32, None, 1)
    n0 = tbc.LAUNCHES["newton_matrix"]
    with pytest.raises(ValueError, match="devices"):
        pdip.newton_matrix(H, C.cpu(), dscale, 1e-7)
    with pytest.raises(TypeError, match="match"):
        pdip.newton_matrix(H, C.double(), dscale, 1e-7)
    with pytest.raises(RuntimeError, match="no kernel"):
        pdip.newton_matrix(H.to("meta"), C.to("meta"), dscale.to("meta"),
                           1e-7)
    assert tbc.LAUNCHES["newton_matrix"] == n0
