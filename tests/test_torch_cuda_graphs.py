"""The condip solve replayed from CUDA graphs (``runtime/graphs``, the
stages of ``ops/sqp``) against the same solve dispatched op by op
(``sqp._solve_mpc_condip_eager``), on the card: every answer bit for bit,
along warm chains of recorded ticks and along closed-loop ticks of pushed
and loaded walks; answers that later replays leave alone; one capture per
stage and signature; the kernel launch counts a solve has always read.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX:

    python -m pytest tests/test_torch_cuda_graphs.py -m cuda --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from cmpc_tpu_torch.config import WalkConfig, nominal_scenario
from cmpc_tpu_torch.ocp import assemble
from cmpc_tpu_torch.ops import batched_chol as tbc, sqp
from cmpc_tpu_torch.plan import com_ref as crm, footsteps, timing as tm
from cmpc_tpu_torch.runtime import graphs
from cmpc_tpu_torch.sim import closed_loop

pytestmark = pytest.mark.cuda

CFG = WalkConfig()
ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "walk_x0.npz")
CHAIN = 12
# stages a solve replays: the warm start, 3 per SQP iteration, the answer
STAGES = 5
REPLAYS = 2 + 3 * CFG.sqp_iters


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda", 0)


def _bits(t):
    """The tensor's bit pattern: equal bit patterns are equal answers, NaN
    payloads included."""
    t = t.detach()
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def _assert_same_bits(a, b, what):
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(_bits(x), _bits(y)), f"{what}: field {i} differs"


def _chain_params(B, dtype, device, seed):
    """The MPC parameters of a CHAIN-solve warm chain ending at B recorded
    walk ticks drawn from 120-799, built by the port's planner, each row's
    mass and gains varied as the payloads of the sweep vary them."""
    rng = np.random.default_rng(seed)
    timing = tm.build_timing(CFG)
    sc = nominal_scenario(CFG, device=device, dtype=dtype)
    plan = footsteps.plan_footsteps(sc.vref, CFG, timing, sc.foot_y,
                                    sc.step_y_offset)
    pl, pr = footsteps.contact_pose_refs(plan, timing)
    cref = crm.build_com_ref(plan, CFG, timing, sc.foot_y)

    def rep(x):
        return x.expand(B, *x.shape[1:])

    refs = assemble.RefArrays(com=crm.ComRef(*(rep(x) for x in cref)),
                              pose_ref_l=rep(pl), pose_ref_r=rep(pr))
    x0 = torch.tensor(np.load(ASSET)["x0"], dtype=dtype, device=device)
    ticks = torch.tensor(rng.integers(120, 800, size=B), device=device)
    heavy = torch.tensor(rng.random(B) < 0.5, device=device)
    mass = sc.mpc_mass[0] + torch.tensor(rng.uniform(0.0, 3.0, size=B),
                                         dtype=dtype, device=device)
    k1 = torch.where(heavy, 7.0, 4.0).to(dtype)
    k2 = torch.where(heavy, 1.0, 0.1).to(dtype)
    return [assemble.gather_params(ticks - CHAIN + 1 + k,
                                   x0[ticks - CHAIN + 1 + k], refs, timing,
                                   CFG, k1, k2, mass) for k in range(CHAIN)]


def _run_chain(solve, params):
    state = sqp.init_solver_state(CFG, params[0].x0, mass=params[0].mass)
    out = []
    for p in params:
        state, info = solve(state, p, CFG)
        out.append((*state, *info))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 256])
def test_replayed_chain_is_the_eager_chain_bit_for_bit(B, dtype, cuda):
    """A 12-solve warm chain from recorded ticks: z, y and every SolveInfo
    field of each step of the replayed solve equal the eager route's."""
    params = _chain_params(B, dtype, cuda, seed=B)
    replayed = _run_chain(sqp.solve_mpc, params)
    eager = _run_chain(sqp._solve_mpc_condip_eager, params)
    for k, (r, e) in enumerate(zip(replayed, eager)):
        _assert_same_bits(r, e, f"B={B} {dtype} step {k}")


def test_an_answer_outlives_later_replays(cuda):
    """The answer of one call is untouched by ten more calls on other
    inputs: the solve's outputs are fresh tensors, not the graphs' own."""
    params = _chain_params(64, torch.float32, cuda, seed=5)
    state = sqp.init_solver_state(CFG, params[0].x0, mass=params[0].mass)
    first, info = sqp.solve_mpc(state, params[0], CFG)
    kept = [t.clone() for t in (*first, *info)]
    for p in params[1:11]:
        state, _ = sqp.solve_mpc(state, p, CFG)
    _assert_same_bits((*first, *info), kept, "the first answer")


def test_one_capture_per_stage_and_the_launch_counts(cuda):
    """A signature not seen before (B = 3) captures each stage once, on its
    first solve; every solve replays 2 + 3 x sqp_iters graphs and counts
    120 tile, 96 substitution and 24 Newton matrix launches, as the eager
    solve does."""
    params = _chain_params(3, torch.float32, cuda, seed=3)
    state = sqp.init_solver_state(CFG, params[0].x0, mass=params[0].mass)
    c0, n0 = dict(graphs.COUNTS), dict(tbc.LAUNCHES)
    for k, p in enumerate(params[:4]):
        state, _ = sqp.solve_mpc(state, p, CFG)
        assert graphs.COUNTS["captures"] - c0["captures"] == STAGES
        assert graphs.COUNTS["replays"] - c0["replays"] == REPLAYS * (k + 1)
        assert tbc.LAUNCHES["chol_inv_tile"] - n0["chol_inv_tile"] \
            == 120 * (k + 1)
        assert tbc.LAUNCHES["chol_solve"] - n0["chol_solve"] == 96 * (k + 1)
        assert tbc.LAUNCHES["newton_matrix"] - n0["newton_matrix"] \
            == 24 * (k + 1)
        assert tbc.LAUNCHES["chol_tile"] == n0["chol_tile"]
    n1 = dict(tbc.LAUNCHES)
    sqp._solve_mpc_condip_eager(state, params[4], CFG)
    assert tbc.LAUNCHES["chol_inv_tile"] - n1["chol_inv_tile"] == 120
    assert tbc.LAUNCHES["chol_solve"] - n1["chol_solve"] == 96
    assert tbc.LAUNCHES["newton_matrix"] - n1["newton_matrix"] == 24


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)(*(_to(x, device) for x in tree))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_replayed_ticks_are_the_eager_ticks_bit_for_bit(dtype, cuda,
                                                        monkeypatch):
    """Five closed-loop ticks, 259-263, of the sweep's pushed and loaded
    batch (``tests/_sweep_cases.py``, B = 8), through the footstep
    adaptation at 261: every field of each tick's carry equals the eager
    tick's."""
    import _sweep_cases as cases

    def ticks():
        sc, carry = cases.start(259, dtype)
        sc, carry = _to(sc, cuda), _to(carry, cuda)
        _, tick = closed_loop.rollout(sc, cases.CFG, return_tick=True,
                                      t0=259, carry_in=carry)
        out = []
        for t in range(259, 264):
            carry, trace = tick(carry, t)
            out.append(list(cases.fields(carry).values()) + [trace.x0])
        return out

    replayed = ticks()
    monkeypatch.setattr(sqp, "_solve_mpc_condip",
                        sqp._solve_mpc_condip_eager)
    eager = ticks()
    for t, r, e in zip(range(259, 264), replayed, eager):
        _assert_same_bits(r, e, f"{dtype} tick {t}")
