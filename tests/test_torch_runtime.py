"""The port's runtime pieces against the JAX package's: checkpoints
(cmpc_tpu_torch.runtime.checkpoint) that cross between the two packages,
and the validation entry points (cmpc_tpu_torch.entry)."""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmpc_tpu.config import WalkConfig as JCfg, nominal_scenario as jnominal
from cmpc_tpu.runtime import checkpoint as jckpt
from cmpc_tpu.sim import closed_loop as jcl
from cmpc_tpu_torch import convert, entry as tentry
from cmpc_tpu_torch.config import WalkConfig, nominal_scenario
from cmpc_tpu_torch.ops.sqp import SolverState
from cmpc_tpu_torch.runtime import checkpoint as tckpt
from cmpc_tpu_torch.sim import closed_loop as tcl

# the suite runs several worker processes per host: one intra-op thread
# each (more only oversubscribes the cores and slows every worker)
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CFG, JCFG = WalkConfig(), JCfg()


@pytest.fixture()
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _carry(batch=2, ticks=2):
    sc = nominal_scenario(CFG, device="cpu", dtype=torch.float64)
    return tcl.rollout(sc.repeat(batch), CFG, T_sim=ticks)[0]


def _leaves(tree):
    return [v for _, v in tckpt._flatten(tree)]


def test_checkpoint_roundtrip_of_a_loop_carry(tmp_path):
    """A LoopCarry (nested NamedTuples) inside a dict with a list and a
    step number: every leaf comes back equal, in the dtype of `like`."""
    carry = _carry()
    tree = {"carry": carry, "stats": [torch.tensor(1.5), torch.tensor(7)],
            "cursor": (torch.arange(3),)}
    p = str(tmp_path / "ckpt_3.npz")
    tckpt.save(p, tree, step=3, meta={"run": "test"})
    assert os.path.exists(p + ".json")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    like = {"carry": type(carry)(*_zero_like(carry)),
            "stats": [torch.tensor(0.0), torch.tensor(0)],
            "cursor": (torch.zeros(3, dtype=torch.int64),)}
    got, step = tckpt.restore(p, like, device="cpu")
    assert step == 3
    assert isinstance(got["carry"], type(carry))
    assert isinstance(got["carry"].solver, SolverState)
    assert isinstance(got["stats"], list) and isinstance(got["cursor"], tuple)
    for a, b in zip(_leaves(got), _leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a like-tree in another precision decides the restored dtype
    like32 = {"carry": type(carry)(*_zero_like(carry, torch.float32))}
    got32, _ = tckpt.restore(p, like32, device="cpu")
    assert got32["carry"].plant.com_pos.dtype == torch.float32
    # no step stored -> -1
    tckpt.save(str(tmp_path / "nostep.npz"), {"a": torch.zeros(2)})
    assert tckpt.restore(str(tmp_path / "nostep.npz"),
                         {"a": torch.zeros(2)}, device="cpu")[1] == -1


def _zero_like(tree, dtype=None):
    out = []
    for v in tree:
        if isinstance(v, torch.Tensor):
            out.append(torch.zeros_like(
                v, dtype=dtype if v.is_floating_point() else None))
        else:
            out.append(type(v)(*_zero_like(v, dtype)))
    return out


def test_checkpoint_structure_mismatch_raises(tmp_path):
    p = str(tmp_path / "ckpt_0.npz")
    tckpt.save(p, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="missing leaves"):
        tckpt.restore(p, {"b": torch.zeros(2)}, device="cpu")
    with pytest.raises(KeyError):
        tckpt.restore(p, {"a": {"x": torch.zeros(2)}}, device="cpu")


def test_checkpoint_latest_picks_the_highest_number(tmp_path):
    assert tckpt.latest(str(tmp_path / "absent")) is None
    assert tckpt.latest(str(tmp_path)) is None
    for k in (3, 12, 7):
        tckpt.save(str(tmp_path / f"ckpt_{k}.npz"), {"a": torch.zeros(1)},
                   step=k)
    (tmp_path / "other_99.npz").write_bytes(b"")
    assert tckpt.latest(str(tmp_path)) == str(tmp_path / "ckpt_12.npz")


def test_checkpoint_restore_defaults_to_the_card(tmp_path, monkeypatch):
    p = str(tmp_path / "ckpt_0.npz")
    tckpt.save(p, {"a": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tckpt.restore(p, {"a": torch.zeros(2)})


def test_checkpoint_crosses_between_the_packages(tmp_path):
    """A LoopCarry written by cmpc_tpu.runtime.checkpoint restores in the
    port, and one written by the port restores in the JAX package: the
    key-path strings agree, and every leaf is equal.  Both carries are the
    packages' own initial ones for two nominal scenarios, f32."""
    jsc = jax.tree.map(lambda x: jnp.stack([jnp.asarray(x)] * 2),
                       jnominal(JCFG))
    jcarry = jax.vmap(
        lambda s: jcl.rollout(s, JCFG, return_tick=True)[0])(jsc)
    sc = nominal_scenario(CFG, device="cpu").repeat(2)
    tcarry = tcl.rollout(sc, CFG, return_tick=True)[0]
    tcarry = tcarry._replace(theta_hat=tcarry.theta_hat + 0.25)

    p = str(tmp_path / "from_jax.npz")
    jckpt.save(p, {"carry": jcarry, "done": [jnp.asarray(4)]}, step=11)
    got, step = tckpt.restore(p, {"carry": tcarry,
                                  "done": [torch.tensor(0)]}, device="cpu")
    assert step == 11 and int(got["done"][0]) == 4
    want = jax.tree.leaves(jcarry)
    have = _leaves(got["carry"])
    assert len(have) == len(want)
    # both flatten NamedTuples in field order
    for a, b in zip(have, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    q = str(tmp_path / "from_torch.npz")
    tckpt.save(q, {"carry": tcarry, "done": [torch.tensor(5)]}, step=12)
    back, step = jckpt.restore(q, {"carry": jcarry,
                                   "done": [jnp.asarray(0)]})
    assert step == 12 and int(back["done"][0]) == 5
    for a, b in zip(jax.tree.leaves(back["carry"]), _leaves(tcarry)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # and the port's loop carries on from the JAX package's checkpoint
    carry2, _ = tcl.rollout(sc, CFG, T_sim=1, carry_in=got["carry"])
    assert torch.isfinite(carry2.plant.com_pos).all()


def test_entry_matches_jax(x64):
    """entry() on the CPU in f64: the arguments have the JAX entry's shapes
    and agree with them at 1e-6 (the JAX scenario stores some fields in
    float32), and the step on the JAX entry's own arguments, carried over
    through cmpc_tpu_torch.convert, gives its z and r_prim at 1e-6."""
    import __graft_entry__ as graft

    jstep, (jstates, jparams) = graft.entry()
    jz, jr = jax.jit(jstep)(jstates, jparams)
    tstep, (tstates, tparams) = tentry.entry("cpu", torch.float64)
    for got, want in ((tstates, jstates), (tparams, jparams)):
        assert got._fields == want._fields
        for name in want._fields:
            a, b = getattr(got, name), np.asarray(getattr(want, name))
            assert tuple(a.shape) == b.shape, name
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6,
                                       err_msg=name)
    z, r = tstep(tstates, tparams)
    assert tuple(z.shape) == jz.shape == (8, CFG.n_z)
    assert tuple(r.shape) == jr.shape == (8,)
    assert torch.isfinite(z).all() and torch.isfinite(r).all()

    def as_np(t):
        return {k: np.asarray(v) for k, v in t._asdict().items()}

    z2, r2 = tstep(convert.solver_state_from_numpy(as_np(jstates), "cpu"),
                   convert.params_from_numpy(as_np(jparams), "cpu"))
    np.testing.assert_allclose(z2.numpy(), np.asarray(jz), rtol=0, atol=1e-6)
    np.testing.assert_allclose(r2.numpy(), np.asarray(jr), rtol=0, atol=1e-6)


def test_entry_runs_in_f32_and_defaults_to_the_card(monkeypatch):
    step, args = tentry.entry("cpu")
    z, r = step(*args)
    assert z.dtype == torch.float32 and tuple(z.shape) == (8, CFG.n_z)
    assert torch.isfinite(z).all() and torch.isfinite(r).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dryrun_one_device_on_the_cpu(dtype):
    """Lane independence under a permutation (bit for bit) and the device
    reductions against host reductions, on the tiny heterogeneous sweep."""
    tentry.dryrun_one_device("cpu", dtype)


def test_trace_load_round_trip_and_jax_saved(tmp_path):
    """runtime.trace.load: the port's saved trace reads back field by field
    (nested names joined by '/'), as the JAX package's load reads it; and a
    trace the JAX package saved reads back in the port."""
    from cmpc_tpu.runtime import trace as jtrace
    from cmpc_tpu_torch.runtime import trace as ttrace

    _, tr = tcl.rollout(nominal_scenario(CFG, device="cpu"), CFG, T_sim=3)
    p = str(tmp_path / "port" / "trace.npz")
    ttrace.save(p, {"tr": tr, "note": torch.arange(3)}, meta={"cmd": "t"})
    got = ttrace.load(p)
    assert set(got) == {f"tr/{k}" for k in tr._fields} | {"note"}
    for k in tr._fields:
        np.testing.assert_array_equal(got[f"tr/{k}"],
                                      getattr(tr, k).numpy())
    for k, v in jtrace.load(p).items():
        np.testing.assert_array_equal(v, got[k])

    rng = np.random.default_rng(0)
    jtr = {"com_pos": jnp.asarray(rng.normal(size=(5, 3))),
           "solver": {"z": jnp.asarray(rng.normal(size=(5, 7)))}}
    q = str(tmp_path / "jax" / "trace.npz")
    jtrace.save(q, jtr)
    got = ttrace.load(q)
    assert set(got) == {"com_pos", "solver/z"}
    np.testing.assert_array_equal(got["solver/z"],
                                  np.asarray(jtr["solver"]["z"]))


def test_plots_plot_all(tmp_path):
    """The four dashboards from one scenario's row of a trace, tensors
    taken as they are."""
    pytest.importorskip("matplotlib")
    from cmpc_tpu_torch.runtime import plots

    _, tr = tcl.rollout(nominal_scenario(CFG, device="cpu"), CFG, T_sim=3)
    row0 = {k: v[0] for k, v in tr._asdict().items()}
    paths = plots.plot_all(row0, str(tmp_path / "plots"),
                           plan_pos=torch.zeros(4, 3))
    assert [os.path.basename(p) for p in paths] == [
        "com.png", "momentum.png", "theta.png", "footsteps.png"]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_cli_walk_plots(tmp_path):
    """`walk --plots --device cpu --ticks 5` writes the trace and the four
    dashboards into --out."""
    pytest.importorskip("matplotlib")
    import subprocess
    out = subprocess.run(
        [sys.executable, "-m", "cmpc_tpu_torch", "walk", "--device", "cpu",
         "--ticks", "5", "--plots", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    for name in ("trace.npz", "com.png", "momentum.png", "theta.png",
                 "footsteps.png"):
        assert (tmp_path / name).exists(), name


def test_plots_without_matplotlib_name_it(monkeypatch):
    """Where matplotlib is missing a plot raises an
    ImportError that names it."""
    from cmpc_tpu_torch.runtime import plots

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plots.plot_theta({"theta_hat": np.zeros((3, 3))})
