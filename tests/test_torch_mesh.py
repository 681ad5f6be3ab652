"""The port's sweep across processes (cmpc_tpu_torch.parallel.mesh with
torch.distributed): the counterpart of tests/test_multihost.py.

Two processes on the CPU, joined by a gloo process group through torchrun's
variables (tests/_torch_mesh_worker.py), run the small gait of
``__graft_entry__.dryrun_multichip``; their all-reduced statistics and
gathered rows are held to a one-process run of the whole batch, and a
rank's rows to the JAX package's ``sweep_per_scenario``.  Plus the mesh's
refusals: no card, no NCCL, a LOCAL_RANK past the card count, two ranks on
one card with NCCL."""

import functools
import importlib.util
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from cmpc_tpu.config import Scenario as JScenario, WalkConfig as JCfg
from cmpc_tpu.parallel import mesh as jmesh
from cmpc_tpu_torch.config import WalkConfig
from cmpc_tpu_torch.parallel import mesh as tmesh
from _torch_mesh_worker import SMALL, run_ranks, run_sweep_tool

# the suite runs several worker processes per host: one intra-op thread
# each (more only oversubscribes the cores and slows every worker)
torch.set_num_threads(1)

CFG, JCFG = WalkConfig(**SMALL), JCfg(**SMALL)
N, T = 8, 4


def _ranks(argv, world=2):
    """Each rank's (stdout, stderr) of `argv` run as `world` ranks of one
    gloo group, every one of which must exit 0."""
    outs = run_ranks(argv, world)
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return [(out, err) for _, out, err in outs]


def _json_lines(outs):
    return [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]


@functools.lru_cache(maxsize=None)
def _two_rank_sweep():
    return _json_lines(_ranks(["tests/_torch_mesh_worker.py", "sweep"]))


def _batch():
    return tmesh.make_batch(CFG, N, seed=0, device="cpu",
                            dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def _one_process():
    """The whole batch in this process: per-scenario rows, the sweep's
    statistics and the chunked runner's rows."""
    per = tmesh.sweep_per_scenario(_batch(), CFG, T)
    stats = tmesh.reduce_stats(per)
    host, dev, _ = tmesh.sweep_chunked(_batch(), CFG, T, 2)
    return ({k: v.numpy() for k, v in per._asdict().items()},
            {k: float(v) for k, v in stats._asdict().items()}, host,
            dev.numpy())


def test_two_ranks_agree_with_one_process():
    """Both ranks see the global n and hold identical statistics, equal to
    the one-process sweep (n and the maximum exactly, the sums, taken in
    another order, at 1e-12); the gathered rows, in global order, and the
    chunked runner's rows equal the one-process rows bit for bit."""
    a, b = _two_rank_sweep()
    assert (a["rank"], b["rank"]) == (0, 1)
    assert a["world_size"] == b["world_size"] == 2 and a["backend"] == "gloo"
    assert a["stats"] == b["stats"]
    assert a["stats"]["n"] == float(N)
    per, stats, host, dev = _one_process()
    for k, v in stats.items():
        np.testing.assert_allclose(a["stats"][k], v, rtol=1e-12, atol=0,
                                   err_msg=k)
    assert a["stats"]["max_tilt"] == stats["max_tilt"]
    for out in (a, b):
        for k, v in per.items():
            np.testing.assert_array_equal(out["gathered"][k], v, err_msg=k)
            k0 = out["rank"] * (N // 2)
            np.testing.assert_array_equal(out["local"][k],
                                          v[k0:k0 + N // 2], err_msg=k)
        assert out["ticks"] == T
        np.testing.assert_array_equal(out["chunked_host"], host)
        np.testing.assert_array_equal(out["chunked_dev"], dev)


def test_rank_rows_match_jax(monkeypatch):
    """Each rank's rows against the JAX package's sweep_per_scenario of the
    same scenarios, f64, at 1e-9."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        b = _batch()
        jb = JScenario(**{k: jnp.asarray(v.numpy())
                          for k, v in b._asdict().items()})
        want = jmesh.sweep_per_scenario(
            jb, JCFG, T, mesh=jmesh.make_mesh(jax.devices()[:1]))
    finally:
        jax.config.update("jax_enable_x64", old)
    for out in _two_rank_sweep():
        k0 = out["rank"] * (N // 2)
        for k in want._fields:
            np.testing.assert_allclose(
                out["local"][k], np.asarray(getattr(want, k))[k0:k0 + N // 2],
                rtol=0, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_multichip(world):
    """entry.dryrun_multichip at 2 and 4 ranks on the CPU: its three
    criteria hold, and bitwise (every deviation 0)."""
    outs = _json_lines(_ranks(["tests/_torch_mesh_worker.py", "dryrun"],
                              world))
    for r, out in enumerate(outs):
        assert out["rank"] == r and out["world_size"] == world
        assert out["n"] == 2 * world
        assert out["backend"] == "gloo" and out["device"] == "cpu"
        assert out["placement_dev"] == out["shard_alone_dev"] == \
            out["whole_batch_dev"] == 0.0


def test_cli_sweep_under_torchrun():
    """`python -m cmpc_tpu_torch sweep --device cpu` under torchrun's
    variables at 2 ranks: rank 0 prints the JSON, rank 1 nothing; n is cut
    to a multiple of the ranks as in the JAX command."""
    outs = _ranks(["-m", "cmpc_tpu_torch", "sweep", "--device", "cpu",
                   "--n", "5", "--ticks", "2"])
    out = json.loads(outs[0][0].strip().splitlines()[-1])
    assert outs[1][0].strip() == ""
    assert out["n"] == 4.0 and np.isfinite(list(out.values())).all()
    assert set(out) == {"n", "com_rmse_xy", "max_tilt", "fall_rate",
                        "mean_lyap_violation", "mean_r_prim", "wall_s"}


def test_run_sweep_tool_under_torchrun(tmp_path):
    """tools/run_sweep_torch.py under torchrun's variables at 2 ranks, the
    production configuration at 4 scenarios for 4 ticks: rank 0 writes
    --out and prints it, rank 1 neither; its statistics, from the gathered
    rows, and the rows themselves equal a one-process run of the same
    batch."""
    tool = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "tools", "run_sweep_torch.py")
    path = tmp_path / "sweep.json"
    outs = _ranks([tool, "4", "4", "2", "--device", "cpu", "--out",
                   str(path)])
    assert outs[1][0].strip() == ""
    got = json.loads(path.read_text())
    assert json.loads(outs[0][0].strip().splitlines()[-1]) == got
    assert (got["ranks"], got["backend"]) == (2, "gloo")
    assert (got["n_scenarios"], got["ticks"]) == (4, 4)
    spec = importlib.util.spec_from_file_location("run_sweep_torch", tool)
    tool_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool_mod)
    one = tool_mod.run(4, 4, 2, device="cpu")
    assert got["stats"] == one["stats"]
    assert got["rows"] == one["rows"]


def test_run_sweep_tool_gathers_fall_chunks_in_order():
    """tools/run_sweep_torch.run at 2 ranks on a batch whose last scenario
    (rank 1's second) falls: every rank's gathered rows, fall_chunk
    included, equal a one-process run's, in global order."""
    outs = _json_lines(_ranks(["tests/_torch_mesh_worker.py", "fallen"]))
    one = run_sweep_tool()["rows"]
    assert [r["fall_chunk"] for r in one][:3] == [None] * 3
    assert one[3]["fall_chunk"] is not None
    for out in outs:
        assert out["rows"] == one


def _mesh(rank, world):
    return tmesh.Mesh(rank=rank, world_size=world,
                      device=torch.device("cpu"), backend="gloo", group=None)


def test_shard_scenarios_slices_contiguous_rows():
    b = tmesh.make_batch(CFG, 6, seed=3, device="cpu")
    for r in range(3):
        s = tmesh.shard_scenarios(b, _mesh(r, 3))
        for name in b._fields:
            assert torch.equal(getattr(s, name),
                               getattr(b, name)[2 * r:2 * r + 2]), name
            assert getattr(s, name).data_ptr() != getattr(b, name).data_ptr()
    with pytest.raises(ValueError, match="do not split evenly"):
        tmesh.shard_scenarios(b, _mesh(0, 4))


def test_one_rank_group_without_torchrun(monkeypatch):
    """Without torchrun's variables make_mesh starts a group of one in this
    process; the sweep over it equals the sweep without a mesh bit for bit
    (its all-reduce is the identity), and close() ends the group."""
    for k in tmesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    m = tmesh.make_mesh("cpu")
    try:
        assert (m.rank, m.world_size, m.backend) == (0, 1, "gloo")
        b = tmesh.make_batch(CFG, 2, seed=1, device="cpu")
        with_mesh = tmesh.sweep(tmesh.shard_scenarios(b, m), CFG, 2, mesh=m)
        without = tmesh.sweep(b, CFG, 2)
        for x, y in zip(with_mesh, without):
            assert torch.equal(x, y)
        with pytest.raises(ValueError, match="lies on"):
            tmesh.sweep_per_scenario(b.to("meta"), CFG, 2, mesh=m)
    finally:
        m.close()
    assert not dist.is_initialized()


def test_make_mesh_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh("cuda")
    assert not dist.is_initialized()


def test_make_mesh_refuses_a_missing_nccl(monkeypatch):
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="no NCCL"):
        tmesh.make_mesh("cpu", backend="nccl")
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tmesh.make_mesh("cpu", backend="nccl")
    assert not dist.is_initialized()


def test_make_mesh_refuses_a_local_rank_past_the_cards(monkeypatch):
    """"cuda" is the card numbered LOCAL_RANK: a rank with no card of its
    own raises instead of sharing one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2 has no card"):
        tmesh.make_mesh("cuda")
    assert not dist.is_initialized()


def test_shared_cards():
    """The check behind NCCL's refusal: pairs of ranks on one card."""
    assert tmesh.shared_cards(["h/a", "h/b", "g/a"]) == []
    assert tmesh.shared_cards(["h/a", "h/b", "h/a", "h/a"]) == [(0, 2),
                                                                (0, 3)]
