"""The PyTorch port's static configuration, entry points and import hygiene:
WalkConfig, the gait timing tables and the scenarios must equal the JAX
package's; the port must never import JAX; the CLI runs on the CPU and
refuses a missing card."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cmpc_tpu import config as jconfig
from cmpc_tpu.plan import timing as jtiming
from cmpc_tpu_torch import config as tconfig
from cmpc_tpu_torch.plan import timing as ttiming

# the suite runs several worker processes per host: one intra-op thread
# each (more only oversubscribes the cores and slows every worker)
torch.set_num_threads(1)

CFG_VARIANTS = [dict(), dict(num_steps=5), dict(num_steps=24, N=8),
                dict(mpc_rate=2, first_swing="lfoot")]


def test_walkconfig_fields_and_defaults():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.WalkConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.WalkConfig)]
    assert tf == jf


@pytest.mark.parametrize("kw", CFG_VARIANTS)
def test_walkconfig_properties(kw):
    j, t = jconfig.WalkConfig(**kw), tconfig.WalkConfig(**kw)
    for name in ("eta", "delta", "total_ticks", "pad_ticks", "n_x", "n_u",
                 "n_z"):
        assert getattr(t, name) == getattr(j, name), name
    np.testing.assert_array_equal(tconfig.default_vref(t.num_steps),
                                  jconfig.default_vref(j.num_steps))


@pytest.mark.parametrize("kw", CFG_VARIANTS)
def test_timing_tables_equal(kw):
    j = jtiming.build_timing(jconfig.WalkConfig(**kw))
    t = ttiming.build_timing(tconfig.WalkConfig(**kw))
    for f in dataclasses.fields(jtiming.GaitTiming):
        a, b = getattr(j, f.name), getattr(t, f.name)
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=f.name)
        assert np.asarray(b).dtype == np.asarray(a).dtype, f.name


@pytest.mark.parametrize("which", ["nominal", "payload"])
def test_scenarios_equal(which):
    jc, tc = jconfig.WalkConfig(), tconfig.WalkConfig()
    if which == "nominal":
        j = jconfig.nominal_scenario(jc)
        t = tconfig.nominal_scenario(tc, device="cpu", dtype=torch.float32)
    else:
        j = jconfig.payload_scenario(jc, onset_tick=120)
        t = tconfig.payload_scenario(tc, onset_tick=120, device="cpu",
                                     dtype=torch.float32)
    assert t._fields == j._fields
    for name in j._fields:
        a = np.asarray(getattr(j, name))
        b = getattr(t, name)
        assert b.shape == (1,) + a.shape, name
        np.testing.assert_array_equal(b[0].numpy(), a, err_msg=name)
        assert b.is_floating_point() == np.issubdtype(a.dtype, np.floating)


def test_scenario_to_and_repeat():
    sc = tconfig.nominal_scenario(tconfig.WalkConfig(),
                                  device="cpu").repeat(3)
    s64 = sc.to(dtype=torch.float64)
    assert all(v.shape[0] == 3 for v in s64)
    assert s64.k1.dtype == torch.float64 and s64.vref.shape == (3, 20, 3)
    assert s64.push_start.dtype == torch.int64


def test_gains_equal():
    """Gains: the JAX NamedTuple's fields, in order, holding per-scenario
    tensors."""
    assert tconfig.Gains._fields == jconfig.Gains._fields == ("k1", "k2")
    g = tconfig.Gains(k1=torch.tensor([4.0, 7.0]), k2=torch.tensor([0.1, 1.0]))
    assert g.k1.shape == (2,) and g._asdict().keys() == {"k1", "k2"}


def test_port_never_imports_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import cmpc_tpu_torch\n"
        "for m in pkgutil.walk_packages(cmpc_tpu_torch.__path__, "
        "'cmpc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'cmpc_tpu' or k.startswith('cmpc_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules "
        "if k.startswith('cmpc_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sources_name_no_jax_module():
    """No source of the port, chip_smoke.py or a tools/*_torch.py script
    imports jax or a module of the JAX package (comments and docstrings may
    name them)."""
    import glob
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = (glob.glob(os.path.join(root, "cmpc_tpu_torch", "**", "*.py"),
                       recursive=True)
             + glob.glob(os.path.join(root, "tools", "*_torch.py"))
             + [os.path.join(root, "chip_smoke.py")])
    assert len(files) > 40
    pat = re.compile(r"^\s*(import|from)\s+(jax|cmpc_tpu)(\.|\s|$)", re.M)
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad


def test_cli_walk_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "cmpc_tpu_torch", "walk", "--device", "cpu",
         "--ticks", "20", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["ticks"] == 20 and summary["device"] == "cpu"
    assert summary["com_max_err_xy"] < 0.05
    assert (tmp_path / "trace.npz").exists()


def test_cli_cuda_without_card_raises(monkeypatch):
    from cmpc_tpu_torch import __main__ as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["walk", "--device", "cuda", "--ticks", "1"])


@pytest.mark.parametrize("which", ["nominal", "payload"])
def test_scenarios_default_to_the_card(which, monkeypatch):
    """The scenario constructors start a run: their default device is the
    card, and without one they raise instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = getattr(tconfig, f"{which}_scenario")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(tconfig.WalkConfig())


@pytest.mark.parametrize("cmd", ["walk-wb", "sweep", "ismpc"])
def test_cli_unported_commands_raise(cmd, monkeypatch):
    """Every command is ported (the name is from when some were not):
    without --device and without a card each raises and does not run on
    the CPU."""
    from cmpc_tpu_torch import __main__ as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([cmd, "--ticks", "1"])


def test_cli_sweep_cpu(capsys):
    """`sweep --device cpu` prints the JAX command's JSON keys."""
    from cmpc_tpu_torch import __main__ as cli
    cli.main(["sweep", "--device", "cpu", "--n", "4", "--ticks", "5"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"n", "com_rmse_xy", "max_tilt", "fall_rate",
                        "mean_lyap_violation", "mean_r_prim", "wall_s"}
    assert out["n"] == 4.0 and out["fall_rate"] == 0.0
    assert all(np.isfinite(v) for v in out.values())


def test_cli_ismpc_cpu(capsys):
    """`ismpc --device cpu` prints the JAX command's JSON keys."""
    from cmpc_tpu_torch import __main__ as cli
    cli.main(["ismpc", "--device", "cpu", "--ticks", "20"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"ticks", "final_com", "zmp_span_y", "wall_s"}
    assert out["ticks"] == 20 and len(out["final_com"]) == 3
    assert abs(out["final_com"][2] - 0.72) < 1e-3
