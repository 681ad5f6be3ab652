"""The run's result line and its guards, driven on the CPU at a small size
(the look for a card is skipped: ``require_chip=False``)."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench import core
from portbench.tests.conftest import QUICK_SOLVE, SMALL_SOLVE

WORKLOAD = "centroidal-solve-b2048"


@pytest.fixture(scope="module")
def result():
    return core.run_cell(WORKLOAD, 2**31 + 99, 0.5, False,
                         time.perf_counter(), device="cpu",
                         require_chip=False, mix_overrides=SMALL_SOLVE)


def test_result_line_schema(result, capsys):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool)
    assert result["attempted"] >= 16 and result["failed"] == 0
    plan = core.cell_plan(core.load_benchmark(), WORKLOAD)
    assert set(result["metrics"]) == {m["name"] for m in plan["end_to_end"]}
    for m in plan["end_to_end"]:
        got = result["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    limits = core.load_limits(WORKLOAD)
    assert set(result["checks"]) == set(limits)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    core.print_result(result)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    tail = err.strip().splitlines()[-len(limits):]
    assert all(line.startswith("check ") for line in tail)
    assert any(line.startswith("setup parts:") for line in err.splitlines())


def test_sound_run_is_correct(result):
    assert result["correct"], result["checks"]


def test_guard_compares_whole_top_level_names():
    assert core.forbidden_modules(["jax", "jax.numpy", "numpy"]) == ["jax"]
    assert core.forbidden_modules(["cmpc_tpu.ops.sqp"]) == ["cmpc_tpu"]
    assert core.forbidden_modules(["jaxlib.xla_client", "flax"]) == [
        "flax", "jaxlib"]
    assert core.forbidden_modules(["cmpc_tpu_torch", "cmpc_tpu_torch.ops",
                                   "jaxtyping", "portbench"]) == []


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["os"])
    with pytest.raises(core.Failure, match="jax"):
        core.run_cell(WORKLOAD, 1, 0.2, False, time.perf_counter(),
                      device="cpu", require_chip=False,
                      mix_overrides=QUICK_SOLVE)


def test_run_prints_no_result_without_a_card_or_the_program(tmp_path):
    """From the repository: no card here, so exit 1 and no result.  In a
    directory with only BENCHMARK.json and the benchmark: exit 1 too."""
    args = ["--workload", WORKLOAD, "--seed", "1", "--seconds", "1"]
    run = os.path.join("portbench", "run.py")
    out = subprocess.run([sys.executable, run, *args], cwd=core.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(core.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, run, *args], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
