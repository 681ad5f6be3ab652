"""The comparison that decides ``correct`` catches what it is there to
catch, on the CPU at a small size: each fault of ``portbench/faults.py``
planted under a run of the cell, and the control (the reference in float32
with TF32 products in the program's place), come out not correct.
(``test_portbench_run.py`` has the sound run come out correct.)"""

import time

import pytest

from portbench import control, core, faults
from portbench.tests.conftest import QUICK_SOLVE

WORKLOAD = "centroidal-solve-b2048"


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    """The whole run (set-up, window, reference, result) with the program's
    solve broken underneath."""
    from cmpc_tpu_torch.ops import sqp
    monkeypatch.setattr(sqp, "solve_mpc",
                        faults.broken_solve(fault, sqp.solve_mpc))
    result = core.run_cell(WORKLOAD, 4242, 0.3, False, time.perf_counter(),
                           device="cpu", require_chip=False,
                           mix_overrides=QUICK_SOLVE)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("seed", [4242, 4243, 2**31 + 7])
def test_the_control_is_not_correct(seed):
    got = control.readings(WORKLOAD, seed, 0.3, True, device="cpu",
                           mix_overrides=QUICK_SOLVE)
    assert got["correct"] is False, got["numbers"]
