"""Faults planted in the timed path, to show that the comparison with the
reference catches them (``tests/test_portbench_faults.py`` and
``control.py --fault``).  Each wraps the entry the window drives, and
:func:`plant` returns what takes it out again.

* ``unchanged`` — the entry returns the state it was given;
* ``half_batch`` — half of the batch's rows, drawn, keep the state they
  were given (half of the batch left out);
* ``some_rows`` — 8 rows of the batch, drawn, keep the state they were
  given;
* ``altered`` — the answer is altered where it is produced: the batched
  solve's forces moved by 1%.
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "some_rows", "altered")


def _rows(B: int, n: int, device):
    """`n` of the batch's `B` rows, drawn by a fixed generator."""
    g = torch.Generator().manual_seed(0x5EED)
    return torch.randperm(B, generator=g)[:n].to(device)


def broken_solve(name, solve):
    """``ops.sqp.solve_mpc`` with the fault `name`."""
    def broken(state, params, cfg):
        new, info = solve(state, params, cfg)
        if name == "unchanged":
            return state, info
        z, y = new.z.clone(), new.y.clone()
        if name in ("half_batch", "some_rows"):
            B = z.shape[0]
            r = _rows(B, B // 2 if name == "half_batch" else min(8, B),
                      z.device)
            z[r], y[r] = state.z[r], state.y[r]
        else:
            nX = 20 * (cfg.N + 1)
            z[:, nX:] *= 1.01
        return type(new)(z=z, y=y), info
    return broken


def plant(name: str, solver):
    """Plant fault `name` in `solver` (a module or object with
    ``solve_mpc``); returns the undo."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    solve = solver.solve_mpc
    setattr(solver, "solve_mpc", broken_solve(name, solve))
    return lambda: setattr(solver, "solve_mpc", solve)
