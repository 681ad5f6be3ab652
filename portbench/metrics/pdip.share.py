"""pdip.share: percent of the solve's time inside the interior-point
solves: the spans around ops.sqp's pdip_solve over the spans around
sqp.solve_mpc, each with a synchronize at both ends (program spans taken
from the benchmark's wrappers)."""


def read(run):
    spans = run.get("spans") or {}
    solve, pdip = sum(spans.get("solve", [])), sum(spans.get("pdip", []))
    return 100.0 * pdip / solve if solve > 0 and pdip > 0 else None
