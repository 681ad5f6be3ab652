"""solve_mfu: percent of the card's float32 peak (67 TFLOP/s, TF32 off)
that the solves reach: the operations the solves need (portbench/flops.py,
a lower bound of the least work) over the seconds of the spans around
sqp.solve_mpc."""

from portbench.flops import solve_flops
from portbench.peaks import H100


def read(run):
    spans = (run.get("spans") or {}).get("solve", [])
    if not spans:
        return None
    ops = solve_flops(run["config"]["walk_config"]) * run["batch"] * len(spans)
    return 100.0 * ops / (sum(spans) * H100["f32_flop_per_s"])
