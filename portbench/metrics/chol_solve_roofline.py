"""chol_solve_roofline: percent of its roofline that the block substitution
kernel (csrc/chol_solve.cu, chol_solve::solve_kernel) reaches: the least
time of one launch over its mean device time per launch, taken by name
from the device trace.  None where no such kernel ran (a program that
forms the Newton inverse instead).

The least time is bytes over the memory rate: every nonzero 64 x 64 block
of the factor the kernel reads -- the K (K - 1) / 2 blocks of L below the
diagonal and the K tile inverses, K = ceil(n / 64) for the n x n Newton
matrix -- read once per scenario of the batch.  At the configuration's
n = 320 that is 15 blocks, 245,760 bytes per scenario in float32, 0.150 ms
at B = 2048.  The kernel reads each block once in each of its two sweeps,
so a share above 50% needs the second read served from L2, and none can
pass 100%.  The vectors (2 n elements) are left out."""

from portbench.flops import NU
from portbench.loads.common import DTYPES
from portbench.peaks import H100

TILE = 64


def least_s(batch: int, walk: dict, itemsize: int) -> float:
    """Seconds of one launch at the memory rate, each block read once."""
    n = NU * walk["N"] + (walk["N"] + 1 if walk["condip_soft"] else 0)
    K = -(-n // TILE)
    blocks = K * (K - 1) // 2 + K
    return batch * blocks * TILE * TILE * itemsize / H100["bytes_per_s"]


def read(run):
    p = run.get("profile")
    if not p:
        return None
    rows = [k for name, k in p["kernels"].items() if "chol_solve::" in name]
    n = sum(k["launches"] for k in rows)
    if not n:
        return None
    mean_s = sum(k["seconds"] for k in rows) / n
    config = run["config"]
    itemsize = DTYPES[config["dtype"]].itemsize
    return 100.0 * least_s(run["batch"], config["walk_config"],
                           itemsize) / mean_s
