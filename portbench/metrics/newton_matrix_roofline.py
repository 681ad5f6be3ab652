"""newton_matrix_roofline: percent of its roofline that the Newton matrix
kernel (csrc/newton_matrix.cu, newton_matrix::newton_kernel) reaches: the
least time of one launch over its mean device time per launch, taken by
name from the device trace.  None where no such kernel ran (a program that
forms the Newton matrix by a library product and dense passes).

The least time is the larger of bytes over the memory rate and operations
over the float32 rate.  Bytes, per scenario of the batch: H's lower
triangle read, C (m_d x n), the stage blocks (N x 40 x 24) and the scaling
(one per row of the QP) read, and M's lower triangle written, each once.
At the configuration's n = 320, m_d = 141 that is 631,924 bytes in float32,
0.386 ms at B = 2048, which bounds it.  Operations: the Newton matrix's
term of flops.ipm_iteration_flops (each row's outer product over its
nonzero width, lower triangle).  A kernel that writes M whole moves more
than the bytes counted, so none can pass 100%."""

from portbench.flops import NU, _rows, ipm_iteration_flops
from portbench.loads.common import DTYPES
from portbench.peaks import H100

BLK_ROWS, BLK_W = 40, 24            # rows and width of a stage block


def least_s(batch: int, walk: dict, itemsize: int) -> float:
    """Seconds of one launch: the larger of its bytes at the memory rate
    and its operations at the float32 rate."""
    N, soft = walk["N"], walk["condip_soft"]
    rows, ns = _rows(N, soft)
    n, m_d = NU * N + ns, len(rows)
    blk = N * BLK_ROWS
    elems = (n * (n + 1) // 2 + m_d * n + blk * BLK_W + m_d + blk
             + n * (n + 1) // 2)
    t_bytes = batch * elems * itemsize / H100["bytes_per_s"]
    ops = ipm_iteration_flops(N, soft, walk["pdip_refine"])["newton_matrix"]
    t_ops = batch * ops / H100["f32_flop_per_s"]
    return max(t_bytes, t_ops)


def read(run):
    p = run.get("profile")
    if not p:
        return None
    rows = [k for name, k in p["kernels"].items() if "newton_matrix::" in name]
    n = sum(k["launches"] for k in rows)
    if not n:
        return None
    mean_s = sum(k["seconds"] for k in rows) / n
    config = run["config"]
    itemsize = DTYPES[config["dtype"]].itemsize
    return 100.0 * least_s(run["batch"], config["walk_config"],
                           itemsize) / mean_s
