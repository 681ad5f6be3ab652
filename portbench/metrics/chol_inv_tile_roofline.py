"""chol_inv_tile_roofline: percent of its roofline that the fused tile
kernel (csrc/chol_inv_tile.cu, the template tile_kernel with the inverse)
reaches: the least time of one launch on the batch's tiles
(portbench/flops.tile_bound_s) over its mean device time per launch, taken
by name from the device trace."""

from portbench.flops import tile_bound_s


def read(run):
    p = run.get("profile")
    if not p:
        return None
    rows = [k for name, k in p["kernels"].items()
            if "tile_kernel" in name and "true" in name]
    n = sum(k["launches"] for k in rows)
    if not n:
        return None
    mean_s = sum(k["seconds"] for k in rows) / n
    return 100.0 * tile_bound_s(run["batch"])[0] / mean_s
