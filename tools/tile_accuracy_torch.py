"""Hold the tile kernel and its plain version against float64 on the tiles
that the closed loop really factors.

Steps the port's tick from the JAX package's recorded carries (as
tools/step_parity_torch.py does, float32) and, at every tile step of the
Newton inverse, computes the same tiles three ways: the kernel (whose
results the tick goes on with), chol_inv_tile_ref, and float64 (a
Cholesky and a triangular solve of the tile's lower triangle, made
symmetric).  Counts the tiles that are not positive definite in float64
(their f32 pivots hit the elimination's clamp); over the others reports
the relative error of each one's L and L^-1 against float64, per tile
(the largest element error over the largest element), as percentiles,
with the tile's condition estimate (largest over smallest pivot of the
f64 factor, squared) where the kernel is worst.

    python tools/tile_accuracy_torch.py runs/jax_f32/carries.npz \\
        [--device cuda] [--out PATH]

Imports no JAX.  On the CPU the "kernel" is the plain version itself.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import numpy as np
import torch

PCTS = (50, 90, 99, 99.9, 100)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("carries", help="carries.npz of tools/step_parity_jax.py")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import step_parity_torch
    from cmpc_tpu_torch.ops import batched_chol as bc

    kernel_into = bc.chol_inv_tile_into
    rec = {k: [] for k in ("L_kernel", "L_ref", "X_kernel", "X_ref",
                           "cond", "pd")}

    def rel(M, ref):
        scale = ref.abs().amax((-1, -2))
        return (M.double() - ref).abs().amax((-1, -2)) / scale

    def into(A, L, X):
        kernel_into(A, L, X)
        A64 = A.double().tril()
        A64 = A64 + A64.tril(-1).transpose(-1, -2)
        L64, info = torch.linalg.cholesky_ex(A64)
        eye = torch.eye(A.shape[-1], dtype=A64.dtype, device=A.device)
        X64 = torch.linalg.solve_triangular(L64, eye.expand_as(L64),
                                            upper=False)
        Lr, Xr = bc.chol_inv_tile_ref(A.contiguous())
        d = torch.diagonal(L64, dim1=-2, dim2=-1)
        rec["L_kernel"].append(rel(L, L64))
        rec["L_ref"].append(rel(Lr, L64))
        rec["X_kernel"].append(rel(X, X64))
        rec["X_ref"].append(rel(Xr, X64))
        rec["cond"].append((d.amax(-1) / d.amin(-1)) ** 2)
        rec["pd"].append(info == 0)

    bc.chol_inv_tile_into = into
    try:
        parity = step_parity_torch.run(args.carries, args.device)
    finally:
        bc.chol_inv_tile_into = kernel_into
    got = {k: torch.cat(v).cpu().numpy() for k, v in rec.items()}
    pd = got["pd"]
    out = {"device": parity["device"], "dtype": parity["dtype"],
           "tiles": int(len(pd)), "launches": parity["launches"],
           "f64_not_pd": int((~pd).sum())}
    for k in ("L_kernel", "L_ref", "X_kernel", "X_ref"):
        e = got[k][pd]
        out[k] = {f"p{p}": float(np.nanpercentile(e, p)) if len(e) else None
                  for p in PCTS}
        out[k]["not_finite"] = int((~np.isfinite(e)).sum())
    worse = got["X_kernel"][pd] / np.maximum(got["X_ref"][pd], 1e-30)
    out["X_kernel_over_ref"] = {
        f"p{p}": float(np.nanpercentile(worse, p)) if len(worse) else None
        for p in PCTS}
    worst = np.nonzero(pd)[0][np.argsort(
        np.nan_to_num(got["X_kernel"][pd], nan=np.inf))[-5:]]
    out["worst_X_kernel"] = [{"X_kernel": float(got["X_kernel"][i]),
                              "X_ref": float(got["X_ref"][i]),
                              "cond": float(got["cond"][i])} for i in worst]
    out["parity_rows"] = [{"row": r["row"], "p50": r["p50"], "p90": r["p90"],
                           "max": max(r["max_diff"].values())}
                          for r in parity["rows"]]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
