"""Hold the tile kernel and its plain version against float64 on the tiles
that the closed loop really factors.

Steps the port's tick from the JAX package's recorded carries (as
tools/step_parity_torch.py does, float32) and, at every tile step of the
Newton inverse, computes the same tiles three ways: the kernel (whose
results the tick goes on with), chol_inv_tile_ref, and float64 (a
Cholesky and a triangular solve of the tile's lower triangle, made
symmetric).  From the kernel's own L it also computes the inverse by the
other two algorithms: the TPU kernel's row substitution
(tile_check.tri_inv_rows) and the Neumann product (_tri_inv_tile, the JAX
package's CPU branch), and it holds the kernel's X to
tile_check.tri_inv_cols of that L, the kernel's own substitution, bit for
bit.  Counts the tiles whose input holds a value that is not
finite, and among the others those that are not positive definite in
float64 (their f32 pivots hit the elimination's clamp); over the tiles
with finite input that are positive definite it reports the relative
error of each one's L and L^-1 against float64, per tile (the largest
element error over the largest element), as percentiles, with the tile's
condition estimate (largest over smallest pivot of the f64 factor,
squared) where the kernel is worst.  It counts, per implementation, the
tiles whose factor and whose inverse hold a value that is not finite, over
all tiles and over those with finite input (``inverse_from_kernel_L``: n_K,
n_R and n_N for the kernel's X, the row form's and the Neumann product's,
over tiles with finite input), and it holds the kernel's
factor to the plain elimination's bit for bit on the tiles that
chol_tile_ref sends to the elimination (those LAPACK refuses or factors
with a pivot at the clamp).

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
    import tile_check
    from cmpc_tpu_torch.ops import batched_chol as bc, sqp

    kernel_into = bc.chol_inv_tile_into
    outputs = ("L_kernel", "X_kernel", "L_ref", "X_ref", "L_f64", "X_f64",
               "X_rows", "X_neumann")
    errors = ("L_kernel", "L_ref", "X_kernel", "X_ref", "X_rows",
              "X_neumann")
    rec = {k: [] for k in errors + ("cond", "pd", "routed", "finite_in")
           + tuple("nf_" + k for k in outputs)}
    routed_diff = {"calls": 0, "elements": 0, "max_ulp": 0, "first": None}
    cols_diff = {"calls": 0, "elements": 0, "max_ulp": 0,
                 "nan_pattern_equal": True, "first": None}

    def tally(acc, m):
        if m["n_diff"]:
            acc["calls"] += 1
            acc["elements"] += m["n_diff"]
            acc["max_ulp"] = max(acc["max_ulp"], m["max_ulp"])
            acc["first"] = acc["first"] or m["first"]

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
        # the other two algorithms on the kernel's own factor
        Xrows = tile_check.tri_inv_rows(L)
        Xneu = bc._tri_inv_tile(L)
        m = tile_check.bit_mismatch(X, tile_check.tri_inv_cols(L))
        tally(cols_diff, m)
        cols_diff["nan_pattern_equal"] &= m["nan_pattern"]
        d = torch.diagonal(L64, dim1=-2, dim2=-1)
        for k, M, ref in zip(errors, (L, Lr, X, Xr, Xrows, Xneu),
                             (L64, L64) + (X64,) * 4):
            rec[k].append(rel(M, ref))
        rec["cond"].append((d.amax(-1) / d.amin(-1)) ** 2)
        rec["pd"].append(info == 0)
        rec["finite_in"].append(torch.isfinite(A.tril()).flatten(1).all(1))
        for k, M in zip(outputs, (L, X, Lr, Xr, L64, X64, Xrows, Xneu)):
            rec["nf_" + k].append((~torch.isfinite(M)).flatten(1).any(1))
        Lc, inf32 = torch.linalg.cholesky_ex(A.contiguous())
        routed = (inf32 != 0) | ~(torch.diagonal(Lc, dim1=-2, dim2=-1)
                                  > 1e-15).all(-1)
        rec["routed"].append(routed)
        if bool(routed.any()):
            idx = routed.nonzero().squeeze(1)
            tally(routed_diff, tile_check.bit_mismatch(
                L[idx], bc._chol_tile_loop(A.contiguous()[idx])))

    # the recording step waits on the device and must see every call: the
    # solve runs op by op, not from CUDA graphs
    graphed = sqp._solve_mpc_condip
    bc.chol_inv_tile_into = into
    sqp._solve_mpc_condip = sqp._solve_mpc_condip_eager
    try:
        parity = step_parity_torch.run(args.carries, args.device)
    finally:
        bc.chol_inv_tile_into = kernel_into
        sqp._solve_mpc_condip = graphed
    got = {k: torch.cat(v).cpu().numpy() for k, v in rec.items()}
    fin = got["finite_in"]
    pd = got["pd"] & fin          # LAPACK passes a NaN pivot as PD
    out = {"device": parity["device"], "dtype": parity["dtype"],
           "tiles": int(len(pd)), "launches": parity["launches"],
           "input_not_finite": int((~fin).sum()),
           "f64_not_pd": int((~got["pd"] & fin).sum()),
           "routed_to_elimination": int(got["routed"].sum()),
           "routed_kernel_vs_elimination": routed_diff,
           "not_finite_tiles": {k: int(got["nf_" + k].sum())
                                for k in outputs},
           "not_finite_tiles_finite_input": {
               k: int((got["nf_" + k] & fin).sum()) for k in outputs},
           "kernel_X_vs_tri_inv_cols": cols_diff}
    for k in errors:
        e = got[k][pd]
        out[k] = {f"p{p}": float(np.nanpercentile(e, p)) if len(e) else None
                  for p in PCTS}
        out[k]["not_finite"] = int((~np.isfinite(e)).sum())
    n_K, n_R, n_N = (out["not_finite_tiles_finite_input"][k]
                     for k in ("X_kernel", "X_rows", "X_neumann"))
    k99, r99 = out["X_kernel"]["p99"], out["X_rows"]["p99"]
    ratio = None if k99 is None else k99 / max(r99, 1e-30)
    out["inverse_from_kernel_L"] = {
        "n_K": n_K, "n_R": n_R, "n_N": n_N,
        "n_K_minus_n_R": n_K - n_R, "allowed": max(20, 0.1 * n_R),
        "X_p99_kernel_over_rows": ratio,
        "excluded": bool(abs(n_K - n_R) <= max(20, 0.1 * n_R)
                         and ratio is not None and ratio <= 2.0)}
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
