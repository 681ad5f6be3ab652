"""Operations and bytes the benchmark counts from shapes.

* :func:`solve_flops` — the float32 operations one scenario's condensed
  SQP solve needs (``ops/sqp`` with ``condense.build(structured=True)`` and
  ``ops/pdip``), counted as the least work of its linear algebra in
  block-structured form, whatever implements it: the products of
  condensing over the nonzero blocks of the sensitivity matrix, and per
  interior-point iteration the Newton matrix from the dense rows and the
  per-stage blocks, ONE Cholesky factorization and the triangular solves
  with it (never an explicit inverse), the refinement residuals and the
  constraint products.  Symmetric results count their lower triangle.
  Elementwise work (linearization, rollouts, the line search's merits,
  the interior-point updates) is left out, so the count is a lower bound of
  the work and a share of the peak computed from it cannot pass 100%.
* :func:`tile_bound_s` — the least time of the fused tile kernel
  (Cholesky and triangular inverse of 64 x 64 float32 tiles): the larger of
  its bytes over the memory rate and its operations over the float32 rate.

Each term is a function of its own, so that ``PERF.md`` and the tests can
list and check them one by one.
"""

from __future__ import annotations

from portbench.peaks import H100

NX, NU = 20, 32                     # states and inputs per node


def _rows(N: int, soft: bool):
    """Widths (nonzero input columns) of the dense inequality rows of the
    condensed QP, in their order: [lyapunov(N), momentum(1), height(N),
    left box(3N), right box(3N)] = G, then C = [soft G rows | hard G rows |
    box | -box | slack rows]; and the number of slack columns."""
    lyap = [NU * (i + 1) for i in range(N)]          # x_i, x_{i+1}, u_i
    mom = [NU]                                       # node 1
    height = [NU * i for i in range(N)]              # node i
    box = [NU * (k + 1) for k in range(N) for _ in range(3)]   # node k+1
    G = lyap + mom + height + box + box
    ns = N + 1 if soft else 0
    n_box = 6 * N
    n_hard = len(G) - ns - n_box
    soft_rows = [w + 1 for w in G[:ns]]              # + its slack
    hard = G[ns:ns + n_hard]
    bx = G[ns + n_hard:]
    C = soft_rows + hard + bx + bx + [1] * ns
    return C, ns


def condense_flops(N: int, soft: bool) -> dict:
    """Operations of one ``condense.build`` (structured), by term."""
    E = N * (N - 1) // 2 * 2 * NX * NX * NU          # A_i E_i, i blocks each
    pairs = sum(k * (k + 1) // 2 for k in range(1, N + 1))
    blocks = N * (N + 1) // 2                        # nonzero blocks of E
    hess = pairs * 2 * NU * NX * NU + blocks * NX * NU
    grad = blocks * 2 * NX * NU + N * 2 * NU * NU
    # lambda-weighted Lyapunov/momentum curvature: per stage and axis a
    # rank-4 update of width 32 (i + 1), then the momentum row's 3 x 32
    soft_h = sum(3 * (4 * w * (w + 1) + 32 * w)
                 for w in (NU * (i + 1) for i in range(N))) \
        + 3 * NU * (NU + 1)
    rows = sum(2 * 2 * NX * NU * (i + 1) + NU for i in range(N)) \
        + 2 * 3 * NU
    return {"sensitivity": E, "hessian": hess, "gradient": grad,
            "soft_curvature": soft_h, "dense_rows": rows}


def ipm_iteration_flops(N: int, soft: bool, refine: int) -> dict:
    """Operations of one interior-point iteration of ``pdip_solve`` on the
    condensed QP, by term."""
    C, ns = _rows(N, soft)
    n = NU * N + ns
    blk_rows, blk_w = 40, 24                         # per stage
    cmv = 2 * (sum(C) + N * blk_rows * blk_w)        # C v or C' w
    newton = (sum(w * (w + 1) + w for w in C)        # C' D C, lower
              + N * blk_rows * (blk_w * (blk_w + 1) + blk_w)
              + n * (n + 1) // 2)                    # + H
    chol = n ** 3 / 3.0
    solves = 2 * (1 + refine) * 2 * n * n            # 2 systems, L and L'
    residual = 2 * refine * 2 * n * n                # M dv per refinement
    products = 3 * cmv + 3 * cmv + 2 * n * n         # Cv, C'w, Hv
    return {"newton_matrix": newton, "cholesky": chol,
            "triangular_solves": solves, "refinement": residual,
            "constraint_products": products}


def solve_terms(walk: dict) -> dict:
    """Every term of one scenario's solve, each summed over the solve."""
    N, soft = walk["N"], walk["condip_soft"]
    its, ipm = walk["sqp_iters"], walk["pdip_iters"]
    C, ns = _rows(N, soft)
    n = NU * N + ns
    out = {f"condense.{k}": its * v
           for k, v in condense_flops(N, soft).items()}
    out.update({f"ipm.{k}": its * ipm * v for k, v in ipm_iteration_flops(
        N, soft, walk["pdip_refine"]).items()})
    out["ipm.final_residuals"] = its * (2 * 2 * (sum(C) + N * 40 * 24)
                                        + 2 * n * n)
    return out


def solve_flops(walk: dict) -> float:
    """The float32 operations of one scenario's solve (a lower bound)."""
    return float(sum(solve_terms(walk).values()))


def tile_bound_s(tiles: int, nb: int = 64, n_out: int = 2,
                 itemsize: int = 4) -> tuple:
    """(seconds, "bytes" | "operations"): the least time of the fused tile
    kernel on `tiles` tiles.  Bytes: the symmetric input's lower triangle,
    nb (nb + 1) / 2 elements, read once, and each of the n_out outputs
    written whole once.  Operations: nb^3 / 3 for the factor and as many
    again for the inverse of the triangle."""
    elems = nb * (nb + 1) // 2 + n_out * nb * nb
    t_bytes = tiles * elems * itemsize / H100["bytes_per_s"]
    t_ops = tiles * n_out * nb ** 3 / 3.0 / H100["f32_flop_per_s"]
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")
