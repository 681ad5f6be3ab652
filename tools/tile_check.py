"""Tile families, the two substitutions, and a bit-for-bit comparison for
the tile step.

The tile kernels' f32 factor is the JAX package's ``_chol_tile`` (and the
plain ``_chol_tile_loop``) bit for bit: one elimination, each update one
rounding, IEEE divisions and square roots.  The inverse X = L^-1 has three
algorithms: the TPU kernel (``_chol_inv_tile_pallas``) substitutes row by
row, :func:`tri_inv_rows`; the CUDA kernel substitutes column by column
with fused updates, :func:`tri_inv_cols`; the JAX package's CPU branch and
the port's plain version take the Neumann product (``_tri_inv_tile``).
:func:`tile_families` gives the tiles that hold them to each other, the
ones the closed loop meets near the pivot clamp included, and
:func:`bit_mismatch` says where two results part.  ``chip_smoke.py``
phase 3, tools/tile_accuracy_torch.py, the card tests and the CPU tests
against the JAX package all use them; no path of the port does.
"""

from __future__ import annotations

import numpy as np
import torch

FAMILIES = ("well", "ill", "clamp", "negative", "nan")


def tile_families(rng: np.random.Generator, count: int = 8,
                  nb: int = 64) -> dict:
    """`count` symmetric (nb, nb) tiles of each family, float64 numpy
    arrays holding float32 values (so a cast to either type is exact):

    * ``well``: A Aᵀ·0.09 + 5 I, condition ~10;
    * ``ill``: Q diag(λ) Qᵀ with λ from 1 down to 1e-8 (κ ~ 1e8);
    * ``clamp``: rank-deficient: rows and columns of zeros (an exact zero
      pivot) and a repeated row and column (a pivot that is zero up to
      rounding), so pivots hit the 1e-30 clamp;
    * ``negative``: a well-conditioned tile with one negative pivot;
    * ``nan``: a well-conditioned tile with one NaN below the diagonal
      (and its mirror)."""
    def well(k):
        A = rng.normal(size=(k, nb, nb)) * 0.3
        return A @ np.swapaxes(A, 1, 2) + 5.0 * np.eye(nb)

    Q, _ = np.linalg.qr(rng.normal(size=(count, nb, nb)))
    lam = 10.0 ** -np.linspace(0.0, 8.0, nb)
    ill = (Q * lam[None, None, :]) @ np.swapaxes(Q, 1, 2)

    clamp = well(count)
    for t in range(count):
        zero = rng.choice(nb, size=1 + t % 3, replace=False)
        clamp[t, zero, :] = 0.0
        clamp[t, :, zero] = 0.0
        src, dst = rng.choice(np.setdiff1d(np.arange(nb), zero), 2,
                              replace=False)
        clamp[t, dst, :] = clamp[t, src, :]
        clamp[t, :, dst] = clamp[t, :, src]

    negative = well(count)
    for t in range(count):
        j = int(rng.integers(nb))
        negative[t, j, j] = -negative[t, j, j]

    nan = well(count)
    for t in range(count):
        i, j = sorted(rng.choice(nb, size=2, replace=False))
        nan[t, j, i] = nan[t, i, j] = np.nan

    out = {"well": well(count), "ill": ill, "clamp": clamp,
           "negative": negative, "nan": nan}
    return {k: v.astype(np.float32).astype(np.float64) for k, v in
            out.items()}


def tri_inv_rows(L: torch.Tensor) -> torch.Tensor:
    """X = L^-1 of (B, nb, nb) tiles as the TPU kernel computes it: row i
    of X is (e_i - acc) / L[i, i] with acc = sum over ALL k of
    where(k != i, L[i, k], 0) * X[k, :], X starting from zeros and filled
    row by row.

    Products and sums round in the tile's type (never wider: the partial
    sums' overflow is what makes a tile's X non-finite), each row's sum in
    order of k.  The TPU's own reduction order is not known, so this order
    is a deterministic stand-in, to be compared by finiteness and error,
    not by bits.  The rows k > i of X are still zero when row i is formed,
    so their products are zeros, or NaN where L[i, k] is not finite (the
    Pallas factor leaves 0/d_j = NaN above a NaN pivot): they are added
    after the others, which changes no value, and spread NaN as the kernel
    does.  L is read whole, upper triangle included."""
    B, nb, _ = L.shape
    X = torch.zeros_like(L)
    acc = torch.zeros_like(L)            # row i: sum over k < i so far
    eye = torch.eye(nb, dtype=L.dtype, device=L.device)
    for i in range(nb):
        upper = (L[:, i, i + 1:, None] * X[:, i + 1:, :]).sum(1)
        X[:, i, :] = (eye[i] - (acc[:, i, :] + upper)) / L[:, i, i, None]
        acc[:, i + 1:, :] = acc[:, i + 1:, :] \
            + L[:, i + 1:, i, None] * X[:, i, None, :]
    return X


def tri_inv_cols(L: torch.Tensor) -> torch.Tensor:
    """X = L^-1 of (B, nb, nb) lower-triangular tiles as the CUDA kernel
    (``csrc/chol_tile_common.cuh``, ``inverse_steps16``) computes it, bit
    for bit: column c starts from v = e_c; at step k, x_k = v_k / d_k is
    stored for c <= k (zero above), and v_t = fma(-L[t, k], x_k, v_t) for
    every t > k, in order of k.  The x_k of a column c > k is not stored
    but still updates v, so a NaN pivot or a non-finite L[t, k] spreads to
    the columns right of it as in the kernel.

    Each update is formed in float64 and cast once (the product of two f32
    values is exact there), as ``_chol_tile_loop`` forms its own; it parts
    from the card's ``fmaf`` only where that double rounding lands on a
    tie.  The division is taken in float64 and cast, which is the
    correctly rounded f32 quotient.  The kernel's ``div_by_pivot`` gives
    the IEEE result for a zero numerator (a zero, or NaN for a NaN pivot),
    so plain division matches it.  float64 tiles take plain float64
    arithmetic.  Only the lower triangle of L is read."""
    B, nb, _ = L.shape
    wide = torch.float64
    Lw = L.to(wide)
    d = torch.diagonal(Lw, dim1=-2, dim2=-1)
    v = torch.eye(nb, dtype=L.dtype, device=L.device).expand(B, nb, nb) \
        .clone()                         # v[:, t, c]: row t of column c
    X = torch.zeros_like(L)
    upper = torch.ones(nb, nb, dtype=torch.bool, device=L.device).triu()
    for k in range(nb):
        xk = (v[:, k, :].to(wide) / d[:, k, None]).to(L.dtype)
        X[:, k, :] = torch.where(upper[:, k], xk, torch.zeros_like(xk))
        v[:, k + 1:, :] = (v[:, k + 1:, :].to(wide)
                           - Lw[:, k + 1:, k, None] * xk[:, None, :].to(wide)
                           ).to(L.dtype)
    return X


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """The bits of f32/f64 values as integers in the values' order, so that
    the difference of two is their distance in ulps."""
    itype = torch.int32 if x.dtype == torch.float32 else torch.int64
    i = x.contiguous().view(itype).to(torch.int64)
    top = torch.iinfo(itype).min
    return torch.where(i < 0, top - i, i)


def bit_mismatch(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Where the (T, nb, nb) factors `a` and `b` (same shape and type) part:
    ``n_diff`` elements that differ (a NaN against a number counts, two NaNs
    do not), ``nan_pattern`` whether the NaNs lie in the same places,
    ``max_ulp`` the largest distance in ulps between two finite elements
    (inf where an infinity or NaN meets a finite value), and ``first`` the
    first differing (tile, step j, row i), in the order of the elimination:
    the lowest column j, then the lowest row, then the lowest tile."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"shapes or types differ: {tuple(a.shape)} "
                         f"{a.dtype}, {tuple(b.shape)} {b.dtype}")
    na, nb_ = torch.isnan(a), torch.isnan(b)
    diff = (na != nb_) | (~na & ~nb_ & (a != b))
    n = int(diff.sum())
    out = {"n_diff": n, "nan_pattern": bool(torch.equal(na, nb_)),
           "max_ulp": 0, "first": None}
    if n == 0:
        return out
    both = ~na & ~nb_ & torch.isfinite(a) & torch.isfinite(b)
    ulp = (_ordered(a) - _ordered(b)).abs()
    fin = diff & both
    out["max_ulp"] = int(ulp[fin].max()) if bool((fin == diff).all()) \
        else float("inf")
    t, i, j = diff.nonzero().unbind(1)
    first = torch.argmin((j * a.shape[1] + i) * a.shape[0] + t)
    out["first"] = (int(t[first]), int(j[first]), int(i[first]))
    return out

