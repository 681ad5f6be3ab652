"""Tile families and a bit-for-bit comparison for the tile factor.

The tile kernels' f32 factor is the JAX package's ``_chol_tile`` (and the
plain ``_chol_tile_loop``) bit for bit: one elimination, each update one
rounding, IEEE divisions and square roots.  :func:`tile_families` gives the
tiles that hold them to it, the ones the closed loop meets near the pivot
clamp included, and :func:`bit_mismatch` says where two factors part.
``chip_smoke.py`` phase 3, tools/tile_accuracy_torch.py, the card tests
and the CPU tests against the JAX package all use them; no path of the
port does.
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

