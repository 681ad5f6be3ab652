"""The tile inverse's three algorithms held to each other on the CPU.

The TPU kernel the CUDA kernel replaces (``_chol_inv_tile_pallas``)
inverts its factor by row-wise forward substitution; the CUDA kernel
substitutes column by column with fused updates; the JAX package's CPU
branch and the port's plain version take the Neumann product.
``tools/tile_check.py`` holds plain versions of both substitutions:
``tri_inv_rows`` is held here to the Pallas kernel in interpret mode, on
its own factor, and ``tri_inv_cols`` to ``tri_inv_rows``.  The CUDA
kernel is held to ``tri_inv_cols`` bit for bit on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3)."""

import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmpc_tpu.ops import batched_chol as jbc

_spec = importlib.util.spec_from_file_location(
    "tile_check", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "tile_check.py"))
tile_check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tile_check)

torch.set_num_threads(1)

B = 128                          # the Pallas kernel's lane width
KINDS = tile_check.FAMILIES + ("random",)
# finite elements of the row form against the Pallas kernel, relative to
# the tile's largest finite |X|: well-conditioned tiles, and the tiles that
# meet the clamp, a negative pivot or a NaN
TOL = {"well": 2e-6, "ill": 2e-6, "random": 2e-6, "clamp": 2e-4,
       "negative": 2e-4, "nan": 2e-4}


def _tiles(kind):
    """B f32 tiles of one family of tile_check.tile_families, or random
    well-conditioned SPD tiles, as numpy float32."""
    if kind == "random":
        rng = np.random.default_rng(21)
        A = rng.normal(size=(B, 64, 64)) * 0.3
        M = A @ np.swapaxes(A, 1, 2) + 5.0 * np.eye(64)
    else:
        M = tile_check.tile_families(np.random.default_rng(5), B)[kind]
    return M.astype(np.float32)


def _not_finite_tiles(X):
    return (~torch.isfinite(X)).flatten(1).any(1)


def _rel_err(X, ref):
    """Per tile, the largest difference over the elements finite in both,
    over the largest finite |ref|."""
    both = torch.isfinite(X) & torch.isfinite(ref)
    zero = torch.zeros_like(ref)
    scale = torch.where(torch.isfinite(ref), ref.abs(), zero).amax((1, 2))
    diff = torch.where(both, (X - ref).abs(), zero).amax((1, 2))
    return diff / scale.clamp_min(1e-30)


@pytest.fixture(scope="module")
def pallas():
    """(L, X) of the Pallas kernel in interpret mode, per kind."""
    out = {}
    for kind in KINDS:
        L, X = jbc._chol_inv_tile_pallas(jnp.asarray(_tiles(kind)),
                                         interpret=True)
        out[kind] = (torch.tensor(np.asarray(L)), torch.tensor(np.asarray(X)))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_rows_is_the_pallas_kernels_inverse(kind, pallas):
    """tri_inv_rows on the Pallas kernel's own L gives its X: the same
    tiles are not finite, NaNs lie in the same places, and the finite
    elements agree within TOL of the tile's largest |X|."""
    L, Xp = pallas[kind]
    X = tile_check.tri_inv_rows(L)
    assert X.dtype == torch.float32
    assert torch.equal(_not_finite_tiles(X), _not_finite_tiles(Xp))
    assert torch.equal(torch.isnan(X), torch.isnan(Xp))
    assert torch.equal(torch.isinf(X), torch.isinf(Xp))
    err = _rel_err(X, Xp)
    assert float(err.max()) <= TOL[kind], float(err.max())
    if kind in ("well", "ill", "random"):
        assert not bool(_not_finite_tiles(X).any())
    if kind in ("negative", "nan"):
        assert bool(_not_finite_tiles(X).any())


@pytest.mark.parametrize("kind", KINDS)
def test_cols_gives_the_rows_non_finite_tiles(kind, pallas):
    """tri_inv_cols, the CUDA kernel's substitution, makes the same tiles
    non-finite as tri_inv_rows on the same L, keeps zeros above the
    diagonal, and agrees with it on the finite elements within TOL."""
    L = pallas[kind][0]
    Xc = tile_check.tri_inv_cols(L)
    Xr = tile_check.tri_inv_rows(L)
    assert torch.equal(_not_finite_tiles(Xc), _not_finite_tiles(Xr))
    assert bool((torch.triu(Xc, 1) == 0).all())
    assert float(_rel_err(Xc, Xr).max()) <= TOL[kind]


def test_cols_f64_is_the_inverse():
    """In float64 tri_inv_cols is L^-1 to 1e-12 on well-conditioned tiles,
    and so is tri_inv_rows."""
    M = tile_check.tile_families(np.random.default_rng(9), 16)["well"]
    L = np.linalg.cholesky(M)
    ref = np.linalg.inv(L)
    for fn in (tile_check.tri_inv_cols, tile_check.tri_inv_rows):
        X = fn(torch.tensor(L))
        assert X.dtype == torch.float64
        np.testing.assert_allclose(X.numpy(), ref, rtol=0, atol=1e-12)


def test_cols_spreads_nan_as_the_kernel_does():
    """A NaN pivot d_k makes every stored element of rows k.. of X NaN, in
    the columns right of k too (the kernel updates them with x_k =
    0 / NaN, which it does not store), keeps zeros above the diagonal, and
    leaves rows 0..k-1 as they were."""
    M = tile_check.tile_families(np.random.default_rng(3), 4)["well"]
    clean = torch.tensor(np.linalg.cholesky(M).astype(np.float32))
    L = clean.clone()
    k = 20
    L[:, k, k] = float("nan")
    X = tile_check.tri_inv_cols(L)
    assert torch.equal(X[:, :k], tile_check.tri_inv_cols(clean)[:, :k])
    lower = torch.ones(64, 64, dtype=torch.bool).tril()
    assert bool(torch.isnan(X[:, k:])[:, lower[k:]].all())
    assert bool((X[:, k:][:, ~lower[k:]] == 0).all())
    assert torch.equal(_not_finite_tiles(X),
                       _not_finite_tiles(tile_check.tri_inv_rows(L)))
