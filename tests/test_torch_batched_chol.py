"""The port's batched SPD factorization/inversion (cmpc_tpu_torch.ops.
batched_chol) against the JAX package's, and the tile kernel's plain
version against the Pallas kernel it replaces.

CPU tensors take the plain torch version of the tile kernel; the
hand-written CUDA kernel is tested on the card by test_torch_cuda.py."""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmpc_tpu.ops import batched_chol as jbc
from cmpc_tpu_torch.ops import batched_chol as tbc

# tile families and the bitwise comparison (tools/tile_check.py)
_spec = importlib.util.spec_from_file_location(
    "tile_check", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "tile_check.py"))
tile_check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tile_check)

# the suite runs several worker processes per host: one intra-op thread
# each (more only oversubscribes the cores and slows every worker)
torch.set_num_threads(1)


@pytest.fixture()
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _spd(rng, B, n, scale=0.1, shift=10.0, dtype=np.float64):
    A = rng.normal(size=(B, n, n)) * scale
    return (A @ np.swapaxes(A, 1, 2) + shift * np.eye(n)).astype(dtype)


@pytest.mark.parametrize("n,nb,B", [(320, 32, 3), (320, 64, 2), (64, 32, 2)])
def test_blocked_cholesky_matches_jax(n, nb, B, x64):
    M = _spd(np.random.default_rng(0), B, n)
    Lj, Dj = jbc.blocked_cholesky(jnp.asarray(M), nb)
    Lt, Dt = tbc.blocked_cholesky(torch.tensor(M), nb)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(Lt.numpy(), np.linalg.cholesky(M), rtol=0,
                               atol=1e-12)


def test_tri_inv_blocksub_matches_jax(x64):
    M = _spd(np.random.default_rng(3), 2, 320)
    Lj, Dj = jbc.blocked_cholesky(jnp.asarray(M), 64)
    Xj = jbc.tri_inv_blocksub(Lj, Dj)
    Lt, Dt = tbc.blocked_cholesky(torch.tensor(M), 64)
    Xt = tbc.tri_inv_blocksub(Lt, Dt)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("n,nb", [(320, 64), (320, 32), (64, 32)])
def test_tri_inv_blocked_matches_jax_and_blocksub(n, nb, x64):
    """The Neumann inverse (K = 5, 10 and 2 blocks: squarings with and
    without the inner products) against JAX's at 1e-12, and against the
    block substitution it is the oracle of at 1e-10."""
    M = _spd(np.random.default_rng(4), 2, n)
    Lj, Dj = jbc.blocked_cholesky(jnp.asarray(M), nb)
    Xj = np.asarray(jbc.tri_inv_blocked(Lj, Dj))
    Lt, Dt = tbc.blocked_cholesky(torch.tensor(M), nb)
    Xt = tbc.tri_inv_blocked(Lt, Dt)
    np.testing.assert_allclose(Xt.numpy(), Xj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Xt.numpy(), tbc.tri_inv_blocksub(Lt, Dt)
                               .numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Xt.numpy() @ Lt.numpy(),
                               np.broadcast_to(np.eye(n), (2, n, n)),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("n,nb", [(320, 64), (96, 32)])
def test_spd_inverse_matches_jax(n, nb, x64):
    M = _spd(np.random.default_rng(1), 2, n, shift=5.0)
    inv_j = np.asarray(jbc.spd_inverse(jnp.asarray(M), nb))
    inv_t = tbc.spd_inverse(torch.tensor(M), nb).numpy()
    np.testing.assert_allclose(inv_t, inv_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(inv_t, np.linalg.inv(M), rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(75, 75), (2, 3, 75, 75), (1, 331, 331)])
def test_spd_inverse_any_pads_and_batches(shape, x64):
    *lead, n, _ = shape
    M = _spd(np.random.default_rng(2), int(np.prod(lead or [1])), n,
             shift=5.0).reshape(shape)
    nb = 32 if n == 75 else 64
    inv_j = np.asarray(jbc.spd_inverse_any(jnp.asarray(M), nb=nb))
    inv_t = tbc.spd_inverse_any(torch.tensor(M), nb=nb)
    assert tuple(inv_t.shape) == shape
    np.testing.assert_allclose(inv_t.numpy(), inv_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tbc.spd_inverse64(torch.tensor(M)).numpy(),
                               np.linalg.inv(M), rtol=0, atol=1e-12)


def test_f32_ill_conditioned():
    """The interior-point endgame's ~1e6 complementarity spread
    (test_batched_chol.py::test_f32_ill_conditioned): rel < 1e-4."""
    rng = np.random.default_rng(3)
    n = 320
    A = rng.normal(size=(2, n, n)).astype(np.float32) * 0.1
    d = (10.0 ** rng.uniform(-1, 5, size=(2, n))).astype(np.float32)
    M = A @ np.swapaxes(A, 1, 2) + np.einsum(
        "bi,ij->bij", d, np.eye(n, dtype=np.float32))
    Minv = tbc.spd_inverse(torch.tensor(M), nb=64)
    assert Minv.dtype == torch.float32
    ref = np.linalg.inv(M.astype(np.float64))
    rel = np.abs(Minv.numpy().astype(np.float64) - ref).max() \
        / np.abs(ref).max()
    assert rel < 1e-4, rel


def test_tile_functions_match_jax(x64):
    """chol_tile_ref (both its LAPACK fast path and the elimination loop) and
    _tri_inv_tile against the JAX scan/Neumann versions, including a
    semidefinite tile whose zero pivot hits the 1e-30 clamp."""
    rng = np.random.default_rng(5)
    M = _spd(rng, 3, 64, scale=0.3, shift=5.0)
    M[2, 7, :] = 0.0
    M[2, :, 7] = 0.0                   # pivot 7 is exactly zero
    Lj = np.asarray(jbc._chol_tile(jnp.asarray(M)))
    Xj = np.asarray(jbc._tri_inv_tile(jnp.asarray(Lj)))
    assert Lj[2, 7, 7] == pytest.approx(1e-15)
    Lt = tbc.chol_tile_ref(torch.tensor(M))
    np.testing.assert_allclose(Lt.numpy(), Lj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tbc._chol_tile_loop(torch.tensor(M)).numpy(),
                               Lj, rtol=0, atol=1e-12)
    Xt = tbc._tri_inv_tile(torch.tensor(Lj[:2])).numpy()
    np.testing.assert_allclose(Xt, Xj[:2], rtol=0, atol=1e-12)


def test_chol_inv_tile_ref_matches_pallas_kernel_interpret():
    """The plain version of the ported kernel against the Pallas kernel it
    replaces (_chol_inv_tile_pallas, interpret mode) at the production tile
    layout: B=128 tiles of 64x64, f32, rtol=atol=2e-5 on L and L^-1."""
    rng = np.random.default_rng(7)
    M = _spd(rng, 128, 64, scale=0.3, shift=5.0, dtype=np.float32)
    Lp, Xp = jbc._chol_inv_tile_pallas(jnp.asarray(M), interpret=True)
    Lt, Xt = tbc.chol_inv_tile_ref(torch.tensor(M))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lp), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xp), rtol=2e-5,
                               atol=2e-5)
    assert np.all(np.triu(np.asarray(Lp), 1) == 0)
    assert np.all(np.triu(Xt.numpy(), 1) == 0)


def test_chol_tile_ref_matches_pallas_kernel_interpret():
    """The plain version of the factor-only kernel against the Pallas
    kernel it replaces (_chol_tile_pallas, interpret mode) on the inputs of
    test_batched_chol.py::test_pallas_tile_chol_parity_interpret: B=128
    tiles of 64x64, f32, rtol=atol=2e-5."""
    rng = np.random.default_rng(7)
    B, nb = 128, 64
    A = rng.normal(size=(B, nb, nb)).astype(np.float32) * 0.3
    M = A @ np.swapaxes(A, 1, 2) + 5.0 * np.eye(nb, dtype=np.float32)
    Lp = np.asarray(jbc._chol_tile_pallas(jnp.asarray(M), interpret=True))
    Lt = tbc.chol_tile_ref(torch.tensor(M))
    assert Lt.dtype == torch.float32
    np.testing.assert_allclose(Lt.numpy(), Lp, rtol=2e-5, atol=2e-5)
    assert np.all(np.triu(Lt.numpy(), 1) == 0)
    # the fused kernel's plain version returns this very factor
    assert torch.equal(tbc.chol_inv_tile_ref(torch.tensor(M))[0], Lt)


def test_chol_tile_ref_matches_jax_f64(x64):
    """Against the JAX scan factor in f64 (1e-12), and tile by tile: a
    tile that is not positive definite takes the elimination loop without
    changing its neighbours' factors by a bit."""
    M = _spd(np.random.default_rng(11), 4, 64, scale=0.3, shift=5.0)
    good = tbc.chol_tile_ref(torch.tensor(M))
    np.testing.assert_allclose(
        good.numpy(), np.asarray(jbc._chol_tile(jnp.asarray(M))), rtol=0,
        atol=1e-12)
    M[1] = -M[1]                       # every pivot of tile 1 hits the clamp
    mixed = tbc.chol_tile_ref(torch.tensor(M))
    np.testing.assert_allclose(
        mixed.numpy(), np.asarray(jbc._chol_tile(jnp.asarray(M))), rtol=0,
        atol=1e-12)
    for k in (0, 2, 3):
        assert torch.equal(mixed[k], good[k])
    M[2, 5, 5] = np.nan                # NaN is passed on, within its tile
    nan = tbc.chol_tile_ref(torch.tensor(M))
    assert torch.isnan(nan[2]).any() and torch.isfinite(nan[[0, 3]]).all()
    assert torch.equal(nan[0], good[0]) and torch.equal(nan[3], good[3])


@pytest.mark.parametrize("family", tile_check.FAMILIES)
def test_f32_tile_step_is_jax_bit_for_bit(family):
    """In f32 the plain elimination is the JAX package's _chol_tile bit for
    bit (np.array_equal, NaN matching NaN; the double-rounding allowance of
    1 ulp on 1 element per 10^4 tiles is not used) on each tile family:
    well- and ill-conditioned (κ ~ 1e8), rank-deficient (pivots hit the
    1e-30 clamp), a negative pivot, a NaN.  chol_tile_ref gives that factor
    to every tile it sends to the elimination, which are all the tiles of
    the last three families; and a tile's factor in a batch mixed with the
    other families is its factor alone."""
    fams = tile_check.tile_families(np.random.default_rng(13), 8)
    M = fams[family].astype(np.float32)
    Lj = np.asarray(jbc._chol_tile(jnp.asarray(M)))
    A = torch.tensor(M)
    L = tbc._chol_tile_loop(A)
    assert np.array_equal(L.numpy(), Lj, equal_nan=True), \
        tile_check.bit_mismatch(L, torch.tensor(Lj))
    Lc, info = torch.linalg.cholesky_ex(A)
    routed = (info != 0) | ~(torch.diagonal(Lc, dim1=-2, dim2=-1)
                             > 1e-15).all(-1)
    if family in ("clamp", "negative", "nan"):
        assert bool(routed.all())
    ref = tbc.chol_tile_ref(A)
    assert np.array_equal(ref[routed].numpy(), Lj[routed.numpy()],
                          equal_nan=True)
    mixed = torch.tensor(np.concatenate(
        [fams[f][:3] for f in tile_check.FAMILIES]).astype(np.float32))
    k = tile_check.FAMILIES.index(family)
    for fn in (tbc._chol_tile_loop, tbc.chol_tile_ref):
        Lm = fn(mixed)[3 * k:3 * k + 3]
        for t in range(3):
            assert tile_check.bit_mismatch(
                Lm[t], fn(A[t:t + 1])[0])["n_diff"] == 0


def test_bit_mismatch_finds_the_first_step():
    """tile_check.bit_mismatch counts differing elements (NaN against a
    number counts, NaN against NaN does not), their distance in ulps and
    the first (tile, step, row) in the elimination's order."""
    a = torch.zeros(3, 4, 4)
    a[1, 2, 0] = np.nan
    b = a.clone()
    assert tile_check.bit_mismatch(a, b) == {
        "n_diff": 0, "nan_pattern": True, "max_ulp": 0, "first": None}
    assert not torch.equal(a, b)
    b[2, 3, 1] = float(np.nextafter(np.float32(0), np.float32(1)) * 3)
    b[0, 3, 2] = 1.0
    a[0, 3, 2] = float(np.nextafter(np.float32(1), np.float32(2)))
    got = tile_check.bit_mismatch(a, b)
    assert got["n_diff"] == 2 and got["nan_pattern"]
    assert got["max_ulp"] == 3 and got["first"] == (2, 1, 3)
    b[1, 2, 0] = 0.0
    got = tile_check.bit_mismatch(a, b)
    assert got["n_diff"] == 3 and not got["nan_pattern"]
    assert got["max_ulp"] == float("inf") and got["first"] == (1, 0, 2)


def test_wrapper_dispatch_cpu_and_refusal():
    """CPU tensors take the plain version (no launch is counted); a device
    with no kernel raises instead of falling back."""
    M = torch.tensor(_spd(np.random.default_rng(8), 2, 64, dtype=np.float32))
    n0 = tbc.LAUNCHES["chol_inv_tile"]
    L, X = tbc.chol_inv_tile(M)
    Lr, Xr = tbc.chol_inv_tile_ref(M)
    assert torch.equal(L, Lr) and torch.equal(X, Xr)
    assert tbc.LAUNCHES["chol_inv_tile"] == n0
    with pytest.raises(RuntimeError, match="no kernel"):
        tbc.chol_inv_tile(torch.empty(2, 64, 64, device="meta"))


def test_chol_tile_wrapper_dispatch_cpu_and_refusal():
    """The factor-only wrapper: CPU tensors take chol_tile_ref and count no
    launch; a device with no kernel raises instead of falling back."""
    assert set(tbc.LAUNCHES) == {"chol_inv_tile", "chol_tile", "chol_solve",
                                 "newton_matrix"}
    M = torch.tensor(_spd(np.random.default_rng(8), 2, 64, dtype=np.float32))
    n0 = dict(tbc.LAUNCHES)
    assert torch.equal(tbc.chol_tile(M), tbc.chol_tile_ref(M))
    assert tbc.LAUNCHES == n0
    with pytest.raises(RuntimeError, match="no kernel"):
        tbc.chol_tile(torch.empty(2, 64, 64, device="meta"))



def _blocked_cholesky_by_copies(M, nb):
    """The blocked factorization written with the plain tile function and
    slice copies only (contiguous block in, results assigned): what the
    CPU path of blocked_cholesky must go on computing."""
    B, n, _ = M.shape
    K = n // nb
    L = torch.zeros_like(M)
    Dinv = M.new_zeros(B, K, nb, nb)
    for k in range(K):
        r0 = k * nb
        Lrow = L[:, r0:r0 + nb, :r0]
        Akk = M[:, r0:r0 + nb, r0:r0 + nb]
        if k:
            Akk = Akk - Lrow @ Lrow.transpose(-1, -2)
        Lkk, Dk = tbc.chol_inv_tile_ref(Akk.contiguous())
        L[:, r0:r0 + nb, r0:r0 + nb] = Lkk
        Dinv[:, k] = Dk
        if k + 1 < K:
            Ak = M[:, r0 + nb:, r0:r0 + nb]
            if k:
                Ak = Ak - L[:, r0 + nb:, :r0] @ Lrow.transpose(-1, -2)
            L[:, r0 + nb:, r0:r0 + nb] = Ak @ Dk.transpose(-1, -2)
    return L, Dinv


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [320, 331])
def test_blocked_cholesky_in_place_equals_copying_path(n, dtype):
    """blocked_cholesky hands the tile step views of M, L and Dinv; on the
    CPU that must give the very numbers of the copying formulation, bit for
    bit ((320, 64), and 331 padded to 384 as spd_inverse64 pads it)."""
    M = _spd(np.random.default_rng(21), 2, n, shift=5.0, dtype=dtype)
    npad = (-n) % 64
    Mp = np.zeros((2, n + npad, n + npad), dtype)
    Mp[:, :n, :n] = M
    Mp[:, n:, n:] = np.eye(npad, dtype=dtype)
    L, Dinv = tbc.blocked_cholesky(torch.tensor(Mp), 64)
    Lr, Dr = _blocked_cholesky_by_copies(torch.tensor(Mp), 64)
    assert torch.equal(L, Lr) and torch.equal(Dinv, Dr)
    assert np.all(np.triu(L.numpy(), 1) == 0)
    inv = tbc.spd_inverse64(torch.tensor(M))
    Xr = tbc.tri_inv_blocksub(Lr, Dr)
    assert torch.equal(inv, (Xr.transpose(-1, -2) @ Xr)[:, :n, :n])


@pytest.mark.parametrize("n", [320, 331])
def test_spd_inverse64_matches_jax(n, x64):
    """The interior-point Newton inverse against the JAX package's, f64 at
    1e-12: the (320, 64) production shape and the padded 331 case."""
    M = _spd(np.random.default_rng(22), 2, n, shift=5.0)
    inv_j = np.asarray(jbc.spd_inverse64(jnp.asarray(M)))
    Lj, Dj = jbc.blocked_cholesky(jnp.asarray(M[:, :320, :320]), 64)
    inv_t = tbc.spd_inverse64(torch.tensor(M)).numpy()
    Lt, Dt = tbc.blocked_cholesky(torch.tensor(M[:, :320, :320]), 64)
    np.testing.assert_allclose(inv_t, inv_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(inv_t, np.linalg.inv(M), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=0,
                               atol=1e-12)


def test_tile_into_forms_write_views_in_place():
    """chol_inv_tile_into / chol_tile_into on the CPU: a diagonal block of a
    larger matrix in, the results written whole into views of buffers that
    were not zero — the block and nothing outside it — equal to the plain
    versions, and no launch counted."""
    M = torch.tensor(_spd(np.random.default_rng(23), 3, 320, shift=5.0))
    blk = M[:, 128:192, 128:192]
    Lr, Xr = tbc.chol_inv_tile_ref(blk.contiguous())
    n0 = dict(tbc.LAUNCHES)
    Lbig = torch.full_like(M, 3.0)
    Dinv = torch.full((3, 5, 64, 64), 3.0, dtype=M.dtype)
    tbc.chol_inv_tile_into(blk, Lbig[:, 128:192, 128:192], Dinv[:, 2])
    assert torch.equal(Lbig[:, 128:192, 128:192], Lr)
    assert torch.equal(Dinv[:, 2], Xr)
    assert torch.triu(Lbig[:, 128:192, 128:192], 1).abs().max() == 0
    assert torch.triu(Dinv[:, 2], 1).abs().max() == 0
    L2 = torch.full_like(M, 3.0)
    tbc.chol_tile_into(blk, L2[:, 128:192, 128:192])
    assert torch.equal(L2, Lbig)
    Lbig[:, 128:192, 128:192] = 3.0
    assert (Lbig == 3.0).all() and (Dinv[:, [0, 1, 3, 4]] == 3.0).all()
    assert tbc.LAUNCHES == n0
    with pytest.raises(RuntimeError, match="no kernel"):
        tbc.chol_inv_tile_into(*(torch.empty(2, 64, 64, device="meta")
                                 for _ in range(3)))
    with pytest.raises(RuntimeError, match="no kernel"):
        tbc.chol_tile_into(*(torch.empty(2, 64, 64, device="meta")
                             for _ in range(2)))


def test_kernel_argument_checks():
    """What the CUDA launcher refuses before it launches (the checks read
    shapes, types and strides only, so they run on CPU tensors): wrong tile
    shape, wrong type, rows that are not contiguous or not 16-byte aligned,
    outputs that do not match the input or overlap themselves."""
    M = torch.zeros(4, 320, 320)
    blk = M[:, 64:128, 64:128]
    tbc._check_tiles("chol_inv_tile", blk)               # the path's view
    tbc._check_tiles("chol_inv_tile", blk, like=torch.zeros(4, 64, 64))
    tbc._check_tiles("chol_inv_tile", torch.zeros(4, 5, 64, 64)[:, 3],
                     like=blk)
    with pytest.raises(ValueError, match="tiles"):
        tbc._check_tiles("chol_inv_tile", M[:, :32, :32])
    with pytest.raises(TypeError):
        tbc._check_tiles("chol_inv_tile", blk.half())
    with pytest.raises(ValueError, match="contiguous"):
        tbc._check_tiles("chol_inv_tile", blk.transpose(1, 2))
    with pytest.raises(ValueError, match="aligned"):     # rows of 321
        tbc._check_tiles("chol_inv_tile",
                         torch.zeros(4, 321, 321)[:, :64, :64])
    with pytest.raises(ValueError, match="aligned"):     # starts at col 2
        tbc._check_tiles("chol_inv_tile", M[:, 64:128, 2:66])
    with pytest.raises(ValueError, match="aligned"):     # f64: 16 B = 2
        tbc._check_tiles("chol_inv_tile",
                         torch.zeros(4, 320, 320,
                                     dtype=torch.float64)[:, :64, 1:65])
    with pytest.raises(ValueError, match="match"):
        tbc._check_tiles("chol_inv_tile", torch.zeros(3, 64, 64), like=blk)
    with pytest.raises(ValueError, match="match"):
        tbc._check_tiles("chol_inv_tile",
                         torch.zeros(4, 64, 64, dtype=torch.float64),
                         like=blk)
    with pytest.raises(ValueError, match="overlap"):
        tbc._check_tiles("chol_inv_tile",
                         torch.zeros(64, 64).expand(4, 64, 64), like=blk)


# ------------------------------------------------- the block substitution

def _factored(rng, B, n, dtype=np.float64):
    """(M, L, Dinv, b): SPD M (B, n, n) and its blocked factor at block size
    64, L and Dinv written in place by blocked_cholesky."""
    M = torch.tensor(_spd(rng, B, n, dtype=dtype))
    L, Dinv = tbc.blocked_cholesky(M, 64)
    b = torch.tensor(rng.normal(size=(B, n)).astype(dtype))
    return M, L, Dinv, b


@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("n", [128, 192, 320])
def test_chol_solve_ref_matches_dense_solves(n, B):
    """The plain version of the substitution kernel against
    torch.linalg.solve(M, b) and spd_inverse64(M) @ b, f64.  M = A A' / 100
    + 10 I has its eigenvalues in [10, 10 + 0.04 n], a condition number
    under 2.3 at these sizes, so any backward-stable solve of it agrees with
    another to a few ulps of |x| (~0.3, an ulp 5.6e-17): 1e-13 absolute
    leaves room for rounding and none for a wrong block."""
    M, L, Dinv, b = _factored(np.random.default_rng(40 + n + B), B, n)
    x = tbc.chol_solve_ref(L, Dinv, b)
    assert x.shape == (B, n) and x.dtype == torch.float64
    torch.testing.assert_close(x, torch.linalg.solve(M, b), rtol=0,
                               atol=1e-13)
    torch.testing.assert_close(
        x, (tbc.spd_inverse64(M) @ b[..., None])[..., 0], rtol=0, atol=1e-13)
    assert torch.equal(tbc.chol_solve(L, Dinv, b), x)     # the CPU route


@pytest.mark.parametrize("n", [331, 320])
def test_spd_factor_and_solve64_pad_as_the_inverse_does(n):
    """spd_factor64 / spd_solve64 at the production n and at 331 (padded to
    384 with an identity tail, b with zeros): M^-1 b as spd_inverse64's
    product gives it, f64, 1e-13 (the bound above)."""
    rng = np.random.default_rng(44)
    M = torch.tensor(_spd(rng, 3, n))
    b = torch.tensor(rng.normal(size=(3, n)))
    L, Dinv = tbc.spd_factor64(M)
    assert L.shape == (3, 384 if n == 331 else 320, L.shape[1])
    x = tbc.spd_solve64(L, Dinv, b)
    assert x.shape == (3, n)
    torch.testing.assert_close(
        x, (tbc.spd_inverse64(M) @ b[..., None])[..., 0], rtol=0, atol=1e-13)


@pytest.mark.parametrize("where", ["dinv", "below_diagonal", "last_row"])
def test_chol_solve_nan_tile_poisons_its_scenario_only(where):
    """A NaN in one tile the sweeps read (a tile inverse, a block of L below
    the diagonal, a block of L's last block row) makes that scenario's x
    wholly non-finite, as the explicit inverse's product does, so the
    interior point's guard freezes the same scenarios; the other scenarios'
    x are unchanged bit for bit."""
    M, L, Dinv, b = _factored(np.random.default_rng(45), 4, 320)
    clean = tbc.chol_solve_ref(L, Dinv, b)
    if where == "dinv":
        Dinv[1, 2, 10, 5] = np.nan
    elif where == "below_diagonal":
        L[1, 140, 70] = np.nan
    else:
        L[1, 300, 3] = np.nan
    x = tbc.chol_solve(L, Dinv, b)
    assert not torch.isfinite(x[1]).any()
    assert torch.equal(x[[0, 2, 3]], clean[[0, 2, 3]])
    Minv = L.new_zeros(4, 320, 320)
    Minv[1] = np.nan                   # what the explicit route gives there
    assert not torch.isfinite((Minv @ b[..., None])[1]).any()


def test_chol_solve_dispatch_cpu_and_refusal():
    """CPU tensors take the plain version and count no launch; a device
    with no kernel raises instead of falling back."""
    M, L, Dinv, b = _factored(np.random.default_rng(46), 2, 128, np.float32)
    n0 = dict(tbc.LAUNCHES)
    assert torch.equal(tbc.chol_solve(L, Dinv, b),
                       tbc.chol_solve_ref(L, Dinv, b))
    assert tbc.LAUNCHES == n0
    meta = [t.to("meta") for t in (L, Dinv, b)]
    with pytest.raises(RuntimeError, match="no kernel"):
        tbc.chol_solve(*meta)


def test_chol_solve_argument_checks():
    """What the substitution kernel's launcher refuses before it launches
    (shapes, types and strides only, so the checks run on CPU tensors):
    L that is not (B, n, n) with n a multiple of 64 up to 4096, Dinv or b
    that do not match it, mixed or unsupported types, rows that are not
    contiguous, strides or pointers that are not 16-byte aligned.  Views
    as the route and the card tests hand them are taken."""
    L = torch.zeros(3, 320, 320)
    D = torch.zeros(3, 5, 64, 64)
    b = torch.zeros(3, 320)
    tbc._check_solve(L, D, b)
    tbc._check_solve(torch.zeros(3, 320, 328)[:, :, :320],
                     torch.zeros(3, 6, 64, 68)[:, :5, :, :64],
                     torch.zeros(3, 330)[:, :320])
    with pytest.raises(ValueError, match="multiple"):
        tbc._check_solve(L[:, :300, :300], D, b[:, :300])
    with pytest.raises(ValueError, match="multiple"):
        tbc._check_solve(torch.zeros(1, 4160, 4160),
                         torch.zeros(1, 65, 64, 64), torch.zeros(1, 4160))
    with pytest.raises(ValueError, match="match"):
        tbc._check_solve(L, D[:, :4], b)
    with pytest.raises(ValueError, match="match"):
        tbc._check_solve(L, D, b[:2])
    with pytest.raises(TypeError):
        tbc._check_solve(L.half(), D.half(), b.half())
    with pytest.raises(TypeError, match="match"):
        tbc._check_solve(L, D.double(), b)
    with pytest.raises(ValueError, match="contiguous"):
        tbc._check_solve(L.transpose(1, 2), D, b)
    with pytest.raises(ValueError, match="contiguous"):
        tbc._check_solve(L, D.transpose(2, 3), b)
    with pytest.raises(ValueError, match="contiguous"):
        tbc._check_solve(L, D, torch.zeros(3, 640)[:, ::2])
    with pytest.raises(ValueError, match="aligned"):     # rows of 322
        tbc._check_solve(torch.zeros(3, 320, 322)[:, :, :320], D, b)
    with pytest.raises(ValueError, match="aligned"):     # starts at col 1
        tbc._check_solve(torch.zeros(3, 320, 324)[:, :, 1:321], D, b)
    with pytest.raises(ValueError, match="aligned"):     # f64: 16 B = 2
        tbc._check_solve(L.double(), torch.zeros(
            3, 5, 64, 65, dtype=torch.float64)[..., :64], b.double())
