"""Batched dense SPD factorization/inversion (port of
``cmpc_tpu.ops.batched_chol``).

* :func:`blocked_cholesky` — left-looking block factorization; only the
  nb x nb diagonal tiles are factored sequentially, by
  :func:`chol_inv_tile`, which returns each tile's factor AND its inverse.
* :func:`tri_inv_blocksub` — inverse of the blocked factor by block forward
  substitution, reusing the tile inverses.
* :func:`spd_inverse` — M^-1 = L^-T L^-1.

These inverses, with :func:`spd_inverse_any`, :func:`spd_inverse64` and
:func:`tri_inv_blocked`, are the JAX package's Newton step and the tests'
reference for the substitution below; no program path calls them.

:func:`chol_inv_tile` is the solver path's tile kernel: on a CUDA
tensor it launches the hand-written Hopper kernel
``csrc/chol_inv_tile.cu`` (the port of the Pallas kernel
``_chol_inv_tile_pallas``); on a CPU tensor it runs the plain torch
version :func:`chol_inv_tile_ref` (``chol_tile_ref`` + ``_tri_inv_tile``).
:func:`chol_tile` is its factor-only form, ``csrc/chol_tile.cu`` (the port
of ``_chol_tile_pallas``) with the plain version :func:`chol_tile_ref`;
like ``_chol_tile_dispatch`` in the JAX package it has no caller on any
path.  Both kernels share ``csrc/chol_tile_common.cuh`` and take a row and
a tile stride per tensor: :func:`chol_inv_tile_into` / :func:`chol_tile_into`
hand them views, so :func:`blocked_cholesky` factors each diagonal block
where it lies and has L and the tile inverse written into place.

:func:`chol_solve` applies the blocked factor to a right-hand side by
block forward and back substitution: on a CUDA tensor the hand-written
kernel ``csrc/chol_solve.cu`` (it replaces no TPU kernel), on a CPU
tensor its plain version :func:`chol_solve_ref`; the interior point takes
it on every device in place of the explicit inverse.  :func:`spd_factor64`
and :func:`spd_solve64` pad any n as :func:`spd_inverse64` does.  Matrix
products are plain ``torch.matmul``; the callers pin full-f32 matmuls
(TF32 off).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

TILE = 64                      # the kernel's tile size

# launches of each CUDA kernel, counted where its wrapper launches it (the
# Newton matrix's kernel by ``ops/pdip.newton_matrix``)
LAUNCHES = {"chol_inv_tile": 0, "chol_tile": 0, "chol_solve": 0,
            "newton_matrix": 0}


def _chol_tile_loop(A):
    """Cholesky of (B, nb, nb) tiles by nb steps of column elimination with
    pivot sqrt(max(a_jj, 1e-30)): the JAX package's ``_chol_tile`` step for
    step, and the kernel's algorithm.  Reads the lower triangle.

    In f32 each element's rank-1 update a - l_i l_k rounds once, as XLA's
    fused update and the kernel's ``fmaf`` do: the product and the
    difference are formed in f64 (the product of two f32 values is exact
    there) and cast to f32 once.  The pivot's square root is taken in f64
    and cast too, because torch's vectorized f32 square root on the CPU is
    not correctly rounded (XLA's and the kernel's are).  Either differs
    from the correctly rounded f32 result only where the f64 value,
    rounded again, lands on the other side of a tie: about once in 2^28
    operations.  f64 tiles round the product and the difference each,
    since torch has no wider type to fuse them in."""
    B, nb, _ = A.shape
    wide = torch.float64 if A.dtype == torch.float32 else A.dtype
    A = A.clone()
    L = torch.zeros_like(A)
    for j in range(nb):
        d = A[:, j, j].clamp_min(1e-30).to(wide).sqrt().to(A.dtype)
        below = A[:, j + 1:, j] / d[:, None]
        L[:, j, j] = d
        L[:, j + 1:, j] = below
        # the rank-1 update only changes the trailing block (below is zero
        # on rows <= j in the JAX formulation)
        b = below.to(wide)
        A[:, j + 1:, j + 1:] = (A[:, j + 1:, j + 1:].to(wide)
                                - b[:, :, None] * b[:, None, :]).to(A.dtype)
    return L


def chol_tile_ref(A):
    """Plain torch version of the factor-only tile kernel: Cholesky of
    (B, nb, nb) SPD tiles with the elimination's pivot clamp
    sqrt(max(a_jj, 1e-30)).  Where every pivot exceeds the clamp the
    clamped elimination IS the Cholesky factor, so those tiles take
    torch.linalg.cholesky_ex; tiles that hit the clamp (or are not PD), and
    those alone, take the step-by-step elimination :func:`_chol_tile_loop`,
    whose f32 factor is the JAX package's and the kernel's bit for bit.
    Which tiles do is decided tile by tile, so no tile's factor depends on
    another's.  The clean tiles' LAPACK factor is the one place where this
    version's f32 arithmetic still differs from the JAX package's tile
    step, in the last bits: the elimination costs ~50x LAPACK's call on a
    single tile on the CPU, and most tiles are clean."""
    L, info = torch.linalg.cholesky_ex(A)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    bad = (info != 0) | ~(d > 1e-15).all(dim=-1)
    if bool(bad.any()):
        idx = bad.nonzero().squeeze(1)
        L = L.index_copy(0, idx, _chol_tile_loop(A.index_select(0, idx)))
    return L


def _tri_inv_tile(L):
    """Exact inverse of (B, nb, nb) lower-triangular tiles via the
    nilpotent Neumann product — log2(nb) squarings of matmuls.  This is the
    JAX package's ``_tri_inv_tile``, the inverse of its non-TPU branch of
    ``_chol_inv_tile_dispatch``; the TPU kernel (and so the CUDA kernel)
    inverts by forward substitution instead, so the two part in rounding
    and in how far a NaN spreads (plain versions of both substitutions are
    in tools/tile_check.py)."""
    B, nb, _ = L.shape
    eye = torch.eye(nb, dtype=L.dtype, device=L.device)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    dinv = 1.0 / d
    M = L * dinv[:, :, None] - eye          # D^-1 N, strictly lower
    inv = eye - M
    P = M
    k = 1
    while k < nb:
        P = P @ P
        k *= 2
        if k < nb:
            inv = inv @ (eye + P)
    return inv * dinv[:, None, :]


def chol_inv_tile_ref(A):
    """Plain torch version of the tile kernel: (L, L^-1) of (T, nb, nb) SPD
    tiles.  Its X follows the JAX package's CPU branch of
    ``_chol_inv_tile_dispatch`` (the Neumann product, :func:`_tri_inv_tile`),
    and the CPU parity tests hold it there; the card's X is the TPU
    kernel's algorithm, forward substitution, held bit for bit to
    ``tools/tile_check.tri_inv_cols`` of the kernel's L by
    ``chip_smoke.py`` phase 3."""
    L = chol_tile_ref(A)
    return L, _tri_inv_tile(L)


_P, _S, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# each entry point's arguments: the tile kernels take per tensor a pointer,
# a row stride and a tile stride, then the tile count and the stream;
# chol_solve takes L (pointer, row and scenario strides), Dinv (pointer,
# row, block and scenario strides), b and x (pointer, scenario stride),
# then the block count, the batch and the stream; newton_matrix takes H and
# C (pointer, scenario and row strides), the scaling (pointer, scenario
# stride), C_blk (pointer, scenario, stage and row strides), the row order
# and the rows per block row, M (pointer, scenario and row strides), reg,
# then n, m_d, the stage block's three sizes, the batch and the stream
_ARGTYPES = {"chol_inv_tile": [_P, _S, _S] * 3 + [_I, _P],
             "chol_tile": [_P, _S, _S] * 2 + [_I, _P],
             "chol_solve": [_P, _S, _S, _P, _S, _S, _S, _P, _S, _P, _S,
                            _I, _I, _P],
             "newton_matrix": [_P, _S, _S] * 2 + [_P, _S, _P, _S, _S, _S,
                                                  _P, _P, _P, _S, _S,
                                                  ctypes.c_double]
             + [_I] * 6 + [_P]}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str, dtype: torch.dtype):
    """The C entry point ``<name>_f32`` / ``<name>_f64`` of
    ``csrc/<name>.cu``, built on first use and bound once."""
    from cmpc_tpu_torch.ops.cuda_build import load_library

    fn = getattr(load_library(name),
                 f"{name}_f32" if dtype == torch.float32 else f"{name}_f64")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


_VEC = {torch.float32: 4, torch.float64: 2}     # elements per 16 bytes


def _check_tiles(name: str, t, like=None):
    """Raise unless `t` is a (T, 64, 64) f32/f64 tensor the kernel can
    address by a row stride and a tile stride with 16-byte accesses; an
    output (`like` is the input) must also match the input and not overlap
    itself.  Returns the kernel's three arguments for it: pointer, row
    stride, tile stride."""
    shape = t.shape
    if len(shape) != 3 or shape[1] != TILE or shape[2] != TILE:
        raise ValueError(f"{name} kernel takes (T, {TILE}, {TILE}) "
                         f"tiles, got {tuple(shape)}")
    vec = _VEC.get(t.dtype)
    if vec is None:
        raise TypeError(f"{name} kernel takes f32 or f64, got {t.dtype}")
    s_tile, s_row, s_col = t.stride()
    ptr = t.data_ptr()
    if (s_col != 1 or s_row % vec or s_tile % vec or ptr % 16
            or s_row < TILE or s_tile < 0):
        raise ValueError(f"{name} kernel takes tiles with contiguous, "
                         f"16-byte aligned rows, got strides {t.stride()}")
    if like is not None:
        if (shape != like.shape or t.dtype != like.dtype
                or t.device != like.device):
            raise ValueError(f"{name}: output {tuple(shape)} {t.dtype} on "
                             f"{t.device} does not match the input")
        if shape[0] > 1 and s_tile < TILE * s_row:
            raise ValueError(f"{name}: output tiles overlap, strides "
                             f"{t.stride()}")
    return ptr, s_row, s_tile


def _launch_tile_kernel(name: str, A, outs):
    """Launch the kernel `name` on the current stream: tiles A (T, 64, 64)
    into the outputs, each read or written where it lies (any row and tile
    stride).  Raises on what the kernel does not take and on a refused
    launch."""
    args = _check_tiles(name, A)
    for o in outs:
        args += _check_tiles(name, o, like=A)
    tiles = A.shape[0]
    if tiles == 0:
        return                       # nothing to launch
    fn = _kernel_fn(name, A.dtype)
    with torch.cuda.device(A.device):
        err = fn(*args, tiles, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _require_contiguous(name: str, A):
    """The public wrappers allocate outputs like A, so they take it whole
    and contiguous (views go through the ``*_into`` forms)."""
    if not A.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous tensor")


def chol_inv_tile(A):
    """(L, L^-1) of (T, nb, nb) SPD tiles.  CPU tensors take the plain torch
    version; CUDA tensors launch the kernel (nb == 64, f32/f64,
    contiguous) or raise."""
    if A.device.type == "cpu":
        return chol_inv_tile_ref(A)
    if A.device.type == "cuda":
        _require_contiguous("chol_inv_tile", A)
        L, X = torch.empty_like(A), torch.empty_like(A)
        _launch_tile_kernel("chol_inv_tile", A, (L, X))
        return L, X
    raise RuntimeError(f"chol_inv_tile: no kernel for device {A.device}")


def chol_inv_tile_into(A, L, X):
    """:func:`chol_inv_tile` written in place: the tiles A (T, nb, nb) may
    be a view (a diagonal block of a larger matrix), and L and X are views
    that receive the factor and its inverse whole, zeros above the diagonal
    included.  On CUDA the kernel reads and writes all three where they lie
    (no copy); on the CPU the plain version's results are copied in."""
    if A.device.type == "cpu":
        Lk, Xk = chol_inv_tile_ref(A.contiguous())
        L.copy_(Lk)
        X.copy_(Xk)
    elif A.device.type == "cuda":
        _launch_tile_kernel("chol_inv_tile", A, (L, X))
    else:
        raise RuntimeError(f"chol_inv_tile: no kernel for device {A.device}")


def chol_tile(A):
    """L = chol(A) of (T, nb, nb) SPD tiles, the factor-only form of
    :func:`chol_inv_tile` (counterpart of the JAX package's
    ``_chol_tile_dispatch``).  CPU tensors take :func:`chol_tile_ref`; CUDA
    tensors launch the kernel (nb == 64, f32/f64, contiguous) or raise."""
    if A.device.type == "cpu":
        return chol_tile_ref(A)
    if A.device.type == "cuda":
        _require_contiguous("chol_tile", A)
        L = torch.empty_like(A)
        _launch_tile_kernel("chol_tile", A, (L,))
        return L
    raise RuntimeError(f"chol_tile: no kernel for device {A.device}")


def chol_tile_into(A, L):
    """:func:`chol_tile` written in place, as :func:`chol_inv_tile_into`."""
    if A.device.type == "cpu":
        L.copy_(chol_tile_ref(A.contiguous()))
    elif A.device.type == "cuda":
        _launch_tile_kernel("chol_tile", A, (L,))
    else:
        raise RuntimeError(f"chol_tile: no kernel for device {A.device}")


def blocked_cholesky(M, nb: int = 32):
    """Batched lower Cholesky of (B, n, n) SPD matrices, n % nb == 0.

    Returns (L, Dinv) with Dinv (B, K, nb, nb) the inverses of L's diagonal
    blocks.  Each diagonal block is factored and inverted where it lies:
    the tile step reads the block of M (or the updated block) and writes
    straight into L and Dinv."""
    B, n, _ = M.shape
    if n % nb:
        raise ValueError(f"blocked_cholesky: n={n} is not a multiple of "
                         f"nb={nb}")
    K = n // nb
    L = torch.zeros_like(M)
    Dinv = M.new_empty(B, K, nb, nb)     # every block is written whole
    for k in range(K):
        r0 = k * nb
        Lrow = L[:, r0:r0 + nb, :r0]
        Akk = M[:, r0:r0 + nb, r0:r0 + nb]
        if k:
            Akk = Akk - Lrow @ Lrow.transpose(-1, -2)
        Dk = Dinv[:, k]
        chol_inv_tile_into(Akk, L[:, r0:r0 + nb, r0:r0 + nb], Dk)
        if k + 1 < K:
            Ak = M[:, r0 + nb:, r0:r0 + nb]
            if k:
                Ak = Ak - L[:, r0 + nb:, :r0] @ Lrow.transpose(-1, -2)
            L[:, r0 + nb:, r0:r0 + nb] = Ak @ Dk.transpose(-1, -2)
    return L, Dinv


def tri_inv_blocked(L, Dinv):
    """Inverse of the blocked Cholesky factor by the block-level nilpotent
    Neumann product (K blocks: ceil(log2 K) squarings).  The oracle of
    :func:`tri_inv_blocksub`, which does ~20x fewer operations; no path
    calls it."""
    B, n, _ = L.shape
    K = Dinv.shape[1]
    nb = n // K
    Dfull = torch.zeros_like(L)          # block-diagonal D^-1, dense
    for k in range(K):
        r0 = k * nb
        Dfull[:, r0:r0 + nb, r0:r0 + nb] = Dinv[:, k]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    M = Dfull @ L - eye                  # strictly block-lower
    inv = eye - M
    P = M
    k = 1
    while k < K:
        P = P @ P
        k *= 2
        if k < K:
            inv = inv @ (eye + P)
    return inv @ Dfull


def tri_inv_blocksub(L, Dinv):
    """Inverse of the blocked Cholesky factor by block forward substitution
    on L X = I: X[i, :i] = -Dinv_i @ (L[i, :i] @ X[:i, :i])."""
    B, n, _ = L.shape
    K = Dinv.shape[1]
    nb = n // K
    X = torch.zeros_like(L)
    X[:, :nb, :nb] = Dinv[:, 0]
    for i in range(1, K):
        r0 = i * nb
        S = L[:, r0:r0 + nb, :r0] @ X[:, :r0, :r0]
        X[:, r0:r0 + nb, :r0] = -(Dinv[:, i] @ S)
        X[:, r0:r0 + nb, r0:r0 + nb] = Dinv[:, i]
    return X


def spd_inverse(M, nb: int = 32):
    """Batched SPD inverse M^-1 = L^-T L^-1 from the blocked factor."""
    L, Dinv = blocked_cholesky(M, nb)
    Linv = tri_inv_blocksub(L, Dinv)
    return Linv.transpose(-1, -2) @ Linv


def spd_inverse_any(M, nb: int = 64):
    """SPD inverse of (..., n, n) for any n: pads to a block multiple with
    an identity tail (blockdiag(M, I) stays SPD and its inverse restricts
    to M^-1); any number of leading batch dims."""
    *lead, n, _ = M.shape
    inv = spd_inverse(_pad_identity(M.reshape(-1, n, n), nb), nb)
    return inv[:, :n, :n].reshape(*lead, n, n)


def _pad_identity(M, nb: int):
    """(B, n, n) -> blockdiag(M, I) of the next multiple of nb, which stays
    SPD and whose inverse restricts to M^-1; M itself where n is one."""
    B, n, _ = M.shape
    npad = (-n) % nb
    if not npad:
        return M
    Mp = M.new_zeros(B, n + npad, n + npad)
    Mp[:, :n, :n] = M
    Mp[:, n:, n:] = torch.eye(npad, dtype=M.dtype, device=M.device)
    return Mp


def spd_inverse64(M):
    """SPD inverse with block size 64 — the JAX package's interior-point
    Newton inverse.  Batch-first code needs no counterpart of the JAX
    custom_vmap rule."""
    return spd_inverse_any(M, nb=TILE)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _mtv(A, v):
    return (A.transpose(-1, -2) @ v[..., None])[..., 0]


def chol_solve_ref(L, Dinv, b):
    """Plain torch version of the substitution kernel: x = (L L')^-1 b for
    L (B, n, n) and Dinv (B, K, nb, nb) from :func:`blocked_cholesky` and
    b (B, n), by block forward substitution (y_i = Dinv_i (b_i - L_i,<i
    y_<i)) and back substitution (x_i = Dinv_i' (y_i - L_>i,i' x_>i)).  L's
    diagonal blocks are not read: Dinv stands for them."""
    n, K = L.shape[-1], Dinv.shape[1]
    nb = n // K
    y = []
    for i in range(K):
        r = b[:, i * nb:(i + 1) * nb]
        if i:
            r = r - _mv(L[:, i * nb:(i + 1) * nb, :i * nb], torch.cat(y, 1))
        y.append(_mv(Dinv[:, i], r))
    x = [None] * K
    for i in reversed(range(K)):
        r = y[i]
        if i + 1 < K:
            r = r - _mtv(L[:, (i + 1) * nb:, i * nb:(i + 1) * nb],
                         torch.cat(x[i + 1:], 1))
        x[i] = _mtv(Dinv[:, i], r)
    return torch.cat(x, 1)


# the kernel keeps the vector and 17 x 64 partial sums in shared memory,
# (n + 17 * 64) elements: under 48 KB up to n = 4096 in f64
MAX_SOLVE_N = 4096


def _check_solve(L, Dinv, b):
    """Raise unless the substitution kernel can take L (B, n, n), Dinv
    (B, n / 64, 64, 64) and b (B, n): f32 or f64 alike, one device,
    contiguous rows, L's and Dinv's rows 16-byte aligned and each of their
    strides a whole number of 16 bytes.  Returns the kernel's arguments for
    L, Dinv and b."""
    if (L.dim() != 3 or L.shape[1] != L.shape[2] or L.shape[1] % TILE
            or not 0 < L.shape[1] <= MAX_SOLVE_N):
        raise ValueError(f"chol_solve kernel takes L of (B, n, n), n a "
                         f"multiple of {TILE} up to {MAX_SOLVE_N}, got "
                         f"{tuple(L.shape)}")
    B, n = L.shape[0], L.shape[1]
    if (tuple(Dinv.shape) != (B, n // TILE, TILE, TILE)
            or tuple(b.shape) != (B, n)):
        raise ValueError(f"chol_solve: Dinv {tuple(Dinv.shape)} and b "
                         f"{tuple(b.shape)} do not match L {tuple(L.shape)}")
    vec = _VEC.get(L.dtype)
    if vec is None:
        raise TypeError(f"chol_solve kernel takes f32 or f64, got {L.dtype}")
    if Dinv.dtype != L.dtype or b.dtype != L.dtype:
        raise TypeError(f"chol_solve: types {L.dtype}, {Dinv.dtype}, "
                        f"{b.dtype} do not match")
    if not L.device == Dinv.device == b.device:
        raise ValueError(f"chol_solve: devices {L.device}, {Dinv.device}, "
                         f"{b.device} do not match")
    sL, sD = L.stride(), Dinv.stride()
    if sL[2] != 1 or sD[3] != 1 or b.stride(1) != 1:
        raise ValueError(f"chol_solve kernel takes contiguous rows, got "
                         f"strides {sL}, {sD}, {b.stride()}")
    if (any(s % vec for s in (*sL[:2], *sD[:3]))
            or L.data_ptr() % 16 or Dinv.data_ptr() % 16):
        raise ValueError(f"chol_solve kernel takes 16-byte aligned rows, "
                         f"got strides {sL}, {sD}")
    return (L.data_ptr(), sL[1], sL[0], Dinv.data_ptr(), sD[2], sD[1],
            sD[0], b.data_ptr(), b.stride(0))


def chol_solve(L, Dinv, b):
    """x = (L L')^-1 b for (B, n) right-hand sides b, from the blocked
    factor (L, Dinv) of :func:`blocked_cholesky` at block size 64, read
    where it lies (any row and scenario strides).  CPU tensors take
    :func:`chol_solve_ref`; CUDA tensors launch the kernel on the current
    stream or raise."""
    if b.device.type == "cpu":
        return chol_solve_ref(L, Dinv, b)
    if b.device.type != "cuda":
        raise RuntimeError(f"chol_solve: no kernel for device {b.device}")
    args = _check_solve(L, Dinv, b)
    B, n = b.shape
    x = b.new_empty(B, n)
    if B == 0:
        return x
    fn = _kernel_fn("chol_solve", b.dtype)
    with torch.cuda.device(b.device):
        err = fn(*args, x.data_ptr(), x.stride(0), n // TILE, B,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"chol_solve kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["chol_solve"] += 1
    return x


def spd_factor64(M):
    """The blocked factor (L, Dinv) of (B, n, n) SPD matrices at block size
    64, for any n: M padded with an identity tail as :func:`spd_inverse64`
    pads it."""
    return blocked_cholesky(_pad_identity(M, TILE), TILE)


def spd_solve64(L, Dinv, b):
    """M^-1 b for (B, n) right-hand sides from ``spd_factor64(M)``: b padded
    with zeros to L's size (the identity tail's part of x is 0), solved by
    :func:`chol_solve`, cut back to n."""
    n, npad = b.shape[-1], L.shape[-1] - b.shape[-1]
    if npad:
        return chol_solve(L, Dinv, F.pad(b, (0, npad)))[:, :n]
    return chol_solve(L, Dinv, b)
