"""Batched dense SPD factorization/inversion (port of
``cmpc_tpu.ops.batched_chol``).

* :func:`blocked_cholesky` — left-looking block factorization; only the
  nb x nb diagonal tiles are factored sequentially, by
  :func:`chol_inv_tile`, which returns each tile's factor AND its inverse.
* :func:`tri_inv_blocksub` — inverse of the blocked factor by block forward
  substitution, reusing the tile inverses.
* :func:`spd_inverse` — M^-1 = L^-T L^-1.

:func:`chol_inv_tile` is the one kernel of the solver path: on a CUDA
tensor it launches the hand-written Hopper kernel
``csrc/chol_inv_tile.cu`` (the port of the Pallas kernel
``_chol_inv_tile_pallas``); on a CPU tensor it runs the plain torch
version :func:`chol_inv_tile_ref` (``chol_tile_ref`` + ``_tri_inv_tile``).
:func:`chol_tile` is its factor-only form, ``csrc/chol_tile.cu`` (the port
of ``_chol_tile_pallas``) with the plain version :func:`chol_tile_ref`;
like ``_chol_tile_dispatch`` in the JAX package it has no caller on any
path.  Matrix products are plain ``torch.matmul``; the callers pin
full-f32 matmuls (TF32 off).
"""

from __future__ import annotations

import ctypes

import torch

TILE = 64                      # the kernel's tile size

# launches of each CUDA kernel, counted where its wrapper launches it
LAUNCHES = {"chol_inv_tile": 0, "chol_tile": 0}


def _chol_tile_loop(A):
    """Cholesky of (B, nb, nb) tiles by nb steps of column elimination with
    pivot sqrt(max(a_jj, 1e-30)) — the JAX package's _chol_tile step for
    step (and the kernel's algorithm)."""
    B, nb, _ = A.shape
    A = A.clone()
    L = torch.zeros_like(A)
    for j in range(nb):
        d = A[:, j, j].clamp_min(1e-30).sqrt()
        below = A[:, j + 1:, j] / d[:, None]
        L[:, j, j] = d
        L[:, j + 1:, j] = below
        # the rank-1 update only changes the trailing block (below is zero
        # on rows <= j in the JAX formulation)
        A[:, j + 1:, j + 1:] -= below[:, :, None] * below[:, None, :]
    return L


def chol_tile_ref(A):
    """Plain torch version of the factor-only tile kernel: Cholesky of
    (B, nb, nb) SPD tiles with the elimination's pivot clamp
    sqrt(max(a_jj, 1e-30)).  Where every pivot exceeds the clamp the
    clamped elimination IS the Cholesky factor, so those tiles take
    torch.linalg.cholesky_ex; tiles that hit the clamp (or are not PD) take
    the step-by-step elimination :func:`_chol_tile_loop`.  Which tiles do
    is decided tile by tile, so no tile's factor depends on another's."""
    L, info = torch.linalg.cholesky_ex(A)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    bad = (info != 0) | ~(d > 1e-15).all(dim=-1)
    if bool(bad.any()):
        L = torch.where(bad[:, None, None], _chol_tile_loop(A), L)
    return L


def _tri_inv_tile(L):
    """Exact inverse of (B, nb, nb) lower-triangular tiles via the
    nilpotent Neumann product — log2(nb) squarings of matmuls."""
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
    tiles."""
    L = chol_tile_ref(A)
    return L, _tri_inv_tile(L)


def _launch_tile_kernel(name: str, A, n_out: int):
    """Check A, allocate `n_out` outputs like it and launch the kernel
    ``<name>_f32`` / ``<name>_f64`` of ``csrc/<name>.cu`` on the current
    stream.  Raises on what the kernel does not take and on a refused
    launch."""
    from cmpc_tpu_torch.ops.cuda_build import load_library

    if A.dim() != 3 or A.shape[1:] != (TILE, TILE):
        raise ValueError(f"{name} kernel takes (T, {TILE}, {TILE}) "
                         f"tiles, got {tuple(A.shape)}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} kernel takes f32 or f64, got {A.dtype}")
    if not A.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous tensor")
    lib = load_library(name)
    fn = getattr(lib, f"{name}_f32" if A.dtype == torch.float32
                 else f"{name}_f64")
    fn.argtypes = [ctypes.c_void_p] * (1 + n_out) \
        + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    outs = tuple(torch.empty_like(A) for _ in range(n_out))
    if A.shape[0] == 0:
        return outs                  # nothing to launch
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), *(o.data_ptr() for o in outs), A.shape[0],
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return outs


def chol_inv_tile(A):
    """(L, L^-1) of (T, nb, nb) SPD tiles.  CPU tensors take the plain torch
    version; CUDA tensors launch the kernel (nb == 64, f32/f64,
    contiguous) or raise."""
    if A.device.type == "cpu":
        return chol_inv_tile_ref(A)
    if A.device.type == "cuda":
        return _launch_tile_kernel("chol_inv_tile", A, 2)
    raise RuntimeError(f"chol_inv_tile: no kernel for device {A.device}")


def chol_tile(A):
    """L = chol(A) of (T, nb, nb) SPD tiles, the factor-only form of
    :func:`chol_inv_tile` (counterpart of the JAX package's
    ``_chol_tile_dispatch``).  CPU tensors take :func:`chol_tile_ref`; CUDA
    tensors launch the kernel (nb == 64, f32/f64, contiguous) or raise."""
    if A.device.type == "cpu":
        return chol_tile_ref(A)
    if A.device.type == "cuda":
        return _launch_tile_kernel("chol_tile", A, 1)[0]
    raise RuntimeError(f"chol_tile: no kernel for device {A.device}")


def blocked_cholesky(M, nb: int = 32):
    """Batched lower Cholesky of (B, n, n) SPD matrices, n % nb == 0.

    Returns (L, Dinv) with Dinv (B, K, nb, nb) the inverses of L's diagonal
    blocks."""
    B, n, _ = M.shape
    if n % nb:
        raise ValueError(f"blocked_cholesky: n={n} is not a multiple of "
                         f"nb={nb}")
    K = n // nb
    L = torch.zeros_like(M)
    Dinv = M.new_zeros(B, K, nb, nb)
    for k in range(K):
        r0 = k * nb
        Lrow = L[:, r0:r0 + nb, :r0]
        Akk = M[:, r0:r0 + nb, r0:r0 + nb]
        if k:
            Akk = Akk - Lrow @ Lrow.transpose(-1, -2)
        Lkk, Dk = chol_inv_tile(Akk.contiguous())
        L[:, r0:r0 + nb, r0:r0 + nb] = Lkk
        Dinv[:, k] = Dk
        if k + 1 < K:
            Ak = M[:, r0 + nb:, r0:r0 + nb]
            if k:
                Ak = Ak - L[:, r0 + nb:, :r0] @ Lrow.transpose(-1, -2)
            L[:, r0 + nb:, r0:r0 + nb] = Ak @ Dk.transpose(-1, -2)
    return L, Dinv


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
    Mb = M.reshape(-1, n, n)
    npad = (-n) % nb
    if npad:
        Mp = M.new_zeros(Mb.shape[0], n + npad, n + npad)
        Mp[:, :n, :n] = Mb
        Mp[:, n:, n:] = torch.eye(npad, dtype=M.dtype, device=M.device)
        Mb = Mp
    inv = spd_inverse(Mb, nb)[:, :n, :n]
    return inv.reshape(*lead, n, n)


def spd_inverse64(M):
    """SPD inverse with block size 64 — the interior-point Newton inverse.
    Batch-first code needs no counterpart of the JAX custom_vmap rule."""
    return spd_inverse_any(M, nb=TILE)
