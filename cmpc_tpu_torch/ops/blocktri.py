"""Block-tridiagonal (stage-structured) linear algebra for the MPC QP,
batched (port of ``cmpc_tpu.ops.blocktri``).

The decision vector z = [vec(X), vec(U)] reordered stage-major,
s_i = (x_i, u_i), makes every matrix the ADMM/PDAS solver needs
block-tridiagonal: each cost/constraint row of the OCP touches at most two
*adjacent* stages (dynamics i: s_i,s_{i+1}; Lyapunov i: theta_i, u_i,
x_{i+1}; momentum: s_0,s_1; force-rate cost: u_i,u_{i+1}; everything else
stage-local).  The dense 540-dim inverse and the dense re-solves of the
active-set rounds become (N+1) Cholesky factors of 52x52 blocks plus
banded sweeps.

The terminal stage (x_N alone, 20-dim) is padded to the uniform 52-dim
stage width with identity diagonal / zero couplings, so every step is one
fixed-shape batched call.  The factorizations and triangular solves are
``torch.linalg`` calls on (B, 52, 52) blocks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cmpc_tpu_torch.consts import const


class StagePerm(NamedTuple):
    """Static permutation data (host-built once per WalkConfig)."""

    perm: np.ndarray      # (n,) stage-major position -> original z index
    n: int                # true variable count
    n_pad: int            # padded count = n_stages * width
    n_stages: int
    width: int


def stage_perm(N: int, n_x: int = 20, n_u: int = 32) -> StagePerm:
    """Stage-major ordering [x_0, u_0, x_1, u_1, ..., x_N] of
    z = [vec(X), vec(U)]."""
    nX = n_x * (N + 1)
    order = []
    for i in range(N):
        order.extend(range(n_x * i, n_x * (i + 1)))          # x_i
        order.extend(range(nX + n_u * i, nX + n_u * (i + 1)))  # u_i
    order.extend(range(n_x * N, n_x * (N + 1)))              # x_N
    perm = np.asarray(order, dtype=np.int32)
    width = n_x + n_u
    return StagePerm(perm=perm, n=nX + n_u * N,
                     n_pad=(N + 1) * width, n_stages=N + 1, width=width)


def _perm_t(sp: StagePerm, device):
    return const(("stage_perm", sp.perm.tobytes()),
                 lambda: sp.perm.astype(np.int64), device)


def build_blocks(P, A, rho_diag, sigma, sp: StagePerm):
    """Stage blocks of M = P + sigma I + A' diag(rho) A in stage-major
    order.  Returns (D (B, S, w, w), O (B, S-1, w, w)).

    P: (B, n, n) cost Hessian; A: (B, m, n) constraint matrix; rho_diag
    (B, m); all in the ORIGINAL ordering (columns are gathered via the
    permutation).
    """
    S, w, n = sp.n_stages, sp.width, sp.n
    pad = sp.n_pad - n
    B, m = A.shape[0], A.shape[1]
    perm = _perm_t(sp, A.device)

    Ap = torch.cat([A[:, :, perm], A.new_zeros(B, m, pad)], dim=2)
    Pp = torch.nn.functional.pad(P[:, perm][:, :, perm], (0, pad, 0, pad))

    Ast = Ap.reshape(B, m, S, w)
    Arho = Ast * rho_diag[:, :, None, None]
    # D_i = P_ii + sigma I + A_i' rho A_i
    D = torch.einsum("bmsi,bmsj->bsij", Arho, Ast)
    Pblk = Pp.reshape(B, S, w, S, w)
    eye = torch.eye(w, dtype=P.dtype, device=P.device)
    D = D + torch.diagonal(Pblk, dim1=1, dim2=3).permute(0, 3, 1, 2) \
        + sigma * eye
    # identity on padded (dummy) variables so the factorization is SPD
    if pad:
        dummy = P.new_zeros(sp.n_pad)
        dummy[n:] = 1.0
        D = D + torch.diag_embed(dummy.reshape(S, w))
    # O_i = P_{i,i+1} + A_i' rho A_{i+1}
    O = torch.einsum("bmsi,bmsj->bsij", Arho[:, :, :-1], Ast[:, :, 1:])
    O = O + torch.diagonal(Pblk, offset=1, dim1=1, dim2=3).permute(0, 3, 1, 2)
    return D, O


def _cho_factor(M):
    """Lower Cholesky factor; NaN-filled where M is not PD (as LAPACK-backed
    cho_factor reports a failed factorization)."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info != 0)[:, None, None],
                       torch.full_like(L, float("nan")), L)


class BlockFactor(NamedTuple):
    C: torch.Tensor    # (B, S, w, w) lower-triangular Cholesky factors
    B: torch.Tensor    # (B, S-1, w, w) subdiagonal of the block factor


def factor(D, O) -> BlockFactor:
    """Block Cholesky of the SPD block-tridiagonal matrix:
    M = L L' with L block-bidiagonal (C_i on the diagonal, B_i below).
    Sequential over the S = N+1 stages.  A scenario whose matrix is not
    positive definite gets NaN factors from that stage on (no error is
    raised, and no other scenario is touched)."""
    S = D.shape[1]
    Cs = [_cho_factor(D[:, 0])]
    Bs = []
    for i in range(1, S):
        # B_{i-1} = O_{i-1}' C_{i-1}^{-T}
        Bi = torch.linalg.solve_triangular(
            Cs[i - 1], O[:, i - 1], upper=False).transpose(1, 2)
        Si = D[:, i] - Bi @ Bi.transpose(1, 2)
        Cs.append(_cho_factor(Si))
        Bs.append(Bi)
    C = torch.stack(Cs, dim=1)
    return BlockFactor(C=C, B=(torch.stack(Bs, dim=1) if Bs
                               else C.new_zeros(C.shape[0], 0,
                                                *C.shape[2:])))


def solve(fac: BlockFactor, b, sp: StagePerm):
    """Solve M x = b given the block factor. b: (B, n) original ordering."""
    S, w, n = sp.n_stages, sp.width, sp.n
    nb = b.shape[0]
    perm = _perm_t(sp, b.device)
    bp = torch.cat([b[:, perm], b.new_zeros(nb, sp.n_pad - n)], dim=1)
    bs = bp.reshape(nb, S, w, 1)

    def lower(i, rhs):
        return torch.linalg.solve_triangular(fac.C[:, i], rhs, upper=False)

    def lower_t(i, rhs):
        return torch.linalg.solve_triangular(
            fac.C[:, i].transpose(1, 2), rhs, upper=True)

    ys = [lower(0, bs[:, 0])]
    for i in range(1, S):
        ys.append(lower(i, bs[:, i] - fac.B[:, i - 1] @ ys[i - 1]))

    xs = [None] * S
    xs[S - 1] = lower_t(S - 1, ys[S - 1])
    for i in range(S - 2, -1, -1):
        xs[i] = lower_t(i, ys[i] - fac.B[:, i].transpose(1, 2) @ xs[i + 1])

    xp = torch.stack(xs, dim=1).reshape(nb, -1)[:, :n]
    out = torch.empty_like(b)
    out[:, perm] = xp
    return out
