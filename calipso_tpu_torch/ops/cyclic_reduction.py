"""Parallel-in-time block cyclic reduction for SPD block-tridiagonal
systems, batch-first: the counterpart of
`calipso_tpu/ops/cyclic_reduction.py` (the cr KKT backend).

Every level eliminates the odd block rows of the surviving stage list at
once,

    O_{2k} x_{2k} + D_{2k+1} x_{2k+1} + O_{2k+1}^T x_{2k+2} = b_{2k+1},

which leaves a half-size block-tridiagonal system over the even stages:

    D'_{2k} = D_{2k} - O_{2k}^T D_{2k+1}^{-1} O_{2k}
                     - O_{2k-1} D_{2k-1}^{-1} O_{2k-1}^T
    O'_k    = -O_{2k+1} D_{2k+1}^{-1} O_{2k}        (couples 2k -> 2k+2)
    b'_{2k} = b_{2k} - O_{2k}^T D_{2k+1}^{-1} b_{2k+1}
                     - O_{2k-1} D_{2k-1}^{-1} b_{2k-1}

ceil(log2 T) levels, each a batched Cholesky, triangular solves and
matrix products over every lane and every odd stage at once. The level
shapes depend on T only, so the loop over levels is plain Python. The
reference computes these with XLA's linear algebra, outside any Pallas
kernel, so the port's are `torch.linalg` calls too.

Blocks as in `ops/riccati.py`: D (B, T, d, d) diagonal, O (B, T-1, d, d)
with O_t the block at (row t+1, col t). Every reduced system is a Schur
complement of an SPD matrix, so a matrix that is not positive definite
shows as NaN in some level's Cholesky factor (written over the failed
block's lower triangle, where `torch.linalg.cholesky_ex` would leave a
partial factor): the inertia signal, read per lane by `factors_finite`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _cholesky(A):
    """Lower Cholesky factors of a batch of blocks (..., d, d); NaN over
    the lower triangle of every block that is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info > 0) | ~torch.isfinite(L).flatten(-2).all(dim=-1)
    lower = torch.ones(A.shape[-2:], dtype=torch.bool, device=A.device).tril()
    nan = torch.full((), float("nan"), dtype=A.dtype, device=A.device)
    return torch.where(bad[..., None, None] & lower, nan, L)


def _chosolve(L, B):
    """A^{-1} B from the lower Cholesky factor L of A, over any leading
    axes."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _pad_stages(X, before, after):
    """X (B, k, ...) padded with zero blocks on the stage axis."""
    return F.pad(X, (0, 0) * (X.dim() - 2) + (before, after))


def num_levels(T: int) -> int:
    n, m = 0, T
    while m > 1:
        m = (m + 1) // 2
        n += 1
    return n


def factor(D, O):
    """Cyclic-reduction factorization of D (B, T, d, d), O (B, T-1, d, d).

    Returns (levels, L_final): `levels` holds per level (L_odd, OL, OR),
    L_odd (B, co, d, d) the Cholesky factors of the odd diagonal blocks,
    OL = O[:, 0::2] (B, co, d, d) the couplings odd -> even-left and OR =
    O[:, 1::2] (B, ce-1, d, d) odd -> even-right at that level; L_final
    (B, d, d) is the factor of the last remaining block."""
    levels = []
    m = D.shape[1]
    while m > 1:
        co = m // 2  # odd stages
        cr = (m - 1) // 2  # new couplings
        ce = (m + 1) // 2  # even stages
        Lodd = _cholesky(D[:, 1::2])
        OL, OR = O[:, 0::2], O[:, 1::2]
        X1 = _chosolve(Lodd, OL)  # D_odd^{-1} O_{2k}
        Dn = D[:, 0::2] - _pad_stages(OL.mT @ X1, 0, ce - co)
        if cr > 0:
            X2 = _chosolve(Lodd[:, :cr], OR.mT)  # D_odd^{-1} O_{2k+1}^T
            Dn = Dn - _pad_stages(OR @ X2, 1, 0)
            On = -(OR @ X1[:, :cr])
        else:
            On = D.new_zeros((D.shape[0], 0) + D.shape[2:])
        Dn = 0.5 * (Dn + Dn.mT)
        levels.append((Lodd, OL, OR))
        D, O, m = Dn, On, ce
    return tuple(levels), _cholesky(D[:, 0])


def solve_multi(fact, Bm):
    """Solve S X = Bm for K right-hand sides per lane, Bm (B, T, d, K)."""
    levels, L_final = fact
    b, saved = Bm, []
    for Lodd, OL, OR in levels:
        co, cr, ce = Lodd.shape[1], OR.shape[1], (b.shape[1] + 1) // 2
        b_odd = b[:, 1::2]
        u = _chosolve(Lodd, b_odd)  # D_odd^{-1} b_odd
        b_even = b[:, 0::2] - _pad_stages(OL.mT @ u, 0, ce - co)
        if cr > 0:
            b_even = b_even - _pad_stages(OR @ u[:, :cr], 1, 0)
        saved.append(b_odd)
        b = b_even
    x = _chosolve(L_final, b[:, 0])[:, None]  # (B, 1, d, K)
    for (Lodd, OL, OR), b_odd in zip(reversed(levels), reversed(saved)):
        co, cr = Lodd.shape[1], OR.shape[1]
        rhs = b_odd - OL @ x[:, :co]
        if cr > 0:
            rhs = rhs - _pad_stages(OR.mT @ x[:, 1 : cr + 1], 0, co - cr)
        x_odd = _chosolve(Lodd, rhs)
        out = x.new_empty((x.shape[0], co + x.shape[1]) + x.shape[2:])
        out[:, 0::2] = x
        out[:, 1::2] = x_odd
        x = out
    return x


def solve(fact, b):
    """Solve S x = b per lane given `fact` from `factor`; b (B, T, d)."""
    return solve_multi(fact, b[..., None])[..., 0]


def factors_finite(fact):
    """(B,) bool: every Cholesky factor of the lane finite <=> its S was
    SPD (the cyclic-reduction inertia signal)."""
    levels, L_final = fact
    ok = torch.isfinite(L_final).flatten(1).all(dim=1)
    for Lodd, _, _ in levels:
        ok = ok & torch.isfinite(Lodd).flatten(1).all(dim=1)
    return ok
