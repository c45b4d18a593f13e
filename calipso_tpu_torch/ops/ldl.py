"""Dense unpivoted LDL^T of symmetric quasidefinite systems, with the
inertia read off the signs of D, batch-first: the counterpart of
`calipso_tpu/ops/ldl.py` (the ldl KKT backend, the reference's QDLDL
analogue).

K (B, n, n) is factored by n rank-1 updates of the whole matrix, as the
reference does, so a breakdown (a zero or non-finite pivot) spreads inf
or NaN the same way and the inertia read classes it as a zero
eigenvalue, which sends the inertia ladder up. Every threshold is per
lane.
"""

from __future__ import annotations

import torch


def ldl_factor(K):
    """Unpivoted LDL^T of a symmetric batch K (B, n, n). Returns (L, d):
    unit-lower L (B, n, n) and the diagonal d (B, n) of D."""
    B, n = K.shape[0], K.shape[-1]
    if n == 0:
        return K.new_zeros((B, 0, 0)), K.new_zeros((B, 0))
    rows = torch.arange(n, device=K.device)
    zero = torch.zeros((), dtype=K.dtype, device=K.device)
    A = K
    for k in range(n):
        dk = A[:, k, k]
        lower = rows > k
        l = torch.where(lower, A[:, :, k] / dk[:, None], zero)
        A = A - dk[:, None, None] * (l[:, :, None] * l[:, None, :])
        A[:, :, k] = torch.where(lower, l, A[:, :, k])  # A is this loop's own tensor
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    L = torch.tril(A, -1) + torch.eye(n, dtype=K.dtype, device=K.device)
    return L, d


def ldl_solve(L, d, b):
    """Solve (L D L^T) x = b per lane; b (B, n) or (B, n, k)."""
    if L.shape[-1] == 0:
        return b
    vec = b.dim() == 2
    if vec:
        b = b[..., None]
    y = torch.linalg.solve_triangular(L, b, upper=False, unitriangular=True)
    y = y / d[..., None]
    x = torch.linalg.solve_triangular(L.mT, y, upper=True, unitriangular=True)
    return x[..., 0] if vec else x


def inertia_counts(d):
    """Per lane (num_positive, num_negative, num_zero), each (B,) int32,
    from sign(D). Non-finite pivots and pivots within 10 eps max|d| of
    zero (max over the lane's finite pivots) count as zero eigenvalues:
    exact signs are safe in float64 only; in float32 the rounding noise
    around zero must send the inertia ladder up instead of passing."""
    n = d.shape[-1]
    if n == 0:
        z = torch.zeros(d.shape[:-1], dtype=torch.int32, device=d.device)
        return z, z, z
    finite = torch.isfinite(d)
    eps = torch.finfo(d.dtype).eps
    tol = 10.0 * eps * torch.where(finite, d, torch.zeros_like(d)).abs().amax(dim=-1, keepdim=True)
    pos = (finite & (d > tol)).sum(dim=-1).to(torch.int32)
    neg = (finite & (d < -tol)).sum(dim=-1).to(torch.int32)
    return pos, neg, n - pos - neg
