"""Vectorized cone algebra for K = R+^q x Q_l1 x ... x Q_lj, batch-first.

The counterpart of `calipso_tpu/ops/cones.py`: every cone is a
second-order cone (a nonnegative-orthant entry is a 1-dimensional SOC),
so the whole cone program is one padded (num_cones, max_dim) tensor
computation. Every function takes flat cone vectors of shape (..., m_c)
with any leading axes (the lane axis, and a candidate axis in the
parallel line searches) and reduces over the trailing cone axes only.
Per-lane scalars arrive already shaped to broadcast against those leading
axes.

Padding is algebraically inert: padded slots gather an appended zero,
and the scatter back to flat form reads real slots only.

Key math (per cone, head x1, tail xbar):
  barrier      0.5*log(x1^2 - |xbar|^2)
  product      a o b = [<a,b>; a1*bbar + b1*abar]
  target       e = (1, 0, ..., 0)
  arrow solve  y1 = (u1*x1 - <ubar,xbar>) / (u1^2 - |ubar|^2)
               ybar = (xbar - y1*ubar) / u1
  FTB violation  v = xhat - (1-tau)*x ; violated iff v1 <= |vbar|
"""

from __future__ import annotations

import numpy as np
import torch


class ConeLayout:
    """Static description of the cone Cartesian product as padded index
    tables (same construction and validation as the reference layout).

    Args:
      num_cone: total dimension m_c of the cone variable.
      nonnegative_indices: 0-based flat indices belonging to R+.
      second_order_indices: list of 0-based flat index arrays, one per SOC.
    """

    def __init__(self, num_cone, nonnegative_indices=None, second_order_indices=None):
        if nonnegative_indices is None and second_order_indices is None:
            nonnegative_indices = np.arange(num_cone)
        nn = np.asarray(
            nonnegative_indices if nonnegative_indices is not None else [], dtype=np.int64
        ).reshape(-1)
        socs = [
            np.asarray(idx, dtype=np.int64).reshape(-1)
            for idx in (second_order_indices or [])
            if len(idx) > 0
        ]
        covered = np.concatenate([nn] + socs) if (len(nn) or socs) else np.zeros(0, np.int64)
        if len(covered) != num_cone or (
            len(covered) and not np.array_equal(np.sort(covered), np.arange(num_cone))
        ):
            raise ValueError(
                "nonnegative + second-order indices must partition 0..num_cone-1 "
                f"(got {len(covered)} of {num_cone})"
            )

        self.num_cone = int(num_cone)
        self.num_nonnegative = int(len(nn))
        self.second_order_dims = tuple(int(len(s)) for s in socs)
        self.nonnegative_indices = nn
        self.second_order_indices = socs

        cones = [np.array([i]) for i in nn] + socs
        self.num_cones = len(cones)
        self.max_dim = max((len(c) for c in cones), default=1)

        C, D = max(self.num_cones, 1), self.max_dim
        idx = np.full((C, D), num_cone, dtype=np.int64)  # pad -> sentinel m_c
        for c, members in enumerate(cones):
            idx[c, : len(members)] = members
        self.idx = idx

        inv_c = np.zeros(max(num_cone, 1), dtype=np.int64)
        inv_j = np.zeros(max(num_cone, 1), dtype=np.int64)
        for c, members in enumerate(cones):
            for j, k in enumerate(members):
                inv_c[k], inv_j[k] = c, j
        self.inv_cone = inv_c[:num_cone]
        self.inv_slot = inv_j[:num_cone]

        target = np.zeros(num_cone)
        init = np.zeros(num_cone)
        for members in cones:
            target[members[0]] = 1.0
            init[members[0]] = 1.0
            init[members[1:]] = 0.1
        self.target_np = target
        self.init_np = init
        self._tables = {}

    def _on(self, device):
        """Index tables on `device`, built once per device."""
        key = str(device)
        if key not in self._tables:
            self._tables[key] = tuple(
                torch.as_tensor(a, device=device)
                for a in (self.idx, self.inv_cone, self.inv_slot)
            )
        return self._tables[key]

    def gather(self, x):
        """(..., m_c) flat -> (..., C, D) padded; padded slots read 0."""
        idx, _, _ = self._on(x.device)
        xpad = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
        return xpad[..., idx]

    def scatter(self, vp):
        """(..., C, D) padded -> (..., m_c) flat."""
        _, inv_c, inv_j = self._on(vp.device)
        return vp[..., inv_c, inv_j]

    def target(self, dtype, device):
        return torch.as_tensor(self.target_np, dtype=dtype, device=device)

    def initialize(self, dtype, device):
        return torch.as_tensor(self.init_np, dtype=dtype, device=device)


def product(layout: ConeLayout, a, b):
    """Jordan product a o b = arrow(a) @ b."""
    if layout.num_cone == 0:
        return torch.broadcast_tensors(a, b)[0]
    ap, bp = layout.gather(a), layout.gather(b)
    ap, bp = torch.broadcast_tensors(ap, bp)
    head = (ap * bp).sum(dim=-1, keepdim=True)
    tail = ap[..., :1] * bp[..., 1:] + bp[..., :1] * ap[..., 1:]
    return layout.scatter(torch.cat([head, tail], dim=-1))


def arrow_solve(layout: ConeLayout, u, x):
    """Solve arrow(u) y = x per cone, closed form."""
    if layout.num_cone == 0:
        return torch.broadcast_tensors(x, u)[0]
    up, xp = layout.gather(u), layout.gather(x)
    up, xp = torch.broadcast_tensors(up, xp)
    u1, ubar = up[..., :1], up[..., 1:]
    x1, xbar = xp[..., :1], xp[..., 1:]
    det = u1 * u1 - (ubar * ubar).sum(dim=-1, keepdim=True)
    y1 = (u1 * x1 - (ubar * xbar).sum(dim=-1, keepdim=True)) / det
    ybar = (xbar - y1 * ubar) / u1
    return layout.scatter(torch.cat([y1, ybar], dim=-1))


def barrier(layout: ConeLayout, s):
    """Phi(s) = sum log s_nn + sum 0.5*log(s1^2 - |sbar|^2), shape s[..., 0]."""
    if layout.num_cone == 0:
        return s.new_zeros(s.shape[:-1])
    sp = layout.gather(s)
    det = sp[..., 0] ** 2 - (sp[..., 1:] ** 2).sum(dim=-1)
    return 0.5 * torch.log(det).sum(dim=-1)


def barrier_gradient(layout: ConeLayout, s):
    """grad Phi = (1/det) * [s1; -sbar] per cone."""
    if layout.num_cone == 0:
        return s
    sp = layout.gather(s)
    det = sp[..., 0:1] ** 2 - (sp[..., 1:] ** 2).sum(dim=-1, keepdim=True)
    grad = torch.cat([sp[..., 0:1], -sp[..., 1:]], dim=-1) / det
    return layout.scatter(grad)


def violation(layout: ConeLayout, xhat, x, tau):
    """Fraction-to-the-boundary test, per lane: True where any cone
    violates xhat - (1-tau)x strictly interior. `tau` broadcasts against
    the leading axes of xhat with a trailing axis of 1."""
    if layout.num_cone == 0:
        return torch.zeros(xhat.shape[:-1], dtype=torch.bool, device=xhat.device)
    v = layout.gather(xhat - (1.0 - tau) * x)
    tail_norm = torch.sqrt((v[..., 1:] ** 2).sum(dim=-1))
    return (v[..., 0] <= tail_norm).any(dim=-1)


def arrow_matrices(layout: ConeLayout, u):
    """Dense padded per-cone arrow matrices of u (..., m_c), (..., C, D,
    D). Padded rows and columns carry values the scatter drops."""
    up = layout.gather(u)
    eye = torch.eye(up.shape[-1], dtype=u.dtype, device=u.device)
    A = up[..., 0:1, None] * eye  # u1 * I, a new tensor
    A[..., 0, :] = up  # head row [u1, ubar]
    A[..., :, 0] = up  # head column
    return A


def _scatter_blocks(layout: ConeLayout, A):
    """Per-cone blocks (..., C, D, D) -> the block-diagonal (..., m_c,
    m_c) matrix; padded slots land on a sacrificial last row and column,
    which are cut off."""
    mc = layout.num_cone
    idx, _, _ = layout._on(A.device)
    lin = (idx[:, :, None] * (mc + 1) + idx[:, None, :]).flatten()
    lead = A.shape[:-3]
    big = A.new_zeros(lead + ((mc + 1) ** 2,)).index_add(-1, lin, A.reshape(lead + (-1,)))
    return big.reshape(lead + (mc + 1, mc + 1))[..., :mc, :mc]


def dense_arrow(layout: ConeLayout, u):
    """Block-diagonal (..., m_c, m_c) matrix of the per-cone arrow(u)."""
    if layout.num_cone == 0:
        return u.new_zeros(u.shape[:-1] + (0, 0))
    return _scatter_blocks(layout, arrow_matrices(layout, u))


def condensed_block(layout: ConeLayout, s, t, eps_p, eps_d):
    """Dense (B, m_c, m_c) condensed cone block -eps_d*I - M^{-1}
    arrow(v), v = s - eps_d*e, M = arrow(t) + eps_p*arrow(v) = arrow(w),
    w = t + eps_p*v, by closed-form arrow solves on the padded cone
    tensor; s, t (B, m_c), eps_p and eps_d (B,)."""
    if layout.num_cone == 0:
        return s.new_zeros(s.shape[:-1] + (0, 0))
    e = layout.target(s.dtype, s.device)
    v = s - eps_d[:, None] * e
    w = t + eps_p[:, None] * v
    wp = layout.gather(w)  # (B, C, D)
    Av = arrow_matrices(layout, v)  # (B, C, D, D)
    # columnwise arrow solve: X[c] = arrow(w[c])^{-1} Av[c]
    u1 = wp[..., 0:1, None]
    ubar = wp[..., 1:]
    det = (wp[..., 0] ** 2 - (ubar**2).sum(dim=-1))[..., None, None]
    x1, xbar = Av[..., 0:1, :], Av[..., 1:, :]
    y1 = (u1 * x1 - (ubar[..., :, None] * xbar).sum(dim=-2, keepdim=True)) / det
    ybar = (xbar - y1 * ubar[..., :, None]) / u1
    X = torch.cat([y1, ybar], dim=-2)
    eye = torch.eye(X.shape[-1], dtype=s.dtype, device=s.device)
    return _scatter_blocks(layout, -X - eps_d[:, None, None, None] * eye)


def c_block_solve(layout: ConeLayout, s, t, eps_p, eps_d, b):
    """Solve (eps_d*I + M^{-1} Cv) x = b per cone, where Cv = arrow(v),
    v = s - eps_d*e, M = arrow(w), w = t + eps_p*v; i.e.
    (eps_d*arrow(w) + arrow(v)) x = arrow(w) b. s, t are (B, m_c), eps_p
    and eps_d per-lane (B,), b is (B, m_c) or (B, m_c, k)."""
    if layout.num_cone == 0:
        return b
    e = layout.target(s.dtype, s.device)
    v = s - eps_d[:, None] * e
    w = t + eps_p[:, None] * v
    u = v + eps_d[:, None] * w
    if b.dim() == 3:
        # columns to a leading axis so the cone axis stays last
        cols = b.transpose(1, 2)
        out = arrow_solve(layout, u[:, None], product(layout, w[:, None], cols))
        return out.transpose(1, 2)
    return arrow_solve(layout, u, product(layout, w, b))
