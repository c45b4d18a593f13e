"""KKT residual, condensed right-hand side, schur factorization, solve and
expansion, and the matrix-free 6-block matvec for iterative refinement.

The schur half of `calipso_tpu/solver/kkt.py`, batch-first: every vector
is (B, m), every matrix (B, m, n), and every per-lane scalar (rho, eps_p,
eps_d, kappa) is (B,). All reductions are per lane.

The primal-dual point is w = (x, r, s, y, z, t): x primal variables, r
equality slacks (g(x) = r), s cone slacks (h(x) = s in K), y equality
duals, z cone duals, t cone-slack duals. 6-block residual:
  rx = fx + gx'y + hx'z      rr = lambda + rho*r - y     rs = -z - t
  ry = g - r                 rz = h - s                  rt = s o t - kappa*e
The regularized Newton system is condensed by eliminating (r, s, t) and
then the dual blocks, onto the (n, n) primal Schur complement
  S = Hxx + eps_p*I + gx' gx / c_eq + hx' Ccone^-1 hx,
  c_eq = 1/(rho + eps_p) + eps_d,
whose Cholesky factor is the whole factorization. Correct inertia <=> S is
positive definite <=> the factor is finite.

The other backends (riccati, cr, ldl, lu, spike) are ROADMAP Queue 1 items
9, 16, 17 and 19.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from calipso_tpu_torch.ops import cones
from calipso_tpu_torch.ops import riccati as rc


def _mv(A, v):
    """Per-lane A @ v: (B, m, n) x (B, n) -> (B, m)."""
    return (A @ v[..., None])[..., 0]


def _mtv(A, v):
    """Per-lane A' @ v: (B, m, n) x (B, m) -> (B, n)."""
    return (A.mT @ v[..., None])[..., 0]


class Blocks(NamedTuple):
    """A vector in the 6-block residual/step space, (B, .) per block."""

    x: torch.Tensor
    r: torch.Tensor
    s: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor

    @property
    def all(self):
        return torch.cat(list(self), dim=-1)

    @property
    def primals(self):
        return torch.cat([self.x, self.r, self.s], dim=-1)


def residual(fx, gty_x, htz_x, g, h, cone_prod, cone_target, point, kappa, rho, lam):
    """6-block KKT residual at `point`."""
    rx = fx + gty_x + htz_x
    rr = lam + rho[:, None] * point.r - point.y
    rs = -point.z - point.t
    ry = g - point.r
    rz = h - point.s
    rt = cone_prod - kappa[:, None] * cone_target
    return Blocks(rx, rr, rs, ry, rz, rt)


def condensed_rhs(layout, res: Blocks, s, t, rho, eps_p, eps_d):
    """Condense the 6-block residual to the symmetric (n + m_e + m_c) RHS."""
    req = res.y + res.r / (rho + eps_p)[:, None]
    if s.shape[-1] == 0:
        return torch.cat([res.x, req, res.z], dim=-1)
    e = layout.target(res.x.dtype, res.x.device)
    v = s - eps_d[:, None] * e
    w = t + eps_p[:, None] * v
    rcone = res.z + cones.arrow_solve(layout, w, cones.product(layout, v, res.s) + res.t)
    return torch.cat([res.x, req, rcone], dim=-1)


def expand(layout, res: Blocks, d_sym, n, me, mc, s, t, rho, eps_p, eps_d):
    """Recover (dr, ds, dt) from the condensed solution exactly."""
    dx = d_sym[:, :n]
    dy = d_sym[:, n : n + me]
    dz = d_sym[:, n + me :]
    dr = (res.r + dy) / (rho + eps_p)[:, None]
    if mc == 0:
        return Blocks(dx, dr, res.s, dy, dz, res.t)
    e = layout.target(res.x.dtype, res.x.device)
    v = s - eps_d[:, None] * e
    w = t + eps_p[:, None] * v
    ds = cones.arrow_solve(layout, w, res.t + cones.product(layout, v, res.s + dz))
    dt = cones.arrow_solve(layout, v, res.t - cones.product(layout, t, ds))
    return Blocks(dx, dr, ds, dy, dz, dt)


def matvec(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d, d: Blocks) -> Blocks:
    """Exact regularized 6-block Jacobian-vector product J @ d."""
    ep, ed = eps_p[:, None], eps_d[:, None]
    orr = (rho[:, None] + ep) * d.r - d.y
    oy = _mv(gx, d.x) - d.r - ed * d.y
    if s.shape[-1] == 0:
        ox = _mv(Hxx, d.x) + ep * d.x + _mtv(gx, d.y)
        return Blocks(ox, orr, d.s, oy, d.z, d.t)
    e = layout.target(d.x.dtype, d.x.device)
    v = s - ed * e
    ox = _mv(Hxx, d.x) + ep * d.x + _mtv(gx, d.y) + _mtv(hx, d.z)
    os_ = ep * d.s - d.z - d.t
    oz = _mv(hx, d.x) - d.s - ed * d.z
    ot = cones.product(layout, t, d.s) + cones.product(layout, v, d.t)
    return Blocks(ox, orr, os_, oy, oz, ot)


class Factorization(NamedTuple):
    """The schur factorization plus the context needed to apply it."""

    L: torch.Tensor  # (B, n, n) lower Cholesky factor of S
    gx: torch.Tensor
    hx: torch.Tensor
    s: torch.Tensor
    t: torch.Tensor
    rho: torch.Tensor
    eps_p: torch.Tensor
    eps_d: torch.Tensor


def check_method(method):
    """Refuse every backend but schur, naming the ROADMAP item that brings it."""
    if method != "schur":
        raise NotImplementedError(
            f"linear_solver={method!r}: the port has the schur backend only "
            "(riccati/cr: ROADMAP Queue 1 items 9-10 and 17; ldl/lu: item 16; "
            "spike: item 19)"
        )


def _ceq(rho, eps_p, eps_d):
    """Diagonal of the condensed equality block (positive), (B,)."""
    return 1.0 / (rho + eps_p) + eps_d


def factorize(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d, method="schur"):
    """Form the primal Schur complement S and factor it (kernel on CUDA)."""
    check_method(method)
    n = Hxx.shape[-1]
    ceq = _ceq(rho, eps_p, eps_d)
    eye = torch.eye(n, dtype=Hxx.dtype, device=Hxx.device)
    S = Hxx + eps_p[:, None, None] * eye
    if gx.shape[-2] > 0:
        S = S + gx.mT @ (gx / ceq[:, None, None])
    if hx.shape[-2] > 0:
        Cinv_hx = cones.c_block_solve(layout, s, t, eps_p, eps_d, hx)
        S = S + hx.mT @ Cinv_hx
    S = 0.5 * (S + S.mT)
    L = rc.chol(S)
    return Factorization(L, gx, hx, s, t, rho, eps_p, eps_d)


def inertia_ok(fact: Factorization):
    """Target inertia, per lane: the schur factor is finite."""
    return torch.isfinite(fact.L).all(dim=-1).all(dim=-1)


def _tiny_pivots(diags):
    """Per lane, count Cholesky pivots below a dtype-scaled relative
    threshold -- the rank-deficiency signal. NaN/Inf pivots (failed
    factorization) do not count."""
    a = diags.abs()
    finite = torch.isfinite(a)
    amax = torch.where(finite, a, torch.zeros_like(a)).amax(dim=-1, keepdim=True)
    thr = torch.finfo(diags.dtype).eps ** 0.75 * amax
    return (finite & (a <= thr)).sum(dim=-1).to(torch.int32)


def num_zero_eigs(fact: Factorization):
    """Zero-eigenvalue count for the rank-deficiency branch of the
    inertia correction, per lane."""
    return _tiny_pivots(torch.diagonal(fact.L, dim1=-2, dim2=-1))


def solve_sym(layout, fact: Factorization, rhs, n, me, mc):
    """Solve the condensed symmetric system for rhs (B, n + m_e + m_c)."""
    rx = rhs[:, :n]
    req = rhs[:, n : n + me]
    rcone = rhs[:, n + me :]
    ceq = _ceq(fact.rho, fact.eps_p, fact.eps_d)
    rhs_x = rx
    if me > 0:
        rhs_x = rhs_x + _mtv(fact.gx, req / ceq[:, None])
    if mc > 0:
        t3 = cones.c_block_solve(layout, fact.s, fact.t, fact.eps_p, fact.eps_d, rcone)
        rhs_x = rhs_x + _mtv(fact.hx, t3)
    dx = rc.chol_solve(fact.L, rhs_x.contiguous())
    dy = (_mv(fact.gx, dx) - req) / ceq[:, None] if me > 0 else req
    if mc > 0:
        dz = cones.c_block_solve(
            layout, fact.s, fact.t, fact.eps_p, fact.eps_d, _mv(fact.hx, dx) - rcone
        )
    else:
        dz = rcone
    return torch.cat([dx, dy, dz], dim=-1)


def solve_with(layout, fact: Factorization, res: Blocks, n, me, mc) -> Blocks:
    """Condense -> factorized solve -> expand, for a 6-block RHS."""
    s, t, rho = fact.s, fact.t, fact.rho
    rhs = condensed_rhs(layout, res, s, t, rho, fact.eps_p, fact.eps_d)
    d_sym = solve_sym(layout, fact, rhs, n, me, mc)
    return expand(layout, res, d_sym, n, me, mc, s, t, rho, fact.eps_p, fact.eps_d)
