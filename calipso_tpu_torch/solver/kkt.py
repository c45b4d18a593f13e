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

Two backends factor S:
- "schur": S dense, one (B, n, n) Cholesky.
- "riccati" (trajopt problems): S in stage-block tridiagonal form (T
  diagonal and T-1 coupling blocks of the stages' widths, padded to the
  widest with identity), factored by the block-tridiagonal Cholesky over
  the stages. Its Lagrangian Hessian may come as a `BandHessian` (the
  stage blocks straight from the structured oracles), so no dense (n, n)
  Hessian is built on its path.
The general-equality low-rank border of the riccati backend (2 or more
stages coupled by `equality_general`) and the multi-RHS solve are ROADMAP
Queue 1 item 12; the other backends (cr, ldl, lu, spike) are items 16, 17
and 19.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from calipso_tpu_torch.ops import cones
from calipso_tpu_torch.ops import riccati as rc


def _mv(A, v):
    """Per-lane A @ v: (B, m, n) x (B, n) -> (B, m)."""
    return (A @ v[..., None])[..., 0]


def _mtv(A, v):
    """Per-lane A' @ v: (B, m, n) x (B, m) -> (B, n)."""
    return (A.mT @ v[..., None])[..., 0]


class BandHessian:
    """Lagrangian Hessian in stage-block tridiagonal form (built by
    `trajopt/structured.py:lagrangian_hessian_blocks`): D (B, T, dmax,
    dmax) diagonal blocks, O (B, T-1, dmax, dmax) sub-diagonal couplings,
    Hgen the dense (B, n, n) equality_general dual Hessian or None, st the
    StageStructure."""

    def __init__(self, D, O, Hgen, st):
        self.D = D
        self.O = O
        self.Hgen = Hgen
        self.st = st


def hess_mv(Hxx, v):
    """Per-lane Hxx @ v for a dense (B, n, n) or BandHessian Hessian."""
    if isinstance(Hxx, BandHessian):
        out = Hxx.st.band_matvec(Hxx.D, Hxx.O, v)
        return out if Hxx.Hgen is None else out + _mv(Hxx.Hgen, v)
    return _mv(Hxx, v)


def hess_dense(Hxx):
    """Dense (B, n, n) view of a dense or BandHessian Hessian."""
    if isinstance(Hxx, BandHessian):
        H = Hxx.st.densify(Hxx.D, Hxx.O)
        return H if Hxx.Hgen is None else H + Hxx.Hgen
    return Hxx


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
        ox = hess_mv(Hxx, d.x) + ep * d.x + _mtv(gx, d.y)
        return Blocks(ox, orr, d.s, oy, d.z, d.t)
    e = layout.target(d.x.dtype, d.x.device)
    v = s - ed * e
    ox = hess_mv(Hxx, d.x) + ep * d.x + _mtv(gx, d.y) + _mtv(hx, d.z)
    os_ = ep * d.s - d.z - d.t
    oz = _mv(hx, d.x) - d.s - ed * d.z
    ot = cones.product(layout, t, d.s) + cones.product(layout, v, d.t)
    return Blocks(ox, orr, os_, oy, oz, ot)


class Factorization(NamedTuple):
    """The factorization plus the context needed to apply it."""

    L: torch.Tensor  # schur: (B, n, n) chol(S); riccati: (B, T, d, d) stage factors
    M: Optional[torch.Tensor]  # riccati: (B, T-1, d, d) couplings; schur: None
    gx: torch.Tensor
    hx: torch.Tensor
    s: torch.Tensor
    t: torch.Tensor
    rho: torch.Tensor
    eps_p: torch.Tensor
    eps_d: torch.Tensor


def check_method(method, structure=None):
    """Refuse every backend the port does not have, naming the ROADMAP
    item that brings it."""
    if method == "schur":
        return
    if method == "riccati":
        if structure is None:
            raise ValueError(
                "linear_solver='riccati' requires a trajopt problem (stage structure)"
            )
        if structure.num_general and len(structure.general_stages) >= 2:
            raise NotImplementedError(
                "linear_solver='riccati' with equality_general rows over "
                f"{len(structure.general_stages)} stages needs the low-rank "
                "general-equality border: ROADMAP Queue 1 item 12"
            )
        return
    raise NotImplementedError(
        f"linear_solver={method!r}: the port has the schur and riccati backends "
        "(cr: ROADMAP Queue 1 item 17; ldl/lu: item 16; spike: item 19)"
    )


def _ceq(rho, eps_p, eps_d):
    """Diagonal of the condensed equality block (positive), (B,)."""
    return 1.0 / (rho + eps_p) + eps_d


def factorize(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d, method="schur", structure=None):
    """Form the primal Schur complement S and factor it (kernels on CUDA):
    dense for "schur", in stage blocks for "riccati"."""
    check_method(method, structure)
    if method == "riccati":
        D, O = _riccati_blocks(layout, structure, Hxx, gx, hx, s, t, rho, eps_p, eps_d)
        L, M = rc.factor(D, O)
        return Factorization(L, M, gx, hx, s, t, rho, eps_p, eps_d)
    Hxx = hess_dense(Hxx)
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
    return Factorization(L, None, gx, hx, s, t, rho, eps_p, eps_d)


def _grouped(spans, key_fn):
    table = {}
    for sp in spans:
        table.setdefault(key_fn(sp), []).append(sp)
    return table.values()


def _riccati_blocks(layout, st, Hxx, gx, hx, s, t, rho, eps_p, eps_d):
    """The stage-block tridiagonal form (D (B, T, dmax, dmax), O (B, T-1,
    dmax, dmax)) of the primal Schur complement S: the Hessian's blocks
    (from a BandHessian, or gathered from a dense Hessian), eps_p on the
    real diagonal and 1 on the padded one (so ragged stages decouple
    exactly), and the Gram terms of the equality and cone rows, stage by
    stage. Spans of equal shape are stacked and added in one batched op."""
    dmax, dev = st.dmax, gx.device
    ceq = _ceq(rho, eps_p, eps_d)[:, None, None, None]
    Chx = cones.c_block_solve(layout, s, t, eps_p, eps_d, hx) if hx.shape[-2] > 0 else hx
    blk = st.tensor("blk_idx", st.blk_idx, dev)  # (T, dmax), sentinel n on padding

    def gather(H):
        Hp = F.pad(H, (0, 1, 0, 1))
        return Hp[:, blk[:, :, None], blk[:, None, :]], Hp[:, blk[1:, :, None], blk[:-1, None, :]]

    if isinstance(Hxx, BandHessian):
        D, O = Hxx.D, Hxx.O
        if Hxx.Hgen is not None:
            # the band part of the equality_general curvature folds into the
            # blocks; iterative refinement absorbs the off-band remainder
            Dg, Og = gather(Hxx.Hgen)
            D, O = D + Dg, O + Og
    else:
        D, O = gather(Hxx)
    D = D + torch.diag_embed(torch.where(st.pad_mask(dev), 1.0, eps_p[:, None, None]).to(D.dtype))

    def span_block(M, sp, stage):
        """(B, r, dmax) block of M: the span's rows, the stage's columns."""
        cs, dcol = st.col_starts[stage], st.col_dims[stage]
        return F.pad(M[:, sp.row_start : sp.row_start + sp.num_rows, cs : cs + dcol], (0, dmax - dcol))

    def stages(key, group, shift=0):
        return st.tensor(("stages", key, shift), [sp.stage + shift for sp in group], dev)

    gram = lambda A, C: torch.einsum("lgrw,lgrv->lgwv", A, C)
    key_eq = lambda sp: (sp.num_rows, sp.two_stage, st.col_dims[sp.stage], sp.next_width)
    for group in _grouped(st.eq_spans, key_eq):
        key = ("eq", key_eq(group[0]))
        J1 = torch.stack([span_block(gx, sp, sp.stage) for sp in group], dim=1)  # (B, G, r, dmax)
        D = D.index_add(1, stages(key, group), gram(J1, J1) / ceq)
        if group[0].two_stage:
            J2 = torch.stack([span_block(gx, sp, sp.stage + 1) for sp in group], dim=1)
            D = D.index_add(1, stages(key, group, 1), gram(J2, J2) / ceq)
            O = O.index_add(1, stages(key, group), gram(J2, J1) / ceq)

    # block-diagonal fold of the general-equality Gram Jg'Jg/c_eq: keeps
    # the boundary-condition curvature in the band so the inertia ladder
    # does not over-regularize (one general stage: this is all of it)
    rg = st.num_general
    if rg and st.general_stages:
        Jg = gx[:, gx.shape[1] - rg :]
        G = torch.stack(
            [
                F.pad(Jg[:, :, st.col_starts[k] : st.col_starts[k] + st.col_dims[k]], (0, dmax - st.col_dims[k]))
                for k in st.general_stages
            ],
            dim=2,
        )  # (B, rg, k, dmax)
        tg = st.tensor("general_stages", list(st.general_stages), dev)
        D = D.index_add(1, tg, torch.einsum("lrkw,lrkv->lkwv", G, G) / ceq)

    if hx.shape[-2]:
        key_cone = lambda sp: (sp.num_rows, st.col_dims[sp.stage])
        for group in _grouped(st.cone_spans, key_cone):
            J = torch.stack([span_block(hx, sp, sp.stage) for sp in group], dim=1)
            Jc = torch.stack([span_block(Chx, sp, sp.stage) for sp in group], dim=1)
            b = gram(J, Jc)
            D = D.index_add(1, stages(("cone", key_cone(group[0])), group), 0.5 * (b + b.mT))
    return D, O


def inertia_ok(fact: Factorization):
    """Target inertia, per lane: the Cholesky factor is finite (schur and
    riccati alike)."""
    return torch.isfinite(fact.L).flatten(1).all(dim=1)


def _tiny_pivots(diags):
    """Per lane, count Cholesky pivots below a dtype-scaled relative
    threshold -- the rank-deficiency signal. NaN/Inf pivots (failed
    factorization) do not count."""
    a = diags.abs()
    finite = torch.isfinite(a)
    amax = torch.where(finite, a, torch.zeros_like(a)).amax(dim=-1, keepdim=True)
    thr = torch.finfo(diags.dtype).eps ** 0.75 * amax
    return (finite & (a <= thr)).sum(dim=-1).to(torch.int32)


def num_zero_eigs(fact: Factorization, method="schur", structure=None):
    """Zero-eigenvalue count for the rank-deficiency branch of the
    inertia correction, per lane. The riccati backend excludes the padded
    unit pivots of ragged stages."""
    diags = torch.diagonal(fact.L, dim1=-2, dim2=-1)  # (B, n) or (B, T, dmax)
    if method == "riccati":
        pad = structure.pad_mask(diags.device)
        diags = torch.where(pad, torch.full_like(diags, float("nan")), diags).flatten(1)
    return _tiny_pivots(diags)


def solve_sym(layout, fact: Factorization, rhs, n, me, mc, method="schur", structure=None):
    """Solve the condensed symmetric system for rhs (B, n + m_e + m_c)."""
    if rhs.dim() != 2:
        raise NotImplementedError(
            "solve_sym with several right-hand sides (solve_multi): ROADMAP "
            "Queue 1 item 12 (the border) and item 18 (differentiation)"
        )
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
    if method == "riccati":
        dx = structure.from_blocks(rc.solve(fact.L, fact.M, structure.to_blocks(rhs_x)))
    else:
        dx = rc.chol_solve(fact.L, rhs_x.contiguous())
    dy = (_mv(fact.gx, dx) - req) / ceq[:, None] if me > 0 else req
    if mc > 0:
        dz = cones.c_block_solve(
            layout, fact.s, fact.t, fact.eps_p, fact.eps_d, _mv(fact.hx, dx) - rcone
        )
    else:
        dz = rcone
    return torch.cat([dx, dy, dz], dim=-1)


def solve_with(
    layout, fact: Factorization, res: Blocks, n, me, mc, method="schur", structure=None
) -> Blocks:
    """Condense -> factorized solve -> expand, for a 6-block RHS."""
    s, t, rho = fact.s, fact.t, fact.rho
    rhs = condensed_rhs(layout, res, s, t, rho, fact.eps_p, fact.eps_d)
    d_sym = solve_sym(layout, fact, rhs, n, me, mc, method, structure)
    return expand(layout, res, d_sym, n, me, mc, s, t, rho, fact.eps_p, fact.eps_d)
