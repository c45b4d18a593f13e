"""KKT residual, condensed right-hand side and matrix, factorizations,
solves and expansion, the matrix-free 6-block matvec for iterative
refinement, and the dense full-system LU step.

The counterpart of `calipso_tpu/solver/kkt.py`, batch-first: every vector
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

The backends (`Options.linear_solver`):
- "schur": S dense, one (B, n, n) Cholesky.
- "riccati" (trajopt problems): S in stage-block tridiagonal form (T
  diagonal and T-1 coupling blocks of the stages' widths, padded to the
  widest with identity), factored by the block-tridiagonal Cholesky over
  the stages. Its Lagrangian Hessian may come as a `BandHessian` (the
  stage blocks straight from the structured oracles), so no dense (n, n)
  Hessian is built on its path. `equality_general` rows that couple 2 or
  more stages enter as a low-rank border of the banded S (Woodbury, with
  the inertia of a small capacitance matrix; see `_general_border`).
- "cr" (trajopt problems): the same stage blocks and border, factored by
  parallel block cyclic reduction (`ops/cyclic_reduction.py`).
- "ldl": the dense (B, ns, ns) condensed matrix (`condensed_matrix`,
  ns = n + m_e + m_c) by unpivoted LDL^T (`ops/ldl.py`), the inertia
  read exactly off sign(D).
- "lu": the inertia ladder runs on schur, the step comes from a dense LU
  solve of the full 6-block system (`lu_solve_full`), which is also the
  escalation of `Options.refinement_fallback`.
"spike" (the horizon sharded over devices) is ROADMAP Queue 1 item 19.
`solve_sym` takes one right-hand side (B, ns), or on riccati, cr and ldl
several (B, ns, K); several on schur belong to differentiation (ROADMAP
Queue 1 item 18).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from calipso_tpu_torch.ops import cones
from calipso_tpu_torch.ops import cyclic_reduction as crd
from calipso_tpu_torch.ops import ldl
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


def condensed_matrix(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d):
    """The dense symmetric condensed KKT matrix (B, ns, ns):
      [ Hxx + eps_p I   gx'                         hx'    ]
      [ gx              (-1/(rho+eps_p) - eps_d) I  0      ]
      [ hx              0                           Kcone  ]
    with Kcone the condensed cone block (`cones.condensed_block`), mildly
    nonsymmetric for second-order cones and symmetrized here; iterative
    refinement on the exact 6-block operator absorbs the difference."""
    Hxx = hess_dense(Hxx)
    B, n = Hxx.shape[0], Hxx.shape[-1]
    me, mc = gx.shape[-2], hx.shape[-2]
    dtype, dev = Hxx.dtype, Hxx.device
    K11 = Hxx + eps_p[:, None, None] * torch.eye(n, dtype=dtype, device=dev)
    Keq = (-1.0 / (rho + eps_p) - eps_d)[:, None, None] * torch.eye(me, dtype=dtype, device=dev)
    Kcone = cones.condensed_block(layout, s, t, eps_p, eps_d)
    Kcone = 0.5 * (Kcone + Kcone.mT)
    Z = lambda a, b: Hxx.new_zeros((B, a, b))
    top = torch.cat([K11, gx.mT, hx.mT], dim=2)
    mid = torch.cat([gx, Keq, Z(me, mc)], dim=2)
    bot = torch.cat([hx, Z(mc, me), Kcone], dim=2)
    return torch.cat([top, mid, bot], dim=1)


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


def full_matrix(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d):
    """The dense regularized 6-block KKT matrix (B, N, N), N = n + 2 m_e +
    3 m_c, whose product with a step is `matvec`: the nonsymmetric system
    of the "lu" backend."""
    Hxx = hess_dense(Hxx)
    B, n = Hxx.shape[0], Hxx.shape[-1]
    me, mc = gx.shape[-2], hx.shape[-2]
    dtype, dev = Hxx.dtype, Hxx.device
    lane = lambda a: a[:, None, None]
    eye = lambda m: torch.eye(m, dtype=dtype, device=dev).expand(B, m, m)
    Ieq, Ic = eye(me), eye(mc)
    Cs = cones.dense_arrow(layout, t)
    Ct = cones.dense_arrow(layout, s) - lane(eps_d) * Ic
    Z = lambda a, b: Hxx.new_zeros((B, a, b))
    rows = [
        [Hxx + lane(eps_p) * eye(n), Z(n, me), Z(n, mc), gx.mT, hx.mT, Z(n, mc)],
        [Z(me, n), lane(rho + eps_p) * Ieq, Z(me, mc), -Ieq, Z(me, mc), Z(me, mc)],
        [Z(mc, n), Z(mc, me), lane(eps_p) * Ic, Z(mc, me), -Ic, -Ic],
        [gx, -Ieq, Z(me, mc), -lane(eps_d) * Ieq, Z(me, mc), Z(me, mc)],
        [hx, Z(mc, me), -Ic, Z(mc, me), -lane(eps_d) * Ic, Z(mc, mc)],
        [Z(mc, n), Z(mc, me), Cs, Z(mc, me), Z(mc, mc), Ct],
    ]
    return torch.cat([torch.cat(r, dim=2) for r in rows], dim=1)


def lu_solve_full(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d, res: Blocks) -> Blocks:
    """Solve the full 6-block system with a dense LU per lane. A singular
    lane comes out as inf or NaN, never an exception."""
    n = gx.shape[-1]
    me, mc = gx.shape[-2], hx.shape[-2]
    J = full_matrix(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d)
    sol, _ = torch.linalg.solve_ex(J, res.all[..., None])
    o = np.cumsum([0, n, me, mc, me, mc, mc])
    return Blocks(*(sol[:, o[i] : o[i + 1], 0] for i in range(6)))


class Factorization(NamedTuple):
    """The factorization plus the context needed to apply it."""

    # schur: (B, n, n) chol(S); riccati: (B, T, d, d) stage factors; ldl:
    # (B, ns, ns) unit-lower; cr: None
    L: Optional[torch.Tensor]
    M: Optional[torch.Tensor]  # riccati: (B, T-1, d, d) couplings; otherwise None
    gx: torch.Tensor
    hx: torch.Tensor
    s: torch.Tensor
    t: torch.Tensor
    rho: torch.Tensor
    eps_p: torch.Tensor
    eps_d: torch.Tensor
    # riccati with a general-equality border (see _general_border): Wg =
    # S_bd^{-1} V (B, n, k*r_g) and (Lc, dc), the eigenvectors (B, k*r_g,
    # k*r_g) and eigenvalues (B, k*r_g) of the indefinite capacitance C;
    # None without a border
    Wg: Optional[torch.Tensor] = None
    Lc: Optional[torch.Tensor] = None
    dc: Optional[torch.Tensor] = None
    d: Optional[torch.Tensor] = None  # ldl: (B, ns) pivots of D
    # cr: (levels, L_final) of ops/cyclic_reduction.factor
    cr: Optional[tuple] = None


STRUCTURED = ("riccati", "cr")  # the backends that need a stage structure


def check_method(method, structure=None):
    """Refuse a backend the port does not have (spike, naming the ROADMAP
    item that brings it) or one the problem cannot take."""
    if method in ("schur", "ldl", "lu"):
        return
    if method in STRUCTURED:
        if structure is None:
            raise ValueError(
                f"linear_solver={method!r} requires a trajopt problem (stage structure)"
            )
        return
    if method == "spike":
        raise NotImplementedError(
            "linear_solver='spike': horizon sharding over devices is ROADMAP Queue 1 item 19"
        )
    raise ValueError(f"unknown linear_solver {method!r}")


def _ceq(rho, eps_p, eps_d):
    """Diagonal of the condensed equality block (positive), (B,)."""
    return 1.0 / (rho + eps_p) + eps_d


def _has_border(structure):
    return bool(structure.num_general) and len(structure.general_stages) >= 2


def factorize(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d, method="schur", structure=None):
    """Factor the condensed system: the primal Schur complement S dense
    for "schur" (and "lu", whose ladder runs on it) through the T=1
    kernels, in stage blocks for "riccati" (the block-tridiagonal kernels)
    and "cr" (cyclic reduction), or the whole condensed matrix for
    "ldl"."""
    check_method(method, structure)
    if method in STRUCTURED:
        D, O = _riccati_blocks(layout, structure, Hxx, gx, hx, s, t, rho, eps_p, eps_d)
        if method == "riccati":
            L, M = rc.factor(D, O)
            fact = Factorization(L, M, gx, hx, s, t, rho, eps_p, eps_d)
        else:
            fact = Factorization(None, None, gx, hx, s, t, rho, eps_p, eps_d, cr=crd.factor(D, O))
        if _has_border(structure):
            Wg, Lc, dc = _general_border(structure, _block_solver(fact), gx, rho, eps_p, eps_d)
            fact = fact._replace(Wg=Wg, Lc=Lc, dc=dc)
        return fact
    if method == "ldl":
        L, dvec = ldl.ldl_factor(condensed_matrix(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d))
        return Factorization(L, None, gx, hx, s, t, rho, eps_p, eps_d, d=dvec)
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


def _block_solver(fact: Factorization):
    """The stage-block solve of a riccati or cr factorization: (B, T,
    dmax, K) right-hand sides -> S_band^{-1} applied to them."""
    if fact.cr is not None:
        return lambda Bb: crd.solve_multi(fact.cr, Bb)
    return lambda Bb: rc.solve_multi(fact.L, fact.M, Bb)


def _banded_solve_multi(structure, solve_blocks, Bm):
    """Apply S_band^{-1} to the columns of Bm (B, n, K) through
    `solve_blocks` (see `_block_solver`)."""
    Bb = structure.to_blocks(Bm.mT).permute(0, 2, 3, 1)  # (B, T, dmax, K)
    X = solve_blocks(Bb)
    return structure.from_blocks(X.permute(0, 3, 1, 2)).mT


def _border_V(structure, gx):
    """Stage-split border columns for the general-equality rows, (B, n,
    k*r_g).

    The r_g general rows Jg (the last rows of gx, dense over the whole
    trajectory) touch the k = len(general_stages) stages found at
    construction. With V_t = Jg' masked to stage t's variable rows,
        Jg' Jg = sum_t V_t V_t' + sum_{t != t'} V_t V_t'.
    The block-diagonal first part is banded and PSD; `_riccati_blocks`
    folds it into the stage blocks. The cross part is the low-rank border
    V Kx V' with V = [V_1 .. V_k] and Kx = ((11' - I) kron I_rg) / c_eq."""
    rg = structure.num_general
    JgT = gx[:, gx.shape[1] - rg :].mT  # (B, n, rg)
    mask = np.zeros((structure.num_variables, len(structure.general_stages)), bool)
    for s, t in enumerate(structure.general_stages):
        mask[structure.col_starts[t] : structure.col_starts[t] + structure.col_dims[t], s] = True
    mask = structure.tensor("border_mask", mask, gx.device)
    return (JgT[:, :, None, :] * mask[None, :, :, None]).flatten(2)  # column s*rg + r


def _general_border(structure, solve_blocks, gx, rho, eps_p, eps_d):
    """Border factorization for S = S_bd + V Kx V' (see _border_V; S_bd is
    the banded part, including the folded block diagonal of Jg'Jg/c_eq).

    Woodbury with the indefinite core Kx:
      S^{-1} b = S_bd^{-1} b - Wg C^{-1} V' S_bd^{-1} b,
      Wg = S_bd^{-1} V,  C = Kx^{-1} + V' Wg,
    with C (B, k*r_g, k*r_g) factored by `torch.linalg.eigh` (it is
    indefinite by design). By Haynsworth, S is positive definite iff S_bd
    is and inertia(C) = (r_g, (k-1) r_g, 0): `_border_inertia_ok`. A lane
    whose C is not finite (its banded factor failed) gets NaN eigenvalues,
    as the reference's eigh gives, rather than an exception."""
    rg = structure.num_general
    k = len(structure.general_stages)
    dtype, dev = gx.dtype, gx.device
    V = _border_V(structure, gx)
    Wg = _banded_solve_multi(structure, solve_blocks, V)
    # Kx^{-1} = c_eq ((11' - I)^{-1} kron I_rg), (11' - I)^{-1} = 11'/(k-1) - I
    Jk = torch.ones((k, k), dtype=dtype, device=dev) / (k - 1) - torch.eye(k, dtype=dtype, device=dev)
    Kx_inv = _ceq(rho, eps_p, eps_d)[:, None, None] * torch.kron(Jk, torch.eye(rg, dtype=dtype, device=dev))
    C = Kx_inv + V.mT @ Wg
    C = 0.5 * (C + C.mT)
    finite = torch.isfinite(C).flatten(1).all(dim=1)
    eye = torch.eye(C.shape[-1], dtype=dtype, device=dev)
    dc, Lc = torch.linalg.eigh(torch.where(finite[:, None, None], C, eye))
    dc = torch.where(finite[:, None], dc, torch.full_like(dc, float("nan")))
    return Wg, Lc, dc


def _apply_border(fact: Factorization, structure, dx):
    """Woodbury correction for the general-equality border: dx <- dx - Wg
    C^{-1} V' dx, for dx (B, n) or (B, n, K) (no-op without a border)."""
    if fact.Wg is None:
        return dx
    vec = dx.dim() == 2
    X = dx[..., None] if vec else dx
    V = _border_V(structure, fact.gx)
    w = (fact.Lc.mT @ (V.mT @ X)) / fact.dc[..., None]
    out = X - fact.Wg @ (fact.Lc @ w)
    return out[..., 0] if vec else out


def _border_inertia_ok(fact: Factorization, structure):
    """Border part of the inertia test, per lane: inertia(C) = (r_g,
    (k-1) r_g, 0) (Haynsworth; see _general_border). Eigenvalues within a
    dtype-scaled band of zero count as zero eigenvalues."""
    if fact.dc is None:
        return torch.ones(fact.gx.shape[0], dtype=torch.bool, device=fact.gx.device)
    rg = structure.num_general
    k = len(structure.general_stages)
    dc = fact.dc
    tol = torch.finfo(dc.dtype).eps ** 0.75 * dc.abs().amax(dim=-1, keepdim=True)
    pos = (dc > tol).sum(dim=-1)
    neg = (dc < -tol).sum(dim=-1)
    return (pos == rg) & (neg == (k - 1) * rg)


def inertia_ok(fact: Factorization, structure=None):
    """Target inertia (n positive, m_e + m_c negative, no zero
    eigenvalue), per lane. ldl reads it off sign(D); the Cholesky backends
    off a finite factor (schur and riccati: L; cr: every level's), with
    the capacitance's inertia on a border."""
    if fact.d is not None:
        n, me, mc = fact.gx.shape[-1], fact.gx.shape[-2], fact.hx.shape[-2]
        pos, neg, zero = ldl.inertia_counts(fact.d)
        return (pos == n) & (neg == me + mc) & (zero == 0)
    if fact.cr is not None:
        ok = crd.factors_finite(fact.cr)
    else:
        ok = torch.isfinite(fact.L).flatten(1).all(dim=1)
    return ok & _border_inertia_ok(fact, structure)


def _tiny_pivots(diags):
    """Per lane, count Cholesky pivots below a dtype-scaled relative
    threshold -- the rank-deficiency signal. NaN/Inf pivots (failed
    factorization) do not count."""
    a = diags.abs()
    finite = torch.isfinite(a)
    amax = torch.where(finite, a, torch.zeros_like(a)).amax(dim=-1, keepdim=True)
    thr = torch.finfo(diags.dtype).eps ** 0.75 * amax
    return (finite & (a <= thr)).sum(dim=-1).to(torch.int32)


def _cr_pad_masks(structure, device):
    """The padded slots of the stages cyclic reduction factors at each
    level: (co, dmax) for a level's odd stages (level l eliminates
    original stages (2k+1) 2^l), then (dmax,) for the final stage."""
    pad = structure.blk_idx == structure.num_variables
    stages = np.arange(structure.horizon)
    masks = []
    while len(stages) > 1:
        masks.append(structure.tensor(("cr_pad", len(masks)), pad[stages[1::2]], device))
        stages = stages[0::2]
    masks.append(structure.tensor(("cr_pad", "final"), pad[stages[0]], device))
    return masks


def num_zero_eigs(fact: Factorization, method="schur", structure=None):
    """Zero-eigenvalue count for the rank-deficiency branch of the
    inertia correction, per lane: exact from sign(D) for ldl; for the
    Cholesky backends, pivots that collapsed below a dtype-scaled
    threshold. riccati and cr exclude the padded unit pivots of ragged
    stages (padded dimensions stay identity through every reduction)."""
    if method == "ldl":
        return ldl.inertia_counts(fact.d)[2]
    nan = lambda a: torch.full_like(a, float("nan"))
    if method == "cr":
        levels, L_final = fact.cr
        diags = [torch.diagonal(Lodd, dim1=-2, dim2=-1) for Lodd, _, _ in levels]
        diags.append(torch.diagonal(L_final, dim1=-2, dim2=-1))
        if structure is not None:
            masks = _cr_pad_masks(structure, L_final.device)
            diags = [torch.where(pad, nan(dg), dg) for pad, dg in zip(masks, diags)]
        return _tiny_pivots(torch.cat([dg.flatten(1) for dg in diags], dim=1))
    diags = torch.diagonal(fact.L, dim1=-2, dim2=-1)  # (B, n) or (B, T, dmax)
    if method == "riccati":
        pad = structure.pad_mask(diags.device)
        diags = torch.where(pad, nan(diags), diags).flatten(1)
    return _tiny_pivots(diags)


def solve_sym(layout, fact: Factorization, rhs, n, me, mc, method="schur", structure=None):
    """Solve the condensed symmetric system for rhs (B, n + m_e + m_c), or
    on the riccati, cr and ldl backends for K right-hand sides at once,
    rhs (B, n + m_e + m_c, K). "lu" applies its schur factor."""
    vec = rhs.dim() == 2
    if not vec and method not in STRUCTURED + ("ldl",):
        raise NotImplementedError(
            "solve_sym with several right-hand sides on the schur backend belongs "
            "to differentiation: ROADMAP Queue 1 item 18"
        )
    if method == "ldl":
        return ldl.ldl_solve(fact.L, fact.d, rhs)
    # per-lane matrix products and scalings of one column or of K columns
    mv = _mv if vec else (lambda A, X: A @ X)
    mtv = _mtv if vec else (lambda A, X: A.mT @ X)
    lane = (lambda a: a[:, None]) if vec else (lambda a: a[:, None, None])
    rx = rhs[:, :n]
    req = rhs[:, n : n + me]
    rcone = rhs[:, n + me :]
    ceq = _ceq(fact.rho, fact.eps_p, fact.eps_d)
    rhs_x = rx
    if me > 0:
        rhs_x = rhs_x + mtv(fact.gx, req / lane(ceq))
    if mc > 0:
        t3 = cones.c_block_solve(layout, fact.s, fact.t, fact.eps_p, fact.eps_d, rcone)
        rhs_x = rhs_x + mtv(fact.hx, t3)
    if method in STRUCTURED:
        if vec and method == "riccati":
            dx = structure.from_blocks(rc.solve(fact.L, fact.M, structure.to_blocks(rhs_x)))
        else:
            cols = _banded_solve_multi(structure, _block_solver(fact), rhs_x[..., None] if vec else rhs_x)
            dx = cols[..., 0] if vec else cols
        dx = _apply_border(fact, structure, dx)
    else:
        dx = rc.chol_solve(fact.L, rhs_x.contiguous())
    dy = (mv(fact.gx, dx) - req) / lane(ceq) if me > 0 else req
    if mc > 0:
        dz = cones.c_block_solve(
            layout, fact.s, fact.t, fact.eps_p, fact.eps_d, mv(fact.hx, dx) - rcone
        )
    else:
        dz = rcone
    return torch.cat([dx, dy, dz], dim=1)


def solve_with(
    layout, fact: Factorization, res: Blocks, n, me, mc, method="schur", structure=None
) -> Blocks:
    """Condense -> factorized solve -> expand, for a 6-block RHS."""
    s, t, rho = fact.s, fact.t, fact.rho
    rhs = condensed_rhs(layout, res, s, t, rho, fact.eps_p, fact.eps_d)
    d_sym = solve_sym(layout, fact, rhs, n, me, mc, method, structure)
    return expand(layout, res, d_sym, n, me, mc, s, t, rho, fact.eps_p, fact.eps_d)
