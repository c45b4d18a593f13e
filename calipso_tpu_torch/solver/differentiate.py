"""Implicit differentiation of the solution: dw*/dtheta = -J^-1 dR/dtheta,
batch-first.

The counterpart of `calipso_tpu/solver/differentiate.py`. At the
converged point of every lane the condensed system is factored again with
the regularization of the last step, and the p parameter columns of
dR/dtheta go through it as one K = p right-hand-side solve
(`kkt.solve_sym`); the slack rows' expansion takes the p columns as one
batched arrow solve.

dR/dtheta rows (zero for the slack rows r, s, t):
  variables:      fxt + d/dtheta grad_x(g'y) + d/dtheta grad_x(h'z)
  equality dual:  gt
  cone dual:      ht
The "lu" backend solves the full 6-block system densely instead.

Two departures from the reference, both where its answer is not usable:
- a lane whose factor at the last-used regularization has the wrong
  inertia at the converged point (the point moved after that
  factorization; the reference's sensitivity is NaN there) raises its
  primal regularization along the solve's ladder until the inertia is
  right, as a step from that point would (in float32 the refinement
  below then solves the system at the last-used regularization, the
  ladder's factor its preconditioner);
- in float32, with `Options.iterative_refinement`, the columns are
  refined on the exact 6-block operator, as the solve refines its steps
  (the same tolerance and trip limit), keeping a lane's unrefined
  columns where refinement does not improve them. The condensed system
  carries 1/c_eq ~ rho = 1e5 at a converged point, so a float32 solve
  through it keeps ~2 digits and, on an ill-conditioned lane, none. In
  float64 the unrefined columns are the reference's: they meet the
  refinement tolerance but on ldl with second-order cones, whose
  condensed cone block is symmetrized (there the reference's answer is
  ~1e-6 off the exact one, and so is the port's; refining would move
  the port off the reference).
Every lane's sensitivity comes with an estimate of its relative error
(`Sensitivity.error`): the largest entry of one more correction (the
columns' residual on the 6-block operator through the same
factorization) over the columns' largest entry. A lane whose system is
too ill-conditioned for its dtype shows it there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from calipso_tpu_torch.ops import cones
from calipso_tpu_torch.solver import kkt
from calipso_tpu_torch.solver.solve import _set_matmul_precision, resolve_options, select
from calipso_tpu_torch.utils.norms import inf_norm


class Sensitivity(NamedTuple):
    """`sensitivity`'s result, every tensor lane-first."""

    value: torch.Tensor  # (B, total, p)
    error: torch.Tensor  # (B,) estimated relative error of each lane's value
    ladder: torch.Tensor  # (B,) bool: the factor at the solution took the inertia ladder
    refine_trips: int


def solution_sensitivity(fns, layout, opts, state, theta):
    """(B, total, p) sensitivity of w = (x, r, s, y, z, t) to theta at each
    lane's point in `state` (zeros when the problem has no parameters).
    theta is (B, p). Lanes that did not converge get the sensitivity of
    the point they stopped at (NaN where its factor fails)."""
    return sensitivity(fns, layout, opts, state, theta).value


def sensitivity(fns, layout, opts, state, theta) -> Sensitivity:
    """`solution_sensitivity` with its per-lane error estimate, the lanes
    that took the inertia ladder and the refinement trips."""
    dims = fns.dims
    x = state.p.x
    B = x.shape[0]
    if dims.parameters == 0:
        no = torch.zeros(B, dtype=torch.bool, device=x.device)
        return Sensitivity(x.new_zeros((B, dims.total, 0)), x.new_zeros(B), no, 0)
    opts = resolve_options(opts, fns)
    _set_matmul_precision(opts.matmul_precision)
    # the oracles' backward passes on the calling thread, as in the solve
    with torch.autograd.set_multithreading_enabled(False), torch.enable_grad():
        return _sensitivity(fns, layout, opts, state, theta.detach().to(dtype=x.dtype, device=x.device))


def _sensitivity(fns, layout, opts, state, theta):
    dims = fns.dims
    n, me, mc, npar = dims.variables, dims.equality, dims.cone, dims.parameters
    p = state.p
    x, s, t, y, z = p.x, p.s, p.t, p.y, p.z
    rho, eps_p, eps_d = state.rho, state.eps_p_used, state.eps_d_used
    B = x.shape[0]
    method = opts.linear_solver
    structure = getattr(fns, "stage_structure", None)

    # dR/dtheta blocks
    rxt = fns.fxt(x, theta)
    if me > 0:
        rxt = rxt + fns.gty_xt(x, theta, y)
    if mc > 0:
        rxt = rxt + fns.htz_xt(x, theta, z)
    gt = fns.gt(x, theta)
    ht = fns.ht(x, theta)

    zeros = lambda m: x.new_zeros((B, m, npar))
    rhs6 = torch.cat([rxt, zeros(me + mc), gt, ht, zeros(mc)], dim=1)

    gx = fns.gx(x, theta)
    hx = fns.hx(x, theta)
    if method == "lu":
        Hxx = fns.lagrangian_hessian_xx(x, theta, y, z, opts.constraint_tensor)
        J = kkt.full_matrix(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d)
        LU, piv, _ = torch.linalg.lu_factor_ex(J)
        sol = torch.linalg.lu_solve(LU, piv, rhs6)
        corr = torch.linalg.lu_solve(LU, piv, rhs6 - J @ sol)
        no = torch.zeros(B, dtype=torch.bool, device=x.device)
        return Sensitivity(-sol, _relative(corr, sol), no, 0)

    # refactorize at the solution with the last-used regularization; the
    # structured backends read the Hessian's stage blocks, as in the solve
    block_maps = getattr(fns, "_block_maps", None)
    if method in kkt.STRUCTURED and block_maps is not None and block_maps() is not None:
        D, O, Hgen = fns.lagrangian_hessian_blocks(x, theta, y, z, opts.constraint_tensor)
        Hxx = kkt.BandHessian(D, O, Hgen, structure)
    else:
        Hxx = fns.lagrangian_hessian_xx(x, theta, y, z, opts.constraint_tensor)
    fact, ladder = _factor_at_solution(layout, opts, Hxx, gx, hx, s, t, rho, eps_p, eps_d, method, structure)

    # condensed right-hand side: the slack rows are zero, so their
    # corrections vanish and it is [rxt; gt; ht], p columns
    rhs = torch.cat([rxt, gt, ht], dim=1)
    d_sym = kkt.solve_sym(layout, fact, rhs, n, me, mc, method, structure)
    dx, dy, dz = d_sym[:, :n], d_sym[:, n : n + me], d_sym[:, n + me :]

    # expansion with zero slack residuals, the p columns at once
    dr = dy / (rho + eps_p)[:, None, None]
    if mc > 0:
        e = layout.target(x.dtype, x.device)
        v = s - eps_d[:, None] * e
        w = t + eps_p[:, None] * v
        cols = dz.mT  # (B, p, m_c)
        ds = cones.arrow_solve(layout, w[:, None], cones.product(layout, v[:, None], cols))
        dt = cones.arrow_solve(layout, v[:, None], -cones.product(layout, t[:, None], ds))
        ds, dt = ds.mT, dt.mT
    else:
        ds = dt = zeros(0)
    d = torch.cat([dx, dr, ds, dy, dz, dt], dim=1)
    trips = opts.max_iterative_refinement if opts.iterative_refinement and x.dtype == torch.float32 else 0
    d, error, taken = _refine(layout, opts, Hxx, fact, eps_p, rhs6, d, (n, me, mc, method, structure), trips)
    return Sensitivity(-d, error, ladder, taken)


def _relative(corr, d):
    """Per lane: the largest entry of corr over that of d (both (B, ...))."""
    big = lambda a: a.abs().flatten(1).amax(dim=1)
    return big(corr) / big(d).clamp(min=torch.finfo(d.dtype).tiny)


def _repeat(tree, K):
    """Every tensor of a factorization (or Hessian) tree with each lane
    repeated K times along the lane axis, lane-major: lane b's K copies
    become lanes b K .. b K + K - 1. What is not a tensor (None, a spike
    factor's mesh) passes through."""
    if isinstance(tree, kkt.BandHessian):
        return kkt.BandHessian(_repeat(tree.D, K), _repeat(tree.O, K), _repeat(tree.Hgen, K), tree.st)
    if isinstance(tree, tuple):
        items = [_repeat(a, K) for a in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree.repeat_interleave(K, dim=0) if isinstance(tree, torch.Tensor) else tree


def _refine(layout, opts, Hxx, fact, eps_p, rhs6, d, dims, trips):
    """Iterative refinement of the K columns d (B, total, K) of J d = rhs6
    on the exact 6-block operator J (`kkt.matvec`) at the last-used
    regularization eps_p (B,) (where the ladder raised a lane's, its
    factor is the preconditioner of the system at eps_p): each column is a
    lane of a (B K)-lane solve through the same factorization, corrected
    until its residual is under `iterative_refinement_tolerance` or after
    `trips` trips, or once no lane halves its residual in a trip; a lane
    keeps its unrefined columns where refinement did not shrink their
    residual. Returns (the columns, each lane's relative error estimate
    (`_relative` of one more correction), the trips taken)."""
    n, me, mc, method, structure = dims
    B, total, K = d.shape
    sizes = [n, me, mc, me, mc, mc]
    flat = lambda a: a.mT.reshape(B * K, total)
    blocks = lambda a: kkt.Blocks(*torch.split(a, sizes, dim=-1))
    per_lane = lambda a: inf_norm(a).reshape(B, K).amax(dim=1)
    Hr, fr, er = _repeat(Hxx, K), _repeat(fact, K), _repeat(eps_p, K)
    rhs = flat(rhs6)

    def residual(col):
        mv = kkt.matvec(layout, Hr, fr.gx, fr.hx, fr.s, fr.t, fr.rho, er, fr.eps_d, blocks(col))
        return rhs - mv.all

    def correction(err):
        return kkt.solve_with(layout, fr, blocks(err), n, me, mc, method, structure).all

    col0 = col = flat(d)
    err0 = err = residual(col)
    en0 = en = prev = per_lane(err)
    taken = 0
    for trip in range(trips):
        # stop when every lane is under the tolerance, or when no lane
        # over it halved its residual in the last trip (float32's floor)
        need = en > opts.iterative_refinement_tolerance
        if trip > 0:
            need = need & (en <= 0.5 * prev)
        if not bool(need.any()):
            break
        taken += 1
        col = col + correction(err)
        err = residual(col)
        prev, en = en, per_lane(err)
    keep = (en >= en0).repeat_interleave(K)[:, None]
    col, err = torch.where(keep, col0, col), torch.where(keep, err0, err)
    unflat = lambda a: a.reshape(B, K, total).mT
    return unflat(col), _relative(unflat(correction(err)), unflat(col)), taken


def _factor_at_solution(layout, opts, Hxx, gx, hx, s, t, rho, eps_p, eps_d, method, structure):
    """The factorization at the converged point with the last-used
    regularization; lanes whose factor has the wrong inertia there take
    the inertia ladder's larger eps_p (scaled by
    `scaling_regularization` a trip, up to the dtype-capped
    `max_regularization`; a lane past it keeps its NaN factor). Returns
    (the factorization, the lanes that took the ladder (B,) bool)."""
    mesh = opts.spike_mesh if method == "spike" else None
    fact = kkt.factorize(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d, method, structure, mesh)
    ok = kkt.inertia_ok(fact, structure)
    ladder = ~ok
    if not bool(ladder.any()):
        return fact, ladder
    max_reg = min(opts.max_regularization, float(torch.finfo(eps_p.dtype).max) / 1e3)
    e_p = eps_p
    while True:
        e_p = torch.where(ok, e_p, torch.clamp(e_p, min=opts.primal_regularization_initial) * opts.scaling_regularization)
        live = ~ok & (e_p <= max_reg)
        if not bool(live.any()):
            return fact, ladder
        trial = kkt.factorize(layout, Hxx, gx, hx, s, t, rho, e_p, eps_d, method, structure, mesh)
        fact = select(live, trial, fact)
        ok = ok | (live & kkt.inertia_ok(trial, structure))
