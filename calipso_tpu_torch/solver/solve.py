"""The AL-IPM solve loop, batch-first.

The counterpart of `calipso_tpu/solver/solve.py`. The outer loop updates
the central path kappa, the fraction-to-the-boundary tau and the
augmented Lagrangian (lambda, rho); the inner loop takes
inertia-corrected Newton steps on the 6-block KKT residual, globalized by
a fraction-to-the-boundary cone search and a filter line search.

The reference runs B solves in lockstep by `jax.vmap` over nested
`lax.while_loop`s. Here the state carries the lane axis B explicitly:
every loop is a Python `while` over "any lane still active", each trip
computes on every lane, and a lane that is not active keeps its old
values through `torch.where(active, new, old)`. Each lane therefore
follows exactly the iteration it would follow alone. Every nested loop
(inertia ladder, refinement, line searches) runs only for the lanes that
take a step, so a finished lane never extends another lane's loop. Each
"any lane active" test is one device-to-host sync; `stats["host_syncs"]`
counts them per solve.

Failures (inertia-ladder overflow, cone line-search overflow) are status
flags in the state, not exceptions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from calipso_tpu_torch.ops import cones
from calipso_tpu_torch.solver import kkt
from calipso_tpu_torch.solver.kkt import Blocks
from calipso_tpu_torch.utils.norms import inf_norm, norm_p, one_norm

BIG = 1.0e8  # empty-filter sentinel


def _refuse_unported(opts):
    """Raise for options whose code path the port does not have yet."""
    if opts.differentiate:
        raise NotImplementedError(
            "differentiate=True: implicit differentiation is ROADMAP Queue 1 item 18"
        )
    if opts.spike_mesh is not None:
        raise NotImplementedError(
            "spike_mesh: horizon sharding is ROADMAP Queue 1 item 19"
        )
    if opts.line_search_mode not in ("auto", "serial", "parallel"):
        raise ValueError(f"unknown line_search_mode {opts.line_search_mode!r}")


def resolve_options(opts, fns, device=None):
    """Resolve linear_solver='auto' as the reference does (riccati for a
    trajopt problem with more than 96 variables, else schur) and, given
    the device the solve runs on, line_search_mode='auto' ("parallel" on
    CUDA, "serial" on the CPU). The 96 crossover was measured on a TPU
    and is kept for parity (ROADMAP keeps its re-measurement open)."""
    _refuse_unported(opts)
    if opts.line_search_mode == "auto" and device is not None:
        mode = "parallel" if torch.device(device).type == "cuda" else "serial"
        opts = opts.replace(line_search_mode=mode)
    structure = getattr(fns, "stage_structure", None)
    if opts.linear_solver == "auto":
        big = structure is not None and fns.dims.variables > 96
        opts = opts.replace(linear_solver="riccati" if big else "schur")
    kkt.check_method(opts.linear_solver, structure)
    return opts


class State(NamedTuple):
    """Solver state; every field carries the lane axis B first."""

    p: Blocks  # current primal-dual iterate (x, r, s, y, z, t)
    kappa: torch.Tensor  # central path
    tau: torch.Tensor  # fraction to boundary
    rho: torch.Tensor  # AL penalty
    lam: torch.Tensor  # AL dual estimate (B, m_e)
    eps_p_last: torch.Tensor  # regularization warm start
    eps_p_used: torch.Tensor  # regularization of the last factorization
    eps_d_used: torch.Tensor
    filt: torch.Tensor  # (B, F, 2) filter pairs (violation, merit)
    nfilt: torch.Tensor  # filter count
    solved: torch.Tensor
    failed: torch.Tensor
    inner_done: torch.Tensor
    outer_i: torch.Tensor
    inner_i: torch.Tensor
    total_i: torch.Tensor
    # diagnostics of the last evaluated point
    residual_violation: torch.Tensor
    optimality_violation: torch.Tensor
    slack_violation: torch.Tensor
    equality_violation: torch.Tensor
    cone_product_violation: torch.Tensor
    step_size: torch.Tensor
    # steps that escalated to the full-system LU after refinement failed
    # (Options.refinement_fallback)
    num_fallbacks: torch.Tensor
    # cost-accounting counters: inertia-ladder re-factorizations,
    # refinement correction trips and line-search chunk evaluations
    num_ladder: torch.Tensor
    num_refine: torch.Tensor
    num_ls_chunks: torch.Tensor


def _where(mask, a, b):
    """torch.where with a (B,) lane mask broadcast over a's trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)


def select(mask, new, old):
    """Lane-wise choice between two states, Blocks or nested tuples of
    tensors (None stays None): new where mask."""
    if new is None:
        return None
    if type(new) is tuple:
        return tuple(select(mask, a, b) for a, b in zip(new, old))
    if isinstance(new, tuple):
        return type(new)(*(select(mask, a, b) for a, b in zip(new, old)))
    return _where(mask, new, old)


# ---- filter -----------------------------------------------------------------


def filter_check(cv, merit, filt):
    """Acceptable to the filter iff for every pair: cv < f1 or merit < f2.
    cv and merit are (B,) or (B, K) candidates; filt is (B, F, 2)."""
    f1, f2 = filt[..., 0], filt[..., 1]
    if cv.dim() == 2:
        f1, f2 = f1[:, None, :], f2[:, None, :]
    return ((cv[..., None] < f1) | (merit[..., None] < f2)).all(dim=-1)


def filter_augment(filt, nfilt, cv, merit):
    """Add (cv, merit) with dominance pruning; dominated entries are
    overwritten with the vacuous sentinel instead of compacted."""
    passes = filter_check(cv, merit, filt)
    dominated = (filt[..., 0] >= cv[:, None]) & (filt[..., 1] >= merit[:, None])
    pruned = torch.where(dominated[..., None], torch.full_like(filt, BIG), filt)
    idx = torch.clamp(nfilt, max=filt.shape[1] - 1).long()
    pair = torch.stack([cv, merit], dim=-1)[:, None, :]
    added = pruned.scatter(1, idx[:, None, None].expand(-1, 1, 2), pair)
    return _where(passes, added, filt), torch.where(passes, nfilt + 1, nfilt)


# ---- line-search predicates -------------------------------------------------


def switching_condition(step_size, dgrad, merit_exp, violation, violation_exp):
    return (dgrad < 0.0) & (step_size * (-dgrad) ** merit_exp > violation**violation_exp)


def armijo(merit, merit_cand, dgrad, step_size, tol, mach_tol):
    return merit_cand - merit - 10.0 * mach_tol * merit.abs() <= tol * step_size * dgrad


def sufficient_progress(v, v_cand, m, m_cand, v_tol, m_tol, mach_tol):
    return (v_cand - 10.0 * mach_tol * v.abs() <= (1.0 - v_tol) * v) | (
        m_cand - 10.0 * mach_tol * m.abs() <= m - m_tol * v
    )


def _set_matmul_precision(precision):
    """'highest' (or 'float32') keeps float32 products out of TF32."""
    tf32 = precision not in ("highest", "float32")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _row_printer(j, i, r, o, sl, e, c, k, p, a, ep, ed):
    print(
        f"outer {int(j)} inner {int(i)} | res {float(r):.2e} opt {float(o):.2e} "
        f"slack {float(sl):.2e} eq {float(e):.2e} comp {float(c):.2e} | "
        f"kappa {float(k):.1e} rho {float(p):.1e} alpha {float(a):.1e} "
        f"ep {float(ep):.1e} ed {float(ed):.1e}"
    )


# ---- solver construction ----------------------------------------------------


def make_solve(fns, layout, opts, callbacks=None):
    """Build solve(x0 (B, n), theta (B, p) or None, warm) -> State for a
    fixed problem. callbacks is an optional (inner, outer) pair of host
    functions receiving a dict of per-lane tensors after each step /
    outer update. The returned function carries `stats`, a dict whose
    "host_syncs" is the number of loop tests of the last solve."""
    cb_inner, cb_outer = callbacks if callbacks is not None else (None, None)
    dims = fns.dims
    n, me, mc, npar = dims.variables, dims.equality, dims.cone, dims.parameters
    ntot = dims.total
    opts = resolve_options(opts, fns)
    # "lu" runs the inertia ladder and its condensed solves on schur; its
    # steps come from the full-system LU (do_step)
    method = "schur" if opts.linear_solver == "lu" else opts.linear_solver
    structure = getattr(fns, "stage_structure", None)
    # the riccati and cr backends read the Hessian as stage blocks straight
    # from the structured oracles, never as a dense (n, n) matrix
    block_maps = getattr(fns, "_block_maps", None)
    use_band_hessian = method in kkt.STRUCTURED and block_maps is not None and block_maps() is not None
    stats = {"host_syncs": 0}

    def any_lane(mask):
        stats["host_syncs"] += 1
        return bool(mask.any())

    def merit_value(f, r, barrier_val, kappa, lam, rho):
        """AL + barrier merit M = f + lam'r + rho/2 |r|^2 - kappa*Phi."""
        m = f - kappa * barrier_val
        if me > 0:
            m = m + (lam * r).sum(dim=-1) + 0.5 * rho * (r * r).sum(dim=-1)
        return m

    def constraint_violation(g, r, h, s, p_norm):
        """theta = |(g - r; h - s)|_p / (m_e + m_c), per lane."""
        if me + mc == 0:
            return g.new_zeros(g.shape[:-1])
        c = torch.cat([g - r, h - s], dim=-1)
        return norm_p(c, p_norm) / (me + mc)

    def optimality_error(p, res):
        """Ipopt-style scaled optimality error, per lane."""
        if me + mc > 0:
            sd = torch.clamp((one_norm(p.y) + one_norm(p.z)) / (me + mc), min=100.0) / 100.0
        else:
            sd = 1.0
        sc = torch.clamp(one_norm(p.t) / mc, min=100.0) / 100.0 if mc > 0 else 1.0
        return torch.stack(
            [
                inf_norm(res.primals) / sd,
                inf_norm(res.y),
                inf_norm(res.z),
                inf_norm(res.t) / sc,
            ],
            dim=-1,
        ).amax(dim=-1)

    def evaluate_residual(p, theta, kappa, rho, lam):
        x, y, z = p.x, p.y, p.z
        fx = fns.fx(x, theta)
        gty = fns.gty_x(x, theta, y) if me > 0 else torch.zeros_like(x)
        htz = fns.htz_x(x, theta, z) if mc > 0 else torch.zeros_like(x)
        g = fns.g(x, theta)
        h = fns.h(x, theta)
        sot = cones.product(layout, p.s, p.t)
        e = layout.target(x.dtype, x.device)
        res = kkt.residual(fx, gty, htz, g, h, sot, e, p, kappa, rho, lam)
        return res, fx, g, h, sot

    def factorize(Hxx, gx, hx, s, t, rho, e_p, e_d):
        return kkt.factorize(layout, Hxx, gx, hx, s, t, rho, e_p, e_d, method, structure)

    def solve_with(fact, res):
        return kkt.solve_with(layout, fact, res, n, me, mc, method, structure)

    # ---- inertia correction ---------------------------------------------

    def inertia_correction(lanes, Hxx, gx, hx, s, t, rho, kappa, eps_p_last):
        dtype = kappa.dtype
        # cap the ladder limit to the dtype range (1e40 overflows f32)
        max_reg = min(opts.max_regularization, float(torch.finfo(dtype).max) / 1e3)
        e_p0 = torch.full_like(kappa, opts.primal_regularization_initial)
        e_d0 = torch.full_like(kappa, opts.dual_regularization_initial)
        fact0 = factorize(Hxx, gx, hx, s, t, rho, e_p0, e_d0)
        ok0 = kkt.inertia_ok(fact0, structure)
        # the pieces of a factorization that vary (the factors and the
        # border; None where the backend has none)
        varying = lambda f: (f.L, f.M, f.Wg, f.Lc, f.dc, f.d, f.cr)

        # rank deficiency -> dual regularization scaled by kappa
        zero0 = kkt.num_zero_eigs(fact0, method, structure)
        e_d1 = torch.where(
            zero0 != 0,
            opts.dual_regularization * kappa**opts.dual_regularization_exponent,
            e_d0,
        )
        # primal regularization warm start from the last accepted value
        e_p1 = torch.where(
            eps_p_last == 0.0,
            e_p0,
            torch.clamp(opts.scaling_regularization_last * eps_p_last, min=opts.min_regularization),
        )
        scale = torch.where(
            eps_p_last == 0.0,
            torch.full_like(kappa, opts.scaling_regularization_initial),
            torch.full_like(kappa, opts.scaling_regularization),
        )

        # the ladder carries them lane by lane
        core = varying(fact0)
        e_p_fact, e_d_fact = e_p0, e_d0
        e_p, done = e_p1, ok0
        failed = torch.zeros_like(ok0)
        trips = torch.zeros_like(zero0)
        while True:
            act = lanes & ~done & ~failed
            if not any_lane(act):
                break
            fact = factorize(Hxx, gx, hx, s, t, rho, e_p, e_d1)
            ok = kkt.inertia_ok(fact, structure)
            e_p_next = torch.where(ok, e_p, e_p * scale)
            fail_now = ~ok & (e_p_next > max_reg)
            core = select(act, varying(fact), core)
            e_p_fact = torch.where(act, e_p, e_p_fact)
            e_d_fact = torch.where(act, e_d1, e_d_fact)
            e_p = torch.where(act, e_p_next, e_p)
            done = torch.where(act, ok, done)
            failed = torch.where(act, fail_now, failed)
            trips = trips + act.to(trips.dtype)
        L, M, Wg, Lc, dc, dvec, cr = core
        fact = kkt.Factorization(L, M, gx, hx, s, t, rho, e_p_fact, e_d_fact, Wg, Lc, dc, dvec, cr)
        # the warm start moves only when the ladder ran
        eps_p_last_new = torch.where(ok0, eps_p_last, e_p_fact)
        return fact, failed, eps_p_last_new, trips

    # ---- iterative refinement --------------------------------------------

    def refine(lanes, step, res, Hxx, gx, hx, fact, s, t, rho):
        """Refine a search direction on the exact (matrix-free) 6-block
        operator; with `refinement_fallback`, escalate a lane whose refined
        step failed to the full-system LU step. Returns (step, fell_back,
        trips)."""

        def err_of(stp):
            mv = kkt.matvec(layout, Hxx, gx, hx, s, t, rho, fact.eps_p, fact.eps_d, stp)
            return Blocks(*(a - b for a, b in zip(res, mv)))

        err0 = err_of(step)
        en0 = inf_norm(err0.all)
        stp, err, en = step, err0, en0
        i = torch.zeros(en.shape, dtype=torch.int32, device=en.device)
        done = torch.zeros_like(lanes)
        while True:
            act = lanes & ~done & (i <= opts.max_iterative_refinement)
            if not any_lane(act):
                break
            done_now = (en <= opts.iterative_refinement_tolerance) & (
                i >= opts.min_iterative_refinement
            )
            corr = solve_with(fact, err)
            stp2 = select(done_now, stp, Blocks(*(a + b for a, b in zip(stp, corr))))
            err2 = err_of(stp2)
            en2 = torch.where(done_now, en, inf_norm(err2.all))
            err2 = select(done_now, err, err2)
            stp = select(act, stp2, stp)
            err = select(act, err2, err)
            en = torch.where(act, en2, en)
            i = torch.where(act, i + (~done_now).to(i.dtype), i)
            done = torch.where(act, done_now, done)
        # never return a step worse than the unrefined one
        ok = en <= torch.clamp(en0, min=opts.iterative_refinement_tolerance)
        best = select(ok, stp, step)
        fell_back = torch.zeros_like(i)
        if not opts.refinement_fallback:
            return best, fell_back, i
        # the reference's escalation: a refined step that solves fewer than
        # ~2 digits of the system relative to the residual scale is
        # replaced by the full-system LU step where that one is measurably
        # better (its lax.cond becomes this lane mask)
        en_best = torch.minimum(en, en0)
        failed = lanes & (en_best > 1.0e-2 * inf_norm(res.all))
        if not any_lane(failed):
            return best, fell_back, i
        lu_step = kkt.lu_solve_full(layout, Hxx, gx, hx, s, t, rho, fact.eps_p, fact.eps_d, res)
        better = failed & (inf_norm(err_of(lu_step).all) < 0.5 * en_best)
        return select(better, lu_step, best), better.to(i.dtype), i

    # ---- fraction-to-the-boundary cone search ----------------------------

    def candidate_alphas(a0, count):
        """(B,) a0 -> (B, count + 1) candidates [a0, a0*c, a0*c^2, ...] by
        cumulative product (exact for the default power-of-two scaling)."""
        facs = torch.full((count + 1,), opts.scaling_line_search, dtype=a0.dtype, device=a0.device)
        facs[0] = 1.0
        return a0[:, None] * torch.cumprod(facs, dim=0)

    def ftb_search(lanes, u, du, tau, parallel):
        one = torch.ones_like(tau)
        if mc == 0:
            return one, torch.zeros_like(lanes)
        if parallel:
            alphas = candidate_alphas(one, opts.max_cone_line_search)  # (B, K+1)
            cand = u[:, None, :] - alphas[..., None] * du[:, None, :]
            viol = cones.violation(layout, cand, u[:, None, :], tau[:, None, None])
            ok = ~viol
            fail = ~ok.any(dim=-1)
            first = torch.gather(alphas, 1, ok.to(torch.int8).argmax(dim=-1, keepdim=True))[:, 0]
            return torch.where(fail, alphas[:, -1], first), fail
        a = one
        viol = cones.violation(layout, u - du, u, tau[:, None])
        k = torch.zeros(tau.shape, dtype=torch.int32, device=tau.device)
        while True:
            act = lanes & viol & (k < opts.max_cone_line_search)
            if not any_lane(act):
                break
            a2 = opts.scaling_line_search * a
            v2 = cones.violation(layout, u - a2[:, None] * du, u, tau[:, None])
            a = torch.where(act, a2, a)
            k = torch.where(act, k + 1, k)
            viol = torch.where(act, v2, viol)
        return a, viol

    # ---- the inner Newton iteration --------------------------------------

    def do_step(st, take, theta, res, fval, fx, g, h, parallel):
        p = st.p
        dtype = p.x.dtype
        B = p.x.shape[0]
        # dtype-aware machine tolerance: 1e-16 is f64 eps; f32 widens it
        mach = max(opts.machine_tolerance, float(torch.finfo(dtype).eps))
        x, r, s, y, z, t = p

        cv = constraint_violation(g, r, h, s, opts.constraint_norm)

        if use_band_hessian:
            D, O, Hgen = fns.lagrangian_hessian_blocks(x, theta, y, z, opts.constraint_tensor)
            Hxx = kkt.BandHessian(D, O, Hgen, structure)
        else:
            Hxx = fns.lagrangian_hessian_xx(x, theta, y, z, opts.constraint_tensor)
        gx = fns.gx(x, theta)
        hx = fns.hx(x, theta)

        fact, ic_failed, eps_p_last, ladder_trips = inertia_correction(
            take, Hxx, gx, hx, s, t, st.rho, st.kappa, st.eps_p_last
        )

        refine_trips = torch.zeros_like(ladder_trips)
        fell_back = torch.zeros_like(ladder_trips)
        if opts.linear_solver == "lu":
            # the exact full-system solve; refinement is unnecessary
            step = kkt.lu_solve_full(layout, Hxx, gx, hx, s, t, st.rho, fact.eps_p, fact.eps_d, res)
        else:
            step = solve_with(fact, res)
            if opts.iterative_refinement:
                step, fell_back, refine_trips = refine(take, step, res, Hxx, gx, hx, fact, s, t, st.rho)

        barrier_val = cones.barrier(layout, s)
        barrier_grad = cones.barrier_gradient(layout, s)
        merit = merit_value(fval, r, barrier_val, st.kappa, st.lam, st.rho)
        merit_grad = torch.cat(
            [fx, st.lam + st.rho[:, None] * r, -st.kappa[:, None] * barrier_grad], dim=-1
        )
        dgrad = (merit_grad * step.primals).sum(dim=-1)

        # cone fraction-to-the-boundary searches; t gets its own step size
        alpha_s, fail_s = ftb_search(take, s, step.s, st.tau, parallel)
        alpha_t, fail_t = ftb_search(take, t, step.t, st.tau, parallel)

        kap_c, rho_c, lam_c = st.kappa[:, None], st.rho[:, None], st.lam[:, None, :]
        cv_c, dgrad_c, merit_c = cv[:, None], dgrad[:, None], merit[:, None]

        def cand_eval(alphas):
            """Merit and violation at the (B, K) candidate steps, with the
            oracles evaluated on one flattened (B*K) batch."""
            K = alphas.shape[1]
            a = alphas[..., None]
            xh = x[:, None] - a * step.x[:, None]
            rh = r[:, None] - a * step.r[:, None]
            sh = s[:, None] - a * step.s[:, None]
            xf = xh.reshape(B * K, n)
            thf = theta[:, None].expand(B, K, npar).reshape(B * K, npar)
            fh = fns.f(xf, thf).reshape(B, K)
            gh = fns.g(xf, thf).reshape(B, K, me)
            hh = fns.h(xf, thf).reshape(B, K, mc)
            mh = merit_value(fh, rh, cones.barrier(layout, sh), kap_c, lam_c, rho_c)
            th = constraint_violation(gh, rh, hh, sh, opts.constraint_norm)
            return mh, th

        def accept_rule(a, mh, th):
            """Filter admissibility AND (switching+Armijo OR sufficient
            progress), elementwise over (B, K) candidates."""
            ok_filter = filter_check(th, mh, st.filt)
            c1 = (
                (cv_c <= opts.slack_tolerance)
                & switching_condition(a, dgrad_c, opts.merit_exponent, cv_c, opts.violation_exponent)
                & armijo(merit_c, mh, dgrad_c, a, opts.armijo_tolerance, mach)
            )
            c2 = sufficient_progress(
                cv_c, th, merit_c, mh, opts.violation_tolerance, opts.merit_tolerance, mach
            )
            return ok_filter & (c1 | c2)

        if parallel:
            # chunks of W candidates alpha * 0.5^k; the next chunk runs
            # only for lanes that accepted none. Selection equals the
            # serial loop's (same candidate floats for power-of-two
            # scaling, same first accepted index, same untested final
            # fallback candidate).
            max_k = opts.max_residual_line_search  # candidates 0..max_k
            W = max(1, min(opts.parallel_line_search_width, max_k + 1))
            num_chunks = -(-(max_k + 1) // W)
            found = torch.zeros_like(take)
            chunk = torch.zeros(B, dtype=torch.int32, device=x.device)
            a_base, alpha = alpha_s, alpha_s
            m_cand = torch.zeros_like(alpha_s)
            t_cand = torch.zeros_like(alpha_s)
            offsets = torch.arange(W, device=x.device)
            while True:
                act = take & ~found & (chunk < num_chunks)
                if not any_lane(act):
                    break
                alphas = candidate_alphas(a_base, W - 1)  # (B, W)
                ms, ths = cand_eval(alphas)
                gidx = chunk[:, None] * W + offsets
                acc = accept_rule(alphas, ms, ths) & (gidx < max_k)
                any_acc = acc.any(dim=-1)
                is_last = chunk == num_chunks - 1
                j_fb = torch.clamp(max_k - chunk * W, 0, W - 1)
                sel = torch.where(any_acc, acc.to(torch.int8).argmax(dim=-1), j_fb.long())
                pick = lambda v: torch.gather(v, 1, sel[:, None])[:, 0]
                tk = act & (any_acc | is_last)
                alpha = torch.where(tk, pick(alphas), alpha)
                m_cand = torch.where(tk, pick(ms), m_cand)
                t_cand = torch.where(tk, pick(ths), t_cand)
                a_base = torch.where(act, alphas[:, -1] * opts.scaling_line_search, a_base)
                found = torch.where(act, any_acc, found)
                chunk = torch.where(act, chunk + 1, chunk)
            ls_chunks = chunk
        else:
            m0, t0 = cand_eval(alpha_s[:, None])
            alpha, m_cand, t_cand = alpha_s, m0[:, 0], t0[:, 0]
            ls_chunks = torch.zeros(B, dtype=torch.int32, device=x.device)
            accepted = torch.zeros_like(take)
            while True:
                act = take & ~accepted & (ls_chunks < opts.max_residual_line_search)
                if not any_lane(act):
                    break
                acc = accept_rule(alpha[:, None], m_cand[:, None], t_cand[:, None])[:, 0]
                a2 = torch.where(acc, alpha, opts.scaling_line_search * alpha)
                m2, t2 = cand_eval(a2[:, None])
                m2 = torch.where(acc, m_cand, m2[:, 0])
                t2 = torch.where(acc, t_cand, t2[:, 0])
                alpha = torch.where(act, a2, alpha)
                m_cand = torch.where(act, m2, m_cand)
                t_cand = torch.where(act, t2, t_cand)
                ls_chunks = torch.where(act, ls_chunks + (~acc).to(ls_chunks.dtype), ls_chunks)
                accepted = torch.where(act, acc, accepted)

        # filter augmentation: add the pre-step pair when the switching or
        # Armijo condition failed at alpha
        sw = switching_condition(alpha, dgrad, opts.merit_exponent, cv, opts.violation_exponent)
        ar = armijo(merit, m_cand, dgrad, alpha, opts.armijo_tolerance, mach)
        filt_a, nfilt_a = filter_augment(
            st.filt, st.nfilt,
            (1.0 - opts.violation_tolerance) * cv,
            merit - opts.merit_tolerance * cv,
        )
        do_aug = ~(sw & ar)
        filt = _where(do_aug, filt_a, st.filt)
        nfilt = torch.where(do_aug, nfilt_a, st.nfilt)

        # accept; duals share the primal alpha, t uses its own step size
        a, at = alpha[:, None], alpha_t[:, None]
        p_new = Blocks(
            x - a * step.x, r - a * step.r, s - a * step.s,
            y - a * step.y, z - a * step.z, t - at * step.t,
        )
        if cb_inner is not None:
            cb_inner(
                dict(
                    inner=st.inner_i, outer=st.outer_i, total=st.total_i,
                    step_size=alpha, merit=merit, violation=cv, active=take,
                )
            )
        new = st._replace(
            p=p_new,
            eps_p_last=eps_p_last,
            eps_p_used=fact.eps_p,
            eps_d_used=fact.eps_d,
            filt=filt,
            nfilt=nfilt,
            failed=st.failed | ic_failed | fail_s | fail_t,
            inner_i=st.inner_i + 1,
            total_i=st.total_i + 1,
            step_size=alpha,
            num_fallbacks=st.num_fallbacks + fell_back,
            num_ladder=st.num_ladder + ladder_trips,
            num_refine=st.num_refine + refine_trips,
            num_ls_chunks=st.num_ls_chunks + ls_chunks,
        )
        return select(take, new, st)

    def inner_body(st, active, theta, parallel):
        res, fx, g, h, sot = evaluate_residual(st.p, theta, st.kappa, st.rho, st.lam)
        fval = fns.f(st.p.x, theta)

        residual_violation = norm_p(res.all, opts.residual_norm) / ntot
        slack_violation = torch.maximum(inf_norm(res.y), inf_norm(res.z))
        equality_violation = inf_norm(g)
        cone_product_violation = inf_norm(sot)
        opt_violation = optimality_error(st.p, res)

        solved = (
            (residual_violation < opts.residual_tolerance)
            & (slack_violation < opts.slack_tolerance)
            & (equality_violation <= opts.equality_tolerance)
            & (cone_product_violation <= opts.complementarity_tolerance)
        )
        inner_done = (~solved) & (
            opt_violation
            <= torch.clamp(
                opts.central_path_update_tolerance * st.kappa, min=opts.optimality_tolerance
            )
        )
        new = st._replace(
            solved=st.solved | solved,
            inner_done=inner_done,
            residual_violation=residual_violation,
            optimality_violation=opt_violation,
            slack_violation=slack_violation,
            equality_violation=equality_violation,
            cone_product_violation=cone_product_violation,
        )
        st = select(active, new, st)
        if opts.verbose and st.total_i.shape[0] == 1 and int(st.total_i[0]) % opts.print_frequency == 0:
            _row_printer(
                st.outer_i[0], st.inner_i[0], st.residual_violation[0],
                st.optimality_violation[0], st.slack_violation[0],
                st.equality_violation[0], st.cone_product_violation[0],
                st.kappa[0], st.rho[0], st.step_size[0],
                st.eps_p_used[0], st.eps_d_used[0],
            )
        take = active & ~(st.solved | st.inner_done | st.failed)
        if not any_lane(take):
            return st
        return do_step(st, take, theta, res, fval, fx, g, h, parallel)

    def outer_update(st, active_outer):
        active = active_outer & ~(st.solved | st.failed)
        kappa_n = torch.clamp(
            torch.minimum(
                opts.central_path_scaling * st.kappa, st.kappa**opts.central_path_exponent
            ),
            min=opts.residual_tolerance / 10.0,
        )
        tau_n = torch.clamp(1.0 - kappa_n, min=0.99)
        lam_n = st.lam + st.rho[:, None] * st.p.r
        rho_n = torch.clamp(
            torch.maximum(opts.penalty_scaling * st.rho, 1.0 / kappa_n), max=opts.max_penalty
        )
        if cb_outer is not None:
            cb_outer(
                dict(
                    outer=st.outer_i, kappa=kappa_n, rho=rho_n,
                    solved=st.solved, active=active,
                )
            )
        return st._replace(
            kappa=torch.where(active, kappa_n, st.kappa),
            tau=torch.where(active, tau_n, st.tau),
            lam=_where(active, lam_n, st.lam),
            rho=torch.where(active, rho_n, st.rho),
            filt=_where(active, torch.full_like(st.filt, BIG), st.filt),
            nfilt=torch.where(active, torch.zeros_like(st.nfilt), st.nfilt),
            outer_i=st.outer_i + active_outer.to(st.outer_i.dtype),
        )

    def init_state(x0, theta, warm: Optional[Blocks] = None) -> State:
        B, dtype, dev = x0.shape[0], x0.dtype, x0.device
        if opts.warmstart and warm is not None:
            p = warm
        else:
            g0 = fns.g(x0, theta)
            init = layout.initialize(dtype, dev).expand(B, mc)
            p = Blocks(
                x0, g0, init,
                x0.new_zeros((B, me)), x0.new_zeros((B, mc)), init,
            )
        full = lambda v: torch.full((B,), v, dtype=dtype, device=dev)
        i0 = torch.zeros(B, dtype=torch.int32, device=dev)
        f0 = torch.zeros(B, dtype=torch.bool, device=dev)
        kappa = full(opts.central_path_initial)
        return State(
            p=p,
            kappa=kappa,
            tau=torch.clamp(1.0 - kappa, min=0.99),
            rho=full(opts.penalty_initial),
            lam=torch.full((B, me), opts.dual_initial, dtype=dtype, device=dev),
            eps_p_last=full(0.0),
            eps_p_used=full(opts.primal_regularization_initial),
            eps_d_used=full(opts.dual_regularization_initial),
            filt=torch.full((B, opts.max_filter, 2), BIG, dtype=dtype, device=dev),
            nfilt=i0,
            solved=f0,
            failed=f0,
            inner_done=f0,
            outer_i=i0,
            inner_i=i0,
            total_i=i0,
            residual_violation=full(0.0),
            optimality_violation=full(0.0),
            slack_violation=full(0.0),
            equality_violation=full(0.0),
            cone_product_violation=full(0.0),
            step_size=full(1.0),
            num_fallbacks=i0,
            num_ladder=i0,
            num_refine=i0,
            num_ls_chunks=i0,
        )

    def solve(x0, theta=None, warm: Optional[Blocks] = None) -> State:
        if x0.dim() != 2 or x0.shape[1] != n:
            raise ValueError(f"x0 must be (B, {n}), got {tuple(x0.shape)}")
        B = x0.shape[0]
        if theta is None:
            theta = x0.new_zeros((B, npar))
        x0 = x0.detach()
        theta = theta.detach().to(dtype=x0.dtype, device=x0.device)
        if warm is not None:
            warm = Blocks(*(a.detach() for a in warm))
        parallel = resolve_options(opts, fns, x0.device).line_search_mode == "parallel"
        stats["host_syncs"] = 0
        _set_matmul_precision(opts.matmul_precision)
        # the oracles' backward passes run on this thread, from one ready
        # queue in the graph's own order. With the device's worker thread
        # the order in which a backward's nodes ran, and so the order in
        # which gradients were summed, depended on what the process had
        # run before: the first batch after another solve ran the same ops
        # in another order and came out with other bits
        with torch.autograd.set_multithreading_enabled(False):
            return _solve(x0, theta, warm, parallel)

    def _solve(x0, theta, warm, parallel):
        # no torch.no_grad() here: under it, vmap(jacrev(.)) returns wrong
        # derivatives through torch.linalg.solve (torch 2.13); the inputs
        # are detached instead, so no autograd graph is built
        st = init_state(x0, theta, warm)
        while True:
            outer = (st.outer_i < opts.max_outer_iterations) & ~(st.solved | st.failed)
            if not any_lane(outer):
                break
            st = st._replace(
                inner_done=st.inner_done & ~outer,
                inner_i=torch.where(outer, torch.zeros_like(st.inner_i), st.inner_i),
            )
            while True:
                inner = (
                    outer
                    & (st.inner_i < opts.max_residual_iterations)
                    & ~(st.solved | st.failed | st.inner_done)
                )
                if not any_lane(inner):
                    break
                st = inner_body(st, inner, theta, parallel)
            st = outer_update(st, outer)
        return st

    solve.stats = stats
    return solve
