"""Implicit differentiation in the port against the JAX package, on the
CPU in float64.

- The five theta-derivatives of the oracles (fxt, gt, ht, gty_xt,
  htz_xt), called inside `torch.no_grad()`, against the reference's at
  seeded points: the structured trajopt oracles on the parametric
  pendulum, the double integrator, the cart-pole tuning problem and a
  double integrator with a parametric second-order cone per stage; the
  dense `ProblemFunctions` on a parametric SOC problem and a flat
  (`structured=False`) transcription.
- `solution_sensitivity` on schur, ldl, lu, riccati and cr from the
  reference's own converged state, handed across with
  `utils/convert.state_from_numpy`: the same sensitivity to 1e-9
  relative (the acceptance bound is 1e-7).
- The reference's own sensitivity cases in the port: the QP with a known
  sensitivity (`tests/test_backends.py`), the equality QP against its
  dense implicit-function oracle (`tests/test_solver_nlp.py`) and the
  double integrator against the trajopt Lagrangian's
  (`tests/test_examples.py`), each with the reference test's tolerance,
  and each against the JAX package's sensitivity from its own solve.
- `make_differentiable_solve`: `backward` equals sens' w_bar and the
  gradient of a scalar loss of the solution equals `jax.grad` of the
  same loss through the reference's custom-VJP solve.

The JAX side runs its sensitivity eagerly (no jit): a compile per
backend would cost more than the calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import calipso_tpu
import calipso_tpu_torch
from calipso_tpu.solver import differentiate as jdiff
from calipso_tpu.solver.diffable import make_differentiable_solve as jmake
from calipso_tpu_torch.solver import differentiate as tdiff
from calipso_tpu_torch.solver.diffable import make_differentiable_solve as tmake
from calipso_tpu_torch.utils.convert import options_from_jax, state_from_numpy
from tests.test_solver_nlp import _qp_problem, assert_contract

# Tier-1 runs several pytest workers on few CPUs: one torch thread each
torch.set_num_threads(1)

ORACLE_RTOL = 1e-10  # the same float64 derivatives, up to summation order
SENS_RTOL = 1e-9  # the same state through the same formulas
SOLVE_SENS_RTOL = 1e-7  # each package's sensitivity from its own solve
POINTS = 3
ERROR_ESTIMATE_FACTOR = 10.0  # a float32 sensitivity's error estimate against its error
METHODS = ("schur", "ldl", "lu", "riccati", "cr")
ORACLES = ("fxt", "gt", "ht", "gty_xt", "htz_xt")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max(initial=0.0) / max(np.abs(want).max(initial=0.0), 1e-300))


# ---- the problems, built in both packages -----------------------------------


def _pendulum(pkg):
    if pkg == "jax":
        from calipso_tpu.models import pendulum
    else:
        from calipso_tpu_torch.models import pendulum
    return pendulum.swingup_problem(11, parametric_initial_state=True)


def _double_integrator(pkg):
    if pkg == "jax":
        from calipso_tpu.models import double_integrator
    else:
        from calipso_tpu_torch.models import double_integrator
    return double_integrator.problem(horizon=5)


def _di_cone(pkg):
    """The double integrator with a parametric second-order cone at every
    stage but the last, [w_7 + 2, x_1 w_8, u_1] in Q^3, inactive at the
    solution's neighbourhood but with duals, so ht and htz_xt are not
    empty."""
    prob = _double_integrator(pkg)
    stack = jnp.array if pkg == "jax" else torch.stack
    cone = lambda x, u, w: stack([w[6] + 2.0, x[0] * w[7], u[0]])
    prob["second_order"] = [[cone]] * (len(prob["num_states"]) - 1) + [[]]
    return prob


def _cartpole_tuning(pkg):
    """The cart-pole MPC of `tests/test_autotuning.py:test_cartpole_mpc_
    autotuning` (T=4, weights and the measured state as parameters)."""
    T = 4
    if pkg == "jax":
        from calipso_tpu.models import cartpole
    else:
        from calipso_tpu_torch.models import cartpole

    def stage_cost(x, u, w):
        return 0.5 * x @ (w[:4] * x) + 0.05 * (u @ u)

    def final_cost(x, u, w):
        return 0.5 * x @ (w[:4] * x)

    return dict(
        objective=[lambda x, u, w: 0.5 * x @ (w[:4] * x) + 0.05 * (u @ u), *[stage_cost] * (T - 2), final_cost],
        dynamics=[cartpole.discrete] * (T - 1),
        num_states=[4] * T,
        num_actions=[1] * (T - 1),
        equality=[lambda x, u, w: x - w[4:8], *[None] * (T - 1)],
        parameters=[np.concatenate([np.ones(4), np.zeros(4)])] + [np.ones(4)] * (T - 2) + [10.0 * np.ones(4)],
        state_guess=[np.zeros(4)] * T,
    )


TRAJOPT = {
    "pendulum": _pendulum,
    "double_integrator": _double_integrator,
    "di_cone": _di_cone,
    "cartpole_tuning": _cartpole_tuning,
}
GUESS_KEYS = ("state_guess", "state_initial", "state_goal")


def _trajopt(pkg, name, options, structured=True):
    prob = TRAJOPT[name](pkg)
    kw = {k: v for k, v in prob.items() if k not in GUESS_KEYS}
    if pkg == "jax":
        ts = calipso_tpu.TrajOptSolver(options=options, structured=structured, **kw)
    else:
        ts = calipso_tpu_torch.TrajOptSolver(
            options=options_from_jax(options), structured=structured, device="cpu", **kw
        )
    ts.initialize_states(prob["state_guess"])
    return ts, np.concatenate([np.asarray(p, float).reshape(-1) for p in prob["parameters"]])


def _soc_problem(pkg):
    """A parametric SOC problem for `Solver` (the dense oracles): every
    constraint and the objective depend on theta, nonlinearly in x."""
    if pkg == "jax":
        vec, sin, Solver = jnp.array, jnp.sin, calipso_tpu.Solver
        extra = {}
    else:
        vec, sin, Solver = torch.stack, torch.sin, calipso_tpu_torch.Solver
        extra = dict(device="cpu")
    f = lambda x, th: th[0] * x @ x + th[1] * x[0] + 0.1 * sin(x[1] * th[2])
    g = lambda x, th: vec([x[0] + th[2] * x[1] ** 2 - 1.0])
    h = lambda x, th: vec([th[3] + 2.0 + x[2], th[3] * x[0], sin(x[1]) * th[0], x[2] - th[1]])
    theta = np.array([1.0, 0.5, 0.3, 0.7])
    solver = Solver(
        f, g, h, 3, parameters=theta, nonnegative_indices=[3], second_order_indices=[[0, 1, 2]],
        options=(calipso_tpu.Options() if pkg == "jax" else calipso_tpu_torch.Options()), **extra,
    )
    return solver, theta


# ---- theta-derivatives of the oracles ----------------------------------------


def _points(rng, fns, theta):
    d = fns.dims
    return (
        rng.normal(size=(POINTS, d.variables)),
        theta[None] + 0.1 * rng.normal(size=(POINTS, d.parameters)),
        rng.normal(size=(POINTS, d.equality)),
        rng.normal(size=(POINTS, d.cone)),
    )


def _oracle_pair(jfns, tfns, rng, theta):
    """{oracle: (JAX lane by lane (POINTS, ...), port batched, called
    inside torch.no_grad())}."""
    x, th, y, z = _points(rng, jfns, theta)
    args = {
        "fxt": lambda i: (x[i], th[i]), "gt": lambda i: (x[i], th[i]), "ht": lambda i: (x[i], th[i]),
        "gty_xt": lambda i: (x[i], th[i], y[i]), "htz_xt": lambda i: (x[i], th[i], z[i]),
    }
    out = {}
    with torch.no_grad():
        for name in ORACLES:
            jv = np.stack([np.asarray(getattr(jfns, name)(*map(jnp.asarray, args[name](i)))) for i in range(POINTS)])
            batched = [np.stack(a) for a in zip(*(args[name](i) for i in range(POINTS)))]
            tv = getattr(tfns, name)(*(torch.tensor(a) for a in batched))
            out[name] = jv, tv.numpy()
    return out


@pytest.mark.parametrize("name", list(TRAJOPT) + ["pendulum_flat", "soc_dense"])
def test_theta_derivatives_match_jax(name):
    """Every theta-derivative oracle of the structured (and the flat and
    dense) oracles, (B, n, p), (B, m_e, p) and (B, m_c, p), inside
    torch.no_grad(), against the reference's."""
    rng = np.random.default_rng(len(name))
    if name == "soc_dense":
        (js, theta), (ts, _) = _soc_problem("jax"), _soc_problem("torch")
        jfns, tfns = js.fns, ts.fns
    else:
        flat = name.endswith("_flat")
        base = name[: -len("_flat")] if flat else name
        (jts, theta), (tts, _) = (_trajopt(p, base, calipso_tpu.Options(), not flat) for p in ("jax", "torch"))
        jfns, tfns = jts.solver.fns, tts.solver.fns
    d = tfns.dims
    shapes = {"fxt": d.variables, "gt": d.equality, "ht": d.cone, "gty_xt": d.variables, "htz_xt": d.variables}
    nonzero = set()
    for oracle, (jv, tv) in _oracle_pair(jfns, tfns, rng, theta).items():
        assert tv.shape == (POINTS, shapes[oracle], d.parameters), (oracle, tv.shape)
        assert _rel(tv, jv) <= ORACLE_RTOL, (oracle, _rel(tv, jv))
        if np.abs(jv).max(initial=0.0) > 0:
            nonzero.add(oracle)
    assert nonzero == NONZERO[name]


# the oracles that are not zero on each problem: theta enters the pendulum
# only through x_1 - w, the double integrator's costs and dynamics too, and
# di_cone's and the SOC problem's cones as well
NONZERO = {
    "pendulum": {"gt"}, "pendulum_flat": {"gt"}, "cartpole_tuning": {"fxt", "gt"},
    "double_integrator": {"fxt", "gt", "gty_xt"}, "di_cone": set(ORACLES), "soc_dense": set(ORACLES),
}


# ---- the sensitivity from the reference's converged state --------------------


TIGHT = dict(residual_tolerance=1e-10, equality_tolerance=1e-8, complementarity_tolerance=1e-8,
             line_search_mode="serial")
CASES = [("pendulum", m) for m in METHODS] + [("di_cone", m) for m in METHODS] + [
    ("double_integrator", "schur"), ("double_integrator", "riccati"), ("cartpole_tuning", "schur"),
]


@pytest.fixture(scope="module")
def converged():
    """{problem: (JAX TrajOptSolver, port TrajOptSolver, theta, JAX result)}
    solved once, on schur, by the reference, to the default contract."""
    out = {}
    for name in TRAJOPT:
        jopts = calipso_tpu.Options(linear_solver="schur", line_search_mode="serial")
        (jts, theta), (tts, _) = (_trajopt(p, name, jopts) for p in ("jax", "torch"))
        res = jts.solve()
        assert bool(res.state.solved), name
        out[name] = jts, tts, theta, res
    return out


@pytest.mark.parametrize("name,method", CASES)
def test_sensitivity_from_the_same_state(converged, name, method):
    """solution_sensitivity on each backend from the reference's own
    converged state: (1, total, p), the reference's to SENS_RTOL."""
    jts, tts, theta, res = converged[name]
    jopts = calipso_tpu.Options(linear_solver=method, line_search_mode="serial")
    want = np.asarray(
        jdiff.solution_sensitivity(jts.solver.fns, jts.solver.layout, jopts, res.state, jnp.asarray(theta))
    )
    st = state_from_numpy(res.state, single=True)
    with torch.no_grad():
        got = tdiff.solution_sensitivity(
            tts.solver.fns, tts.solver.layout, options_from_jax(jopts), st, torch.tensor(theta)[None]
        )
    d = tts.solver.fns.dims
    assert got.shape == (1, d.total, d.parameters)
    assert np.abs(want).max() > 0
    assert _rel(got[0].numpy(), want) <= SENS_RTOL, _rel(got[0].numpy(), want)


def test_sensitivity_is_zero_without_parameters():
    prob = _pendulum("torch")
    prob.pop("parameters")
    prob["equality"][0] = lambda x, u, w: x
    kw = {k: v for k, v in prob.items() if k not in GUESS_KEYS}
    ts = calipso_tpu_torch.TrajOptSolver(
        options=calipso_tpu_torch.Options(differentiate=True, line_search_mode="serial"), device="cpu", **kw
    )
    ts.initialize_states(prob["state_guess"])
    res = ts.solve()
    assert res.sensitivity.shape == (ts.solver.fns.dims.total, 0)


def test_batched_sensitivity_matches_single_solves():
    """A B=3 batch with differentiate=True gives each lane its single
    solve's sensitivity (riccati: the stream sweeps' K columns)."""
    opts = calipso_tpu.Options(linear_solver="riccati", differentiate=True, **TIGHT)
    ts, _ = _trajopt("torch", "pendulum", opts)
    x0s = torch.tensor(0.2 * np.random.default_rng(3).normal(size=(3, 2)))
    thetas = x0s
    res = ts.batched().solve(parameters=thetas)
    assert res.sensitivity.shape == (3, ts.solver.fns.dims.total, 2)
    for i in range(3):
        one = ts.solve(parameters=thetas[i])
        assert int(one.iterations) == int(res.iterations[i])
        np.testing.assert_allclose(res.variables[i].numpy(), one.variables.numpy(), rtol=0, atol=1e-12)
        # at rho = 1e8 the condensed system amplifies the lanes' last-bit
        # differences (the batch's and a single solve's kernels round
        # differently) to ~1e-8 of the sensitivity
        assert _rel(res.sensitivity[i].numpy(), one.sensitivity.numpy()) <= SOLVE_SENS_RTOL


def test_sensitivity_ladder_for_a_factor_with_the_wrong_inertia():
    """A lane whose factor at its last-used regularization is not positive
    definite at the converged point (here lane 1's eps_p made -10: the
    reference's sensitivity is NaN there) takes the inertia ladder and
    gets a finite sensitivity; lane 0 is untouched."""
    opts = calipso_tpu.Options(linear_solver="schur", line_search_mode="serial")
    ts, _ = _trajopt("torch", "pendulum", opts)
    thetas = torch.tensor([[0.1, -0.2], [-0.15, 0.05]], dtype=torch.float64)
    st = ts.batched().solve(parameters=thetas).state
    fns, layout, topts = ts.solver.fns, ts.solver.layout, ts.solver.options
    want = tdiff.sensitivity(fns, layout, topts, st, thetas)
    assert want.ladder.tolist() == [False, False]
    broken = st._replace(eps_p_used=torch.tensor([st.eps_p_used[0].item(), -10.0], dtype=torch.float64))
    got = tdiff.sensitivity(fns, layout, topts, broken, thetas)
    assert got.ladder.tolist() == [False, True]
    assert torch.equal(got.value[0], want.value[0]) and bool(torch.isfinite(got.value[1]).all())


@pytest.mark.parametrize("method", ["schur", "riccati", "cr", "ldl"])
def test_float32_sensitivity_is_refined(method):
    """In float32 the columns are refined on the 6-block operator: a
    float32 sensitivity is within 1e-4 of the float64 one at the same
    point (the condensed solve alone is ~4% off on this pendulum), and
    with refinement off it is the unrefined one. Refined or not, each
    lane's error estimate is within a factor of ERROR_ESTIMATE_FACTOR of
    its error against the float64 sensitivity."""
    opts = calipso_tpu.Options(linear_solver=method, line_search_mode="serial")
    ts, _ = _trajopt("torch", "pendulum", opts)
    thetas = torch.tensor([[0.1, -0.2], [-0.15, 0.05]], dtype=torch.float64)
    st = ts.batched().solve(parameters=thetas).state
    fns, layout, topts = ts.solver.fns, ts.solver.layout, ts.solver.options
    want = tdiff.solution_sensitivity(fns, layout, topts, st, thetas)
    st32 = type(st)(*(type(f)(*(a.float() for a in f)) if isinstance(f, tuple)
                      else (f.float() if f.is_floating_point() else f) for f in st))
    got = tdiff.sensitivity(fns, layout, topts, st32, thetas.float())
    assert got.refine_trips >= 1
    assert _rel(got.value.double().numpy(), want.numpy()) <= 1e-4
    raw = tdiff.sensitivity(fns, layout, topts.replace(iterative_refinement=False), st32, thetas.float())
    assert raw.refine_trips == 0
    assert _rel(raw.value.double().numpy(), want.numpy()) > 10 * _rel(got.value.double().numpy(), want.numpy())
    for sens in (got, raw):
        err = [_rel(sens.value[i].double().numpy(), want[i].numpy()) for i in range(2)]
        print(method, err, sens.error.tolist())
        for e, est in zip(err, sens.error.tolist()):
            assert e / ERROR_ESTIMATE_FACTOR <= est <= e * ERROR_ESTIMATE_FACTOR, (e, est)


# ---- the reference's own sensitivity cases ----------------------------------


def _jax_and_port_solver(build):
    return build("jax"), build("torch")


@pytest.mark.parametrize("method", ["ldl", "schur", "lu"])
def test_differentiate_backends(method):
    """tests/test_backends.py:test_differentiate_backends in the port: the
    QP with analytic sensitivity dx*/db = [2/3, 1/3] (lu as well)."""

    def build(pkg):
        tp = pkg == "torch"
        Pk = calipso_tpu_torch if tp else calipso_tpu
        vec = torch.stack if tp else jnp.array
        opts = Pk.Options(linear_solver=method, differentiate=True, residual_tolerance=1e-8,
                          line_search_mode="serial")
        return Pk.Solver(
            lambda x, th: 0.5 * x @ (th[:2] * x),
            lambda x, th: vec([x[0] + x[1] - th[2]]),
            Pk.empty_constraint,
            2, parameters=np.array([2.0, 4.0, 1.0]), options=opts, **(dict(device="cpu") if tp else {}),
        )

    js, ts = _jax_and_port_solver(build)
    rj = js.solve(jnp.zeros(2))
    rt = ts.solve(torch.zeros(2, dtype=torch.float64))
    assert bool(rt.solved) and int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(rt.sensitivity[:2, 2].numpy(), [2.0 / 3.0, 1.0 / 3.0], atol=1e-3)
    assert _rel(rt.sensitivity.numpy(), rj.sensitivity) <= SOLVE_SENS_RTOL


def test_qp_equality_sensitivity():
    """tests/test_solver_nlp.py:test_qp_equality in the port: the
    sensitivity against the dense implicit-function oracle (atol 1e-2, as
    there) and against the JAX package's (SOLVE_SENS_RTOL)."""
    objective, equality, params, Pd, p, A, b = _qp_problem()
    kw = dict(residual_tolerance=1e-8, equality_tolerance=1e-6, complementarity_tolerance=1e-6,
              differentiate=True, line_search_mode="serial")
    x0 = np.random.default_rng(5).normal(size=10)
    js = calipso_tpu.Solver(objective, equality, calipso_tpu.empty_constraint, 10, parameters=params,
                            options=calipso_tpu.Options(**kw))
    ts = calipso_tpu_torch.Solver(objective, equality, None, 10, parameters=params,
                                  options=calipso_tpu_torch.Options(**kw), device="cpu")
    rj = js.solve(jnp.asarray(x0))
    rt = ts.solve(torch.tensor(x0))
    assert_contract(rt, ts.options)
    assert int(rt.iterations) == int(rj.iterations)
    x, y = rt.variables.numpy(), rt.state.p.y.numpy()
    nv, ne, npar = 10, 5, len(params)
    K = np.block([[np.diag(Pd), A.T], [A, np.zeros((ne, ne))]])
    dPx = np.zeros((nv, npar))
    dPx[:, :nv] = np.diag(x)
    dPx[:, nv : 2 * nv] = np.eye(nv)
    dAty = np.zeros((nv, npar))
    dAxb = np.zeros((ne, npar))
    for i in range(ne):
        dAty[:, 2 * nv + i * nv : 2 * nv + (i + 1) * nv] = y[i] * np.eye(nv)
        dAxb[i, 2 * nv + i * nv : 2 * nv + (i + 1) * nv] = x
    dAxb[:, 2 * nv + ne * nv :] = -np.eye(ne)
    want = -np.linalg.solve(K, np.vstack([dPx + dAty, dAxb]))
    np.testing.assert_allclose(rt.sensitivity[:nv].numpy(), want[:nv], atol=1e-2)
    assert _rel(rt.sensitivity.numpy(), rj.sensitivity) <= SOLVE_SENS_RTOL


def test_double_integrator_differentiation():
    """tests/test_examples.py:test_double_integrator_differentiation in the
    port: the sensitivity of the variables against the dense oracle of the
    trajopt Lagrangian (atol 1e-3, as there), and against the JAX
    package's (SOLVE_SENS_RTOL)."""
    jopts = calipso_tpu.Options(residual_tolerance=1e-12, equality_tolerance=1e-8,
                                complementarity_tolerance=1e-8, differentiate=True, line_search_mode="serial")
    out = {}
    for pkg in ("jax", "torch"):
        prob = _double_integrator(pkg)
        ts, theta = _trajopt(pkg, "double_integrator", jopts)
        ts.initialize_actions([np.random.default_rng(0).normal(size=n) for n in prob["num_actions"]])
        out[pkg] = ts, ts.solve()
    (jts, rj), (tts, rt) = out["jax"], out["torch"]
    assert bool(rt.solved) and float(rt.state.equality_violation) <= 1e-8
    assert int(rt.iterations) == int(rj.iterations)
    fns = jts.solver.fns
    nvar = fns.dims.variables

    def lagrangian(zz, th):
        return fns.f(zz[:nvar], th) + fns.g(zz[:nvar], th) @ zz[nvar:]

    zstar = jnp.concatenate([jnp.asarray(rt.state.p.x.numpy()), jnp.asarray(rt.state.p.y.numpy())])
    th = jnp.asarray(theta)
    Lzz = jax.hessian(lagrangian)(zstar, th)
    Lzt = jax.jacfwd(jax.grad(lagrangian), argnums=1)(zstar, th)
    want = -np.linalg.solve(np.asarray(Lzz), np.asarray(Lzt))
    np.testing.assert_allclose(rt.sensitivity[:nvar].numpy(), want[:nvar], atol=1e-3)
    assert _rel(rt.sensitivity.numpy(), rj.sensitivity) <= SOLVE_SENS_RTOL


# ---- the differentiable solve -----------------------------------------------


def test_diffable_gradient_matches_jax():
    """The gradient of a scalar loss of the solution through the port's
    autograd.Function equals jax.grad through the reference's custom-VJP
    solve (each from its own tight solve), and its backward pass is sens'
    w_bar lane by lane (B=2, the second lane another initial state)."""
    jopts = calipso_tpu.Options(linear_solver="schur", **TIGHT)
    (jts, theta), (tts, _) = (_trajopt(p, "pendulum", jopts) for p in ("jax", "torch"))
    guess = np.asarray(jts._guess)
    c = np.random.default_rng(11).normal(size=jts.solver.fns.dims.total)
    loss_j = lambda w: jnp.sum(jnp.sin(w) * c)
    thetas = np.stack([theta + np.array([0.1, -0.2]), theta + np.array([-0.15, 0.05])])

    jsolve = jmake(jts.solver.fns, jts.solver.layout, jopts)
    want = np.stack([np.asarray(jax.grad(lambda th: loss_j(jsolve(th, jnp.asarray(guess))))(jnp.asarray(t)))
                     for t in thetas])

    tsolve = tmake(tts.solver.fns, tts.solver.layout, options_from_jax(jopts))
    th = torch.tensor(thetas, requires_grad=True)
    w = tsolve(th, torch.tensor(guess))
    assert bool(tsolve.state.solved.all())
    (torch.sin(w) * torch.tensor(c)).sum().backward()
    assert _rel(th.grad.numpy(), want) <= SOLVE_SENS_RTOL, _rel(th.grad.numpy(), want)

    # backward is sens' w_bar: the sensitivity at the forward pass's point
    sens = tdiff.solution_sensitivity(tts.solver.fns, tts.solver.layout, tts.solver.options, tsolve.state,
                                      torch.tensor(thetas))
    wbar = torch.cos(w.detach()) * torch.tensor(c)
    np.testing.assert_allclose(th.grad.numpy(), torch.einsum("bkp,bk->bp", sens, wbar).numpy(), rtol=1e-12, atol=0)


def test_diffable_skips_the_sensitivity_without_grad():
    """Under torch.no_grad() (or for a theta that needs no gradient) the
    forward pass solves and keeps no sensitivity."""
    jopts = calipso_tpu.Options(linear_solver="schur", **TIGHT)
    tts, theta = _trajopt("torch", "pendulum", jopts)
    tsolve = tmake(tts.solver.fns, tts.solver.layout, options_from_jax(jopts))
    with torch.no_grad():
        w = tsolve(torch.tensor(theta)[None].requires_grad_(True), torch.tensor(tts._guess))
    assert w.grad_fn is None and bool(tsolve.state.solved.all())
