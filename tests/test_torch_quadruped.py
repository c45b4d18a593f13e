"""The port's quadruped against the JAX package on the CPU in float64: the
model functions and their Jacobians at seeded points, the structured
oracles of the MPC problem (constraint values, Jacobians and the
stage-block Lagrangian Hessian) at a seeded primal-dual point (`heavy`),
a batched MPC solve at B=2 in the port alone, the two gait goldens
(`heavy`, like their references), and the bench's batched MPC solved in both packages (`slow`:
a full JAX quadruped solve takes minutes to compile, so it stays out of
the fast tiers). The JAX side of the oracle checks runs under `jax.jit`,
which halves its time here."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev, vmap

import calipso_tpu
import calipso_tpu_torch
from calipso_tpu.models import quadruped as jq
from calipso_tpu_torch.examples import contact_implicit
from calipso_tpu_torch.models import quadruped as tq
from calipso_tpu_torch.utils.convert import options_from_jax

MODEL_ATOL = 1e-10  # the same float64 arithmetic, up to summation order
ORACLE_ATOL = 1e-9
POINTS = 8
NQ = jq.NQ

# name -> the sizes of its arguments; configurations (11) and states (22,
# 26) are drawn near the nominal stance, the others from N(0, 1)
MODEL_FUNCTIONS = {
    "foot_positions": (NQ,),
    "mass_matrix": (NQ,),
    "lagrangian": (NQ, NQ),
    "signed_distance": (NQ,),
    "contact_impulse": (NQ, 4, 8),
    "variational_dynamics": (NQ, NQ, 8, NQ, NQ),
    "dynamics": (26, 22, 28),
    "friction_equality": (26, 28),
    "mirror_config": (NQ,),
}


def _points(name, rng):
    """POINTS seeded argument tuples near the nominal stance."""
    q0 = jq._nominal_q()
    out = []
    for size in MODEL_FUNCTIONS[name]:
        a = rng.normal(size=(POINTS, size))
        if size in (NQ, 22, 26):  # configurations (and states) near the stance
            base = np.concatenate([q0, q0, np.full(4, 0.5)])[:size]
            a = base + 0.1 * a
        out.append(a)
    return out


def _jax_fn(name):
    if name == "variational_dynamics":
        return lambda *a: jq.variational_dynamics(jq.TIMESTEP, *a)
    return getattr(jq, name)


def _torch_fn(name):
    if name == "variational_dynamics":
        return lambda *a: tq.variational_dynamics(tq.TIMESTEP, *a)
    return getattr(tq, name)


@pytest.mark.parametrize("name", list(MODEL_FUNCTIONS))
def test_model_function_and_jacobian_match_jax(name):
    args = _points(name, np.random.default_rng(len(name)))
    argnums = tuple(range(len(args)))
    jf, tf = _jax_fn(name), _torch_fn(name)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.tensor(a) for a in args]
    vj, Jj = jax.jit(jax.vmap(lambda *a: (jf(*a), jax.jacrev(jf, argnums=argnums)(*a))))(*jargs)
    np.testing.assert_allclose(vmap(tf)(*targs).numpy(), np.asarray(vj), atol=MODEL_ATOL, rtol=0)
    Jt = vmap(jacrev(tf, argnums=argnums))(*targs)
    for a, b in zip(Jt, Jj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=MODEL_ATOL, rtol=0)


def _solvers(horizon):
    """The same quadruped MPC problem as a JAX and a port TrajOptSolver."""
    out = []
    for m, pkg in ((jq, calipso_tpu), (tq, calipso_tpu_torch)):
        prob = m.mpc_problem(horizon=horizon)
        args = {k: v for k, v in prob.items() if k not in ("state_guess", "state_initial", "action_guess")}
        opts = calipso_tpu.Options()
        extra = {}
        if pkg is calipso_tpu_torch:
            opts, extra = options_from_jax(opts), dict(device="cpu")
        ts = pkg.TrajOptSolver(options=opts, **extra, **args)
        ts.initialize_states(prob["state_guess"])
        ts.initialize_actions(prob["action_guess"])
        out.append(ts)
    return out


@pytest.mark.heavy
def test_structured_oracles_match_jax():
    """mpc_problem(horizon=3): g, h, gx, hx and the stage-block Hessian
    blocks at one seeded primal-dual point of two lanes (`heavy`: most of
    its time is the JAX compile of the d=54 oracles)."""
    tj, tt = _solvers(3)
    js, ts = tj.solver, tt.solver
    assert tt.solver.options.linear_solver == "riccati" and ts.fns.stage_structure.dmax == 54
    dims = ts.dims
    assert dims == js.dims
    rng = np.random.default_rng(1)
    B = 2
    x = np.asarray(tt._guess)[None] + 0.05 * rng.normal(size=(B, dims.variables))
    th = rng.normal(size=(B, dims.parameters))
    y = rng.normal(size=(B, dims.equality))
    z = rng.normal(size=(B, dims.cone))
    jf, tf = js.fns, ts.fns
    names = ("g", "h", "gx", "hx")

    def oracles(x, th, y, z):
        return tuple(getattr(jf, k)(x, th) for k in names) + jf.lagrangian_hessian_blocks(x, th, y, z, True)[:2]

    want = jax.jit(jax.vmap(oracles))(x, th, y, z)
    T = lambda a: torch.tensor(a)
    got = tuple(getattr(tf, k)(T(x), T(th)) for k in names)
    D, O, Hgen = tf.lagrangian_hessian_blocks(T(x), T(th), T(y), T(z))
    assert Hgen is None
    for name, g, w in zip(names + ("D", "O"), got + (D, O), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ORACLE_ATOL, rtol=0, err_msg=name)


TOL = {k: 1e-4 for k in ("residual_tolerance", "optimality_tolerance", "slack_tolerance",
                         "equality_tolerance", "complementarity_tolerance")}


def _scenarios(B):
    """bench.py:428-436: the nominal stance dropped from a per-lane height
    in U[0.02, 0.10] (default_rng(0)), as the stage-0 parameter (q1, q2)."""
    heights = np.random.default_rng(0).uniform(0.02, 0.10, size=B)
    q0 = tq._nominal_q()
    x0 = np.tile(np.concatenate([q0, q0])[None], (B, 1))
    x0[:, 1] += heights
    x0[:, NQ + 1] += heights
    return x0


@pytest.mark.slow
def test_mpc_batch_matches_jax():
    """The bench's batched quadruped (mpc_problem(horizon=8), d=54) at B=4
    in both packages, line search pinned to "serial": equal solved flags
    and iterations lane by lane, solutions within 1e-6."""
    jopts = calipso_tpu.Options(max_iterative_refinement=2, iterative_refinement_tolerance=1e-6,
                                line_search_mode="serial", **TOL)
    x0 = _scenarios(4)
    out = []
    for m, pkg in ((jq, calipso_tpu), (tq, calipso_tpu_torch)):
        prob = m.mpc_problem(horizon=8)
        args = {k: v for k, v in prob.items() if k not in ("state_guess", "state_initial", "action_guess")}
        extra, opts, th = {}, jopts, jnp.asarray(x0)
        if pkg is calipso_tpu_torch:
            extra, opts, th = dict(device="cpu"), options_from_jax(jopts), torch.tensor(x0)
        ts = pkg.TrajOptSolver(options=opts, **extra, **args)
        ts.initialize_states(prob["state_guess"])
        ts.initialize_actions(prob["action_guess"])
        st = ts.batched().solve(parameters=th).state
        out.append((np.asarray(st.solved), np.asarray(st.total_i), np.asarray(st.p.x)))
    (sj, ij, xj), (st_, it, xt) = out
    assert sj.all() and st_.tolist() == sj.tolist()
    assert it.tolist() == ij.tolist()
    np.testing.assert_allclose(xt, xj, atol=1e-6, rtol=0)


def test_mpc_batch_solves_with_feet_on_the_ground():
    """The bench's stance MPC scenarios (stance heights from U[0.02, 0.10]
    as the stage-0 parameter, `bench.py:428-436`) at H=3, B=2, in the
    port: both lanes meet the 1e-4 contract through the stream route, and
    no foot is below the ground (tests/test_quadruped_mpc.py:57-61)."""
    prob = tq.mpc_problem(horizon=3)
    args = {k: v for k, v in prob.items() if k not in ("state_guess", "state_initial", "action_guess")}
    ts = calipso_tpu_torch.TrajOptSolver(
        options=calipso_tpu_torch.Options(max_iterative_refinement=2, **TOL), device="cpu", **args
    )
    ts.initialize_states(prob["state_guess"])
    ts.initialize_actions(prob["action_guess"])
    x0 = _scenarios(2)
    st = ts.batched().solve(parameters=torch.tensor(x0)).state
    assert st.solved.all()
    assert float(st.equality_violation.max()) <= 1e-4
    assert float(st.cone_product_violation.max()) <= 1e-4
    z = st.p.x
    for idx in ts._state_indices[1:]:
        assert float(vmap(tq.signed_distance)(z[:, idx[NQ : 2 * NQ]]).min()) > -1e-4
    np.testing.assert_allclose(z[:, ts._state_indices[0]].numpy(), x0, atol=1e-4)


@pytest.mark.heavy
@pytest.mark.parametrize(
    "golden,build,kw",
    [
        ("quadruped_gait", "gait_problem", dict(horizon=11, travel=0.2)),
        ("quadruped_gait_v2", "gait_problem_v2", dict(horizon=11, travel=0.2, t_fix=4)),
    ],
)
def test_golden_quadruped_gait(golden, build, kw):
    """The port's version of tests/test_golden.py:test_golden_quadruped_gait
    and _v2 (default Options, so "auto" -> riccati with the
    general-equality border on the stream route), solved through the
    port's examples (contact_implicit.quadruped_gait, _v2: the problem's
    own guess): solved, states within 1e-2 of the golden, iterations
    within +-15% of its count."""
    gold = np.load(os.path.join(os.path.dirname(__file__), "golden", f"{golden}.npz"))
    out = getattr(contact_implicit, golden)("cpu")
    ts, r = out["solver"], out["result"]
    prob = getattr(tq, build)(**kw)
    guess = np.zeros(ts.num_variables)
    for idx, x in zip(ts._state_indices, prob["state_guess"]):
        guess[idx] = x
    for idx, u in zip(ts._action_indices, prob["action_guess"]):
        guess[idx] = u
    np.testing.assert_array_equal(np.asarray(ts._guess), guess)
    st = ts.solver.fns.stage_structure
    assert ts.solver.options == calipso_tpu_torch.Options(linear_solver="riccati")
    assert ts.solver.options.linear_solver == "riccati" and len(st.general_stages) == 2
    assert bool(r.solved)
    states = lambda z: np.concatenate([np.asarray(z)[idx] for idx in ts._state_indices])
    np.testing.assert_allclose(states(r.variables.numpy()), states(gold["variables"]), atol=1e-2)
    ref = int(gold["iterations"])
    assert 0.85 * ref <= int(r.iterations) <= 1.15 * ref
