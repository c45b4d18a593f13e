"""The port's small models, cyberdrift and the state-triggered rocket
against the JAX package on the CPU in float64.

- Every stage function of the double integrator, the acrobot, the
  cart-pole and cyberdrift (objective, dynamics, equality, nonnegative
  and second-order cones): value and Jacobian at seeded points, one
  parametrised test over (model, function).
- The acrobot swing-up of `tests/test_examples.py` in both packages: the
  same iterations, states within 1e-6.
- `heavy`, as the reference's tests are: cyberdrift (`tests/test_contact.
  py:test_cyberdrift`, schur at n = 286, its options and initial actions)
  and the state-triggered rocket (`test_state_triggered_rocket`, T=51,
  the lanes route at d = 17 on the card), each solved in both packages
  and held to the reference test's assertions. The rocket takes the
  reference's iterations, its states within 1e-6. Cyberdrift is a
  contact problem that moves with the last bit: the two packages' merits
  agree to 1e-15 over the first 12 steps and to 8e-13 over the first 30
  (the same float64 arithmetic up to summation order), then the gap grows
  a decade every few steps until they take another step size at step 63;
  the reference's solve ends in 100 iterations, the port's in 97 (with
  one torch thread). So it is held, step by step, to the reference's
  merits over the first FOLLOW_STEPS steps, then to the iteration band
  of `tests/test_golden.py` (+-15%) and the reference test's assertions
  (run with -s for the gaps). A `slow` test shows that from the guess scaled by 1 + k 1e-15
  (k = 0..8) some solves of each package fail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev

import calipso_tpu
import calipso_tpu_torch
from calipso_tpu.models import acrobot as jacro
from calipso_tpu.models import cartpole as jcart
from calipso_tpu.models import cyberdrift as jcyber
from calipso_tpu.models import double_integrator as jdi
from calipso_tpu.models import rocket as jrocket
from calipso_tpu_torch.models import acrobot as tacro
from calipso_tpu_torch.models import cartpole as tcart
from calipso_tpu_torch.models import cyberdrift as tcyber
from calipso_tpu_torch.models import double_integrator as tdi
from calipso_tpu_torch.models import rocket as trocket
from calipso_tpu_torch.solver.problem import num_positional
from calipso_tpu_torch.utils.convert import options_from_jax
from tests.test_solver_nlp import assert_contract

# Tier-1 runs several pytest workers on few CPUs: one torch thread each
torch.set_num_threads(1)

MODEL_ATOL = 1e-10  # the same float64 arithmetic, up to summation order
POINTS = 3
STATE_ATOL = 1e-6
BAND = 0.15  # tests/test_golden.py's iteration band
# cyberdrift's merits in the two packages: steps held, relative limit
FOLLOW_STEPS, FOLLOW_RTOL = 30, 1e-10
GUESS_KEYS = ("state_guess", "state_initial", "state_goal", "action_guess", "penalty_initial")

MODELS = {
    "double_integrator": (jdi, tdi, "problem", dict(horizon=4)),
    "acrobot": (jacro, tacro, "swingup_problem", dict(horizon=4)),
    "cartpole": (jcart, tcart, "swingup_problem", dict(horizon=4)),
    "cartpole_parametric": (jcart, tcart, "swingup_problem", dict(horizon=4, parametric_initial_state=True)),
    "cyberdrift": (jcyber, tcyber, "drift_problem", dict(horizon=4)),
}
KINDS = ("objective", "dynamics", "equality", "nonnegative", "second_order")


def _cases():
    cases = []
    for model, (jm, _, build, kw) in MODELS.items():
        prob = getattr(jm, build)(**kw)
        for kind in KINDS:
            seen = set()
            for t, f in enumerate(prob.get(kind) or []):
                for k, g in enumerate(f if isinstance(f, list) else [f]):
                    if g is not None and id(g) not in seen:
                        seen.add(id(g))
                        cases.append((model, kind, t, k))
    return cases


@pytest.mark.parametrize("model,kind,t,k", _cases())
def test_stage_function_matches_jax(model, kind, t, k):
    """Value and Jacobian (by every argument) of one stage function at
    seeded points near the problem's guess."""
    jm, tm, build, kw = MODELS[model]
    jprob, tprob = getattr(jm, build)(**kw), getattr(tm, build)(**kw)
    pick = lambda prob: prob[kind][t][k] if isinstance(prob[kind][t], list) else prob[kind][t]
    jf, tf = pick(jprob), pick(tprob)
    ns, na = jprob["num_states"], jprob["num_actions"]
    params = jprob.get("parameters")
    rng = np.random.default_rng(7 * t + k)
    near = lambda base: np.asarray(base, float)[None] + 0.1 * rng.normal(size=(POINTS, np.size(base)))
    x = near(jprob["state_guess"][t])
    u = near(np.zeros(na[t])) if t < len(na) else np.zeros((POINTS, 0))
    w = near(params[t]) if params is not None else np.zeros((POINTS, 0))
    args = [near(jprob["state_guess"][t + 1]), x, u] if kind == "dynamics" else [x, u]
    if num_positional(jf, len(args) + 1) > len(args):  # a function of w too
        args.append(w)
    for i in range(POINTS):
        ja = [jnp.asarray(a[i]) for a in args]
        ta = [torch.tensor(a[i]) for a in args]
        jv = jf(*ja)
        tv = tf(*ta)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=MODEL_ATOL)
        argnums = tuple(range(len(ja)))
        jj = jax.jacfwd(jf, argnums=argnums)(*ja)
        tj = jacrev(tf, argnums=argnums)(*ta)
        for a, b in zip(jj, tj):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=MODEL_ATOL)


def _solve(pkg, prob, options, actions=None, merits=None):
    """(TrajOptSolver, result) of one package's solve; each inner step's
    merit is appended to `merits` when given."""
    kw = {k: v for k, v in prob.items() if k not in GUESS_KEYS}
    if pkg == "jax":
        ts = calipso_tpu.TrajOptSolver(options=options, **kw)
    else:
        ts = calipso_tpu_torch.TrajOptSolver(options=options_from_jax(options), device="cpu", **kw)
    ts.initialize_states(prob["state_guess"])
    actions = prob.get("action_guess") if actions is None else actions
    if actions is not None:
        ts.initialize_actions(actions)
    if merits is not None:
        ts.solver.callbacks(inner=lambda d: merits.append(float(np.asarray(d["merit"]).reshape(-1)[0])))
    res = ts.solve()
    return ts, res


def _both(build, options, actions=None, merits=None):
    merits = merits if merits is not None else {}
    return {pkg: _solve(pkg, build(pkg), options, actions, merits.get(pkg)) for pkg in ("jax", "torch")}


def test_acrobot_swingup_matches_jax():
    """tests/test_examples.py:test_acrobot_swingup (horizon 21, actions
    N(0, 1) from default_rng(0)) in both packages."""
    build = lambda pkg: (jacro if pkg == "jax" else tacro).swingup_problem(horizon=21)
    rng = np.random.default_rng(0)
    actions = [rng.normal(size=1) for _ in range(20)]
    out = _both(build, calipso_tpu.Options(line_search_mode="serial"), actions)
    (jts, rj), (tts, rt) = out["jax"], out["torch"]
    assert_contract(rt)
    assert int(rt.iterations) == int(rj.iterations)
    states, _ = tts.get_trajectory(rt)
    np.testing.assert_allclose(states[-1], np.asarray(build("jax")["state_goal"]), atol=1e-4)
    np.testing.assert_allclose(rt.variables.numpy(), np.asarray(rj.variables), rtol=0, atol=STATE_ATOL)


@pytest.mark.heavy
def test_cyberdrift_matches_reference_test():
    """tests/test_contact.py:test_cyberdrift in both packages: the
    reference test's options (schur pinned), initial actions and
    assertions; each inner step's merit within FOLLOW_RTOL of the
    reference's over the first FOLLOW_STEPS steps, and the iterations
    within the band of the reference's (see the module doc)."""
    opts = calipso_tpu.Options(
        residual_tolerance=1e-3, optimality_tolerance=1e-3, equality_tolerance=1e-3,
        complementarity_tolerance=1e-3, slack_tolerance=1e-3, penalty_initial=10.0,
        linear_solver="schur", line_search_mode="serial",
    )
    rng = np.random.default_rng(1)
    actions = [np.concatenate([1e-3 * rng.normal(size=2), np.tile([1.0, 0.1, 0.1], 4)]) for _ in range(14)]
    build = lambda pkg: (jcyber if pkg == "jax" else tcyber).drift_problem()
    merits = {"jax": [], "torch": []}
    out = _both(build, opts, actions, merits)
    steps = min(len(merits["jax"]), len(merits["torch"]))
    mj, mt = (np.array(merits[pkg][:steps]) for pkg in ("jax", "torch"))
    rel = np.abs(mt - mj) / np.abs(mj)
    apart = np.nonzero(rel > 1e-6)[0]
    print(f"largest relative merit gap over the first {FOLLOW_STEPS} steps {rel[:FOLLOW_STEPS].max():.3e}; first "
          f"step apart by more than 1e-6: {apart[0] if apart.size else None}")
    assert steps >= FOLLOW_STEPS and float(rel[:FOLLOW_STEPS].max()) <= FOLLOW_RTOL
    for pkg, (ts, res) in out.items():
        assert_contract(res, opts)
        states, _ = ts.get_trajectory(res)
        np.testing.assert_allclose(states[-1][0:3], build("jax")["state_goal"][0:3], atol=1e-2)
    assert out["torch"][0].num_variables == 286
    ij, it = int(out["jax"][1].iterations), int(out["torch"][1].iterations)
    assert abs(it - ij) <= BAND * ij, (it, ij)


@pytest.mark.slow
def test_cyberdrift_outcome_depends_on_the_last_bit():
    """Cyberdrift with the reference test's options, in both packages, from
    its guess scaled by 1 + k 1e-15 for k = 0..8: in each package some
    solves meet the contract and some do not (the reference's test notes
    that it "may need to run more than once"). Prints each solve; run with
    -s to read them."""
    opts = calipso_tpu.Options(
        residual_tolerance=1e-3, optimality_tolerance=1e-3, equality_tolerance=1e-3,
        complementarity_tolerance=1e-3, slack_tolerance=1e-3, penalty_initial=10.0,
        linear_solver="schur", line_search_mode="serial",
    )
    rng = np.random.default_rng(1)
    actions = [np.concatenate([1e-3 * rng.normal(size=2), np.tile([1.0, 0.1, 0.1], 4)]) for _ in range(14)]
    for pkg, model in (("jax", jcyber), ("torch", tcyber)):
        prob = model.drift_problem()
        kw = {k: v for k, v in prob.items() if k not in GUESS_KEYS}
        if pkg == "jax":
            ts, cast = calipso_tpu.TrajOptSolver(options=opts, **kw), jnp.asarray
        else:
            ts = calipso_tpu_torch.TrajOptSolver(options=options_from_jax(opts), device="cpu", **kw)
            cast = torch.tensor
        ts.initialize_states(prob["state_guess"])
        ts.initialize_actions(actions)
        g0 = np.asarray(ts._guess)
        met = []
        for k in range(9):
            r = ts.solver.solve(cast(g0 * (1 + k * 1e-15)))
            st = r.state
            met.append(bool(st.solved) and float(st.residual_violation) < opts.residual_tolerance)
            print(f"{pkg} k={k}: solved {bool(st.solved)} in {int(r.iterations)} iterations, residual "
                  f"{float(st.residual_violation):.2e}")
        assert any(met) and not all(met), (pkg, met)


@pytest.mark.heavy
def test_state_triggered_rocket_matches_jax():
    """tests/test_contact.py:test_state_triggered_rocket (T=51) in both
    packages: the trigger's assertion, the reference's iterations, states
    within 1e-6."""
    build = lambda pkg: (jrocket if pkg == "jax" else trocket).state_triggered_problem(horizon=51)
    prob = build("jax")
    out = _both(build, calipso_tpu.Options(penalty_initial=prob["penalty_initial"], line_search_mode="serial"))
    (jts, rj), (tts, rt) = out["jax"], out["torch"]
    assert_contract(rt)
    assert tts.solver.options.linear_solver == "riccati"
    assert tts.solver.fns.stage_structure.dmax == 17
    states, _ = tts.get_trajectory(rt)
    for x in states:
        if -x[0] + (-0.5) > 1e-4:
            assert x[2] - 3.0 > -1e-4
    assert int(rt.iterations) == int(rj.iterations)
    # the states; the trigger's split slacks reach 1e4, where the same
    # relative agreement (~1e-8) is 1e-4 absolute
    np.testing.assert_allclose(np.array(states), np.array(jts.get_trajectory(rj)[0]), rtol=0, atol=STATE_ATOL)
