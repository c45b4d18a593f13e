"""The port's examples (`calipso_tpu_torch/examples/`) against the JAX
package's scripts (`examples/*.py`) on the CPU in float64.

The JAX scripts solve when imported, so each problem's JAX side is
rebuilt here line for line from its script (the `_jax_*` builders).

- nonconvex: the three `Solver` problems in both packages: the same
  solved flags and iterations, variables within VAR_ATOL.
- batched_scenarios at B = 16 (the script's 256 cut for time; its x0s are
  the first 16 rows of the script's): the same per-lane solved flags and
  iterations, states within VAR_ATOL.
- autotuning_acrobot: the H=31 swing-up in the same iterations, states
  within SWINGUP_ATOL; the tuning (cut from the script's 5 iterations to
  TUNE_ITERATIONS for time) with the reference's loss history to
  HISTORY_RTOL, and the loss falls.
- drifting: the example's problem, options and guess are those of
  `tests/test_contact.py:test_cyberdrift` (the options resolved on the
  CPU, where "auto" takes the serial line search in both packages), so
  `tests/test_torch_models.py:test_cyberdrift_matches_reference_test`
  (`heavy`), which builds its port side through `drifting.solve`, holds
  the example in both packages: one solve each, merit by merit.
- The examples whose options differ from the existing parity tests that
  now run through them: the hopper gait's `verbose=True,
  print_frequency=25` changes no iterate (its first steps, bit for bit); the
  rocket landing's options are `Options(linear_solver="cr")`'s.

The other examples' parity is held by tests that build their port side
through the example's entry point: `tests/test_torch_cr.py:
test_golden_rocket101_cr` (rocket_landing), `tests/test_torch_contact.py:
test_ball_in_cup_matches_jax` and `test_golden_hopper_gait` (`slow`)
(contact_implicit), `tests/test_torch_quadruped.py:
test_golden_quadruped_gait` (both gaits, `heavy`) and
`tests/test_torch_apps.py:test_cartpole_autotuning_matches_jax` (`heavy`,
mpc_autotuning).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import calipso_tpu
import calipso_tpu_torch
from calipso_tpu_torch.examples import (
    autotuning_acrobot,
    batched_scenarios,
    contact_implicit,
    drifting,
    nonconvex,
    rocket_landing,
)
from calipso_tpu_torch.solver.solve import resolve_options

torch.set_num_threads(1)

VAR_ATOL = 1e-8  # the same float64 arithmetic, up to summation order
SWINGUP_ATOL = 1e-6
HISTORY_RTOL = 1e-6
B_SCENARIOS = 16
TUNE_ITERATIONS = 1
GUESS_ATOL = 1e-15  # a last bit of the models' state guesses (4.4e-16)


# ---- nonconvex ---------------------------------------------------------------


def _jax_nonconvex(name):
    """examples/nonconvex.py's problem `name`: (solver, x0)."""
    from calipso_tpu import Options, Solver, empty_constraint

    if name == "wachter":
        return Solver(
            lambda x: x[0],
            lambda x: jnp.array([x[0] ** 2 - x[1] - 1.0, x[0] - x[2] - 0.5]),
            lambda x: x[1:3],
            3,
            options=Options(verbose=True, print_frequency=5),
        ), jnp.array([-2.0, 3.0, 1.0])
    if name == "maratos":
        return Solver(
            lambda x: 2.0 * (x[0] ** 2 + x[1] ** 2 - 1.0) - x[0],
            lambda x: jnp.array([x[0] ** 2 + x[1] ** 2 - 1.0]),
            empty_constraint,
            2,
            options=Options(verbose=True, print_frequency=5),
        ), jnp.array([2.0, 1.0])

    def eq(x):
        f1 = -x[0] - x[1] + x[2] + 2.0
        f2 = x[0] - 2.0 * x[2] + 1.0
        f3 = x[0] + x[1] + 2.0 * x[2] - 6.0
        return jnp.array([x[3] - f1, x[4] - f2, x[5] - f3, x[0] * x[3] + x[1] * x[4] + x[2] * x[5]])

    return Solver(
        lambda x: (x[0] - 1.0) ** 2 + (x[2] - 1.5) ** 2,
        eq,
        lambda x: jnp.concatenate([x[:3], x[3:6]]),
        6,
        options=Options(verbose=True, print_frequency=10),
    ), jnp.ones(6)


@pytest.mark.parametrize("name", list(nonconvex.PROBLEMS))
def test_nonconvex_matches_jax(name):
    solver, x0 = _jax_nonconvex(name)
    rj = solver.solve(x0)
    out = nonconvex.PROBLEMS[name]("cpu")
    assert out["solver"].options.linear_solver == "schur"
    assert out["solved"] == bool(rj.solved) is True
    assert out["iterations"] == int(rj.iterations)
    np.testing.assert_allclose(out["variables"], np.asarray(rj.variables), rtol=0, atol=VAR_ATOL)


# ---- batched_scenarios -----------------------------------------------------------


def test_batched_scenarios_matches_jax():
    from calipso_tpu.models import pendulum

    prob = pendulum.swingup_problem(horizon=11, parametric_initial_state=True)
    kw = {k: v for k, v in prob.items() if k not in ("state_guess", "state_initial", "state_goal")}
    ts = calipso_tpu.TrajOptSolver(options=calipso_tpu.Options(), **kw)
    xg = np.array([np.pi, 0.0])
    ts.initialize_states([xg * t / 10 for t in range(11)])
    x0s = 0.2 * np.random.default_rng(0).normal(size=(256, 2))[:B_SCENARIOS]
    rj = ts.batched().solve(parameters=jnp.asarray(x0s))

    out = batched_scenarios.main(B_SCENARIOS, "cpu")
    assert out["batch"] == B_SCENARIOS and out["device_kind"] == "cpu"
    np.testing.assert_array_equal(out["result"].state.solved.numpy(), np.asarray(rj.state.solved))
    assert out["solved"] == B_SCENARIOS
    np.testing.assert_array_equal(out["iterations"], np.asarray(rj.state.total_i))
    np.testing.assert_allclose(out["states"], np.asarray(rj.state.p.x), rtol=0, atol=VAR_ATOL)
    # the lanes' initial states are the scenarios'
    np.testing.assert_allclose(out["states"][:, :2], x0s, atol=1e-4)


# ---- autotuning_acrobot --------------------------------------------------------


def _jax_acrobot(max_iterations):
    """examples/autotuning_acrobot.py: (swing-up result, its states, the
    tuning's loss history)."""
    from calipso_tpu import Options, TrajOptSolver, linear_interpolation
    from calipso_tpu.apps import autotuning
    from calipso_tpu.models import acrobot

    H, nx, nu, T = 31, 4, 1, 4
    state_initial, state_goal = np.zeros(4), np.array([np.pi, 0.0, 0.0, 0.0])
    ref = TrajOptSolver(
        [lambda x, u, w: 1.0 * x[2:] @ x[2:] + 1.0 * u @ u] * (H - 1) + [lambda x, u, w: 1.0 * x[2:] @ x[2:]],
        [acrobot.discrete] * (H - 1),
        [nx] * H,
        [nu] * (H - 1),
        equality=[lambda x, u, w: x - state_initial, *[None] * (H - 2), lambda x, u, w: x - state_goal],
        options=Options(),
    )
    ref.initialize_states(linear_interpolation(state_initial, state_goal, H))
    ref.initialize_actions([0.11 * np.ones(nu)] * (H - 1))
    res = ref.solve()
    state_ref, action_ref = ref.get_trajectory(res)

    def stage_cost(x, u, w):
        dx = x - state_goal
        return 0.5 * dx @ (w[:4] * dx) + 0.05 * (u @ u)

    mpc = TrajOptSolver(
        [stage_cost] * (T - 1) + [lambda x, u, w: 0.5 * (x - state_goal) @ (w[:4] * (x - state_goal))],
        [acrobot.discrete] * (T - 1),
        [nx] * T,
        [nu] * (T - 1),
        equality=[lambda x, u, w: x - w[4:8], *[None] * (T - 1)],
        parameters=[np.concatenate([np.ones(4), np.zeros(4)])] + [np.ones(4)] * (T - 2) + [10.0 * np.ones(4)],
        options=Options(residual_tolerance=1e-6, equality_tolerance=1e-6, complementarity_tolerance=1e-6),
    )

    def theta_builder(log_weights, state):
        weights = jnp.exp(log_weights)
        return jnp.concatenate([weights, state] + [weights] * (T - 2) + [10.0 * jnp.ones(4)])

    pol = autotuning.make_mpc_policy(
        mpc, guess=np.zeros(mpc.num_variables), theta_builder=theta_builder,
        action_indices=mpc._action_indices[0], num_weights=4,
    )
    t0, R = 24, 6
    xref_tail = jnp.asarray(np.stack(state_ref[t0 : t0 + R]))
    uref_tail = jnp.asarray(np.concatenate([np.stack(action_ref[t0 : t0 + R - 1]), np.zeros((1, 1))]))

    def sim(x, u):
        y = x + 0.05 * acrobot.continuous(x, u)
        for _ in range(3):
            y = x + 0.05 * acrobot.continuous(0.5 * (x + y), u)
        return y

    loss = autotuning.rollout_loss(
        pol.policy, sim, horizon=R, state_cost=np.diag([10.0, 10.0, 1.0, 1.0]), action_cost=0.01 * np.eye(1),
        state_reference=xref_tail, action_reference=uref_tail,
    )
    x0 = jnp.asarray(state_ref[t0]) + jnp.array([0.05, -0.05, 0.0, 0.0])
    _, history = autotuning.autotune(loss, jnp.zeros(4), x0, max_iterations=max_iterations)
    return res, state_ref, history


def test_autotuning_acrobot_matches_jax():
    res, state_ref, want = _jax_acrobot(TUNE_ITERATIONS)
    out = autotuning_acrobot.main("cpu", max_iterations=TUNE_ITERATIONS)
    swing = out["swingup"]
    fns = swing["solver"].solver.fns
    assert swing["solver"].solver.options.linear_solver == "riccati" and fns.stage_structure.dmax == 5
    assert swing["solved"] and bool(res.solved)
    assert swing["iterations"] == int(res.iterations)
    np.testing.assert_allclose(np.stack(swing["states"]), np.stack(state_ref), rtol=0, atol=SWINGUP_ATOL)
    history = out["history"]
    assert len(history) == len(want) == TUNE_ITERATIONS + 1
    assert history[-1] < history[0]
    np.testing.assert_allclose(history, want, rtol=HISTORY_RTOL, atol=0)


# ---- examples whose problem an existing parity test solves -----------------------


def test_drifting_example_is_the_reference_test():
    """drifting's problem, options and guess against
    tests/test_contact.py:test_cyberdrift's (which
    test_cyberdrift_matches_reference_test solves in both packages through
    drifting.solve): the same guess, and, resolved on the CPU, the same
    options, field by field. The guess is the port's cyberdrift model's,
    which is the reference model's to GUESS_ATOL (each package computes
    its own state guess)."""
    from calipso_tpu.models import cyberdrift

    jopts = calipso_tpu.Options(
        residual_tolerance=1e-3, optimality_tolerance=1e-3, equality_tolerance=1e-3,
        complementarity_tolerance=1e-3, slack_tolerance=1e-3, penalty_initial=10.0, linear_solver="schur",
    )
    prob = cyberdrift.drift_problem()
    kw = {k: v for k, v in prob.items()
          if k not in ("state_guess", "state_initial", "state_goal", "action_guess", "penalty_initial")}
    jts = calipso_tpu.TrajOptSolver(options=jopts, **kw)
    jts.initialize_states(prob["state_guess"])
    rng = np.random.default_rng(1)
    jts.initialize_actions([np.concatenate([1e-3 * rng.normal(size=2), np.tile([1.0, 0.1, 0.1], 4)]) for _ in range(14)])
    ts, _ = drifting.build("cpu")
    np.testing.assert_allclose(np.asarray(ts._guess), np.asarray(jts._guess), rtol=0, atol=GUESS_ATOL)
    ours = resolve_options(ts.solver.options, ts.solver.fns, "cpu")
    theirs = calipso_tpu.solver.solve.resolve_options(jts.solver.options, jts.solver.fns)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.line_search_mode == "serial" and ts.num_variables == 286


def test_hopper_example_verbose_changes_no_iterate(capsys):
    """contact_implicit.hopper_gait's options (verbose=True,
    print_frequency=25) against test_golden_hopper_gait's former default
    Options: the first steps of the example's gait (3 outer iterations of
    at most 2 inner steps), the same iterates and merits bit for bit, and
    the verbose run prints."""
    from calipso_tpu_torch.models import hopper

    steps = {}
    for verbose in (True, False):
        opts = contact_implicit.HOPPER_OPTIONS.replace(verbose=verbose, max_residual_iterations=2, max_outer_iterations=3)
        ts = contact_implicit._build(hopper.gait_problem(), opts, "cpu")
        seen = []
        ts.solver.callbacks(inner=lambda d: seen.append(d["merit"].clone()))
        r = ts.solve()
        assert int(r.iterations) >= 1
        steps[verbose] = (r.variables, torch.stack(seen))
    assert torch.equal(steps[True][0], steps[False][0]) and torch.equal(steps[True][1], steps[False][1])
    assert "linear_solver riccati" in capsys.readouterr().out


def test_rocket_example_options_are_the_golden_tests():
    """rocket_landing's options are test_golden_rocket101_cr's former
    Options(linear_solver="cr"), field by field, so that test, which now
    solves through rocket_landing.main, holds the example."""
    assert dataclasses.asdict(rocket_landing.options()) == dataclasses.asdict(calipso_tpu_torch.Options(linear_solver="cr"))
