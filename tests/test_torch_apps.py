"""The port's applications against the JAX package on the CPU in float64:
the warm-started MPC closed loop (`apps/mpc.py`) and MPC auto-tuning
through the differentiable solve (`apps/autotuning.py`).

- The pendulum MPC of `tests/test_mpc.py` over 15 steps, two scenarios
  as the port's two lanes against two reference rollouts: the same
  iterations at every step and states to 1e-8; the warm steps cheaper
  than the cold ones, as the reference test asks.
- The linear MPC policy of `tests/test_autotuning.py`: the loss's
  gradient against central differences (the reference test's bound) and
  against `jax.grad` of the reference's loss, and `autotune`'s loss
  history against the reference's (1e-7 relative each).
- The cart-pole tuning of `tests/test_autotuning.py:test_cartpole_mpc_
  autotuning` (max_iterations=3): the loss falls, with the reference's
  history.

Both packages run the serial line search (`auto` gives serial on the CPU
in the port). The plant, the parameter builder and the dynamics are
written for one lane in each package.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import calipso_tpu
import calipso_tpu_torch
from calipso_tpu.apps import autotuning as jtune
from calipso_tpu.apps.mpc import make_mpc_controller as jcontroller, mpc_rollout as jrollout
from calipso_tpu_torch.apps import autotuning as ttune
from calipso_tpu_torch.apps.mpc import make_mpc_controller, mpc_rollout
from tests import test_autotuning as jtests
from tests.test_mpc import _pendulum_mpc

# Tier-1 runs several pytest workers on few CPUs: one torch thread each
torch.set_num_threads(1)

STATE_ATOL = 1e-8
HISTORY_RTOL = 1e-7
MPC_STEPS = 15


def _pendulum_mpc_torch(horizon=11):
    """tests/test_mpc.py:_pendulum_mpc in the port (serial line search)."""

    def pend_c(x, u):
        return torch.stack([x[1], u[0] / 0.25 - 9.81 * torch.sin(x[0]) / 0.5 - 0.1 * x[1] / 0.25])

    def pend_d(y, x, u):
        return y - (x + 0.05 * pend_c(0.5 * (x + y), u))

    xg = np.array([math.pi, 0.0])

    def goal(x):
        return x - torch.tensor(xg, dtype=x.dtype, device=x.device)

    objective = [
        *[(lambda x, u, w: goal(x) @ goal(x) + 0.01 * u @ u)] * (horizon - 1),
        lambda x, u, w: 10.0 * goal(x) @ goal(x),
    ]
    ts = calipso_tpu_torch.TrajOptSolver(
        objective, [pend_d] * (horizon - 1), [2] * horizon, [1] * (horizon - 1),
        equality=[lambda x, u, w: x - w, *[None] * (horizon - 1)],
        parameters=[np.zeros(2)] + [np.zeros(0)] * (horizon - 1),
        options=calipso_tpu_torch.Options(line_search_mode="serial"), device="cpu",
    )
    guess = np.zeros(ts.num_variables)
    for t, idx in enumerate(ts._state_indices):
        guess[idx] = xg * t / (horizon - 1)

    def simulate(x, u):
        return x + 0.05 * pend_c(0.5 * (2 * x + 0.05 * pend_c(x, u)), u)

    return ts, guess, simulate


def test_mpc_rollout_matches_jax():
    x0s = np.array([[np.pi - 0.3, 0.0], [np.pi - 0.4, 0.3]])
    jts, jguess, jsim, _ = _pendulum_mpc(mode="serial")
    jctrl = jcontroller(jts, jguess, lambda x: x)
    want = [jrollout(jctrl, jsim, jnp.asarray(x0), num_steps=MPC_STEPS) for x0 in x0s]

    ts, guess, sim = _pendulum_mpc_torch()
    got = mpc_rollout(make_mpc_controller(ts, guess, lambda x: x), sim, torch.tensor(x0s), MPC_STEPS)
    assert got.states.shape == (2, MPC_STEPS, 2) and got.actions.shape == (2, MPC_STEPS, 1)
    assert bool(got.solved.all())
    for lane, w in enumerate(want):
        assert got.iterations[lane].tolist() == np.asarray(w.iterations).tolist()
        np.testing.assert_allclose(got.states[lane].numpy(), np.asarray(w.states), rtol=0, atol=STATE_ATOL)
        np.testing.assert_allclose(got.actions[lane].numpy(), np.asarray(w.actions), rtol=0, atol=STATE_ATOL)
    # tests/test_mpc.py: warm-started steps cheaper than the cold start
    its = got.iterations.numpy()
    assert (its[:, 1:].mean(axis=1) <= its[:, 0]).all(), its


def test_mpc_warmstart_beats_cold():
    """tests/test_mpc.py:test_mpc_warmstart_beats_cold in the port: with
    warmstart=False every step starts from the guess; the first steps
    agree, and the warm steps are cheaper on average."""
    ts, guess, sim = _pendulum_mpc_torch()
    x0s = torch.tensor([[np.pi - 0.3, 0.0]], dtype=torch.float64)
    warm = mpc_rollout(make_mpc_controller(ts, guess, lambda x: x), sim, x0s, MPC_STEPS)
    cold = mpc_rollout(make_mpc_controller(ts, guess, lambda x: x, warmstart=False), sim, x0s, MPC_STEPS)
    assert bool(warm.solved.all()) and bool(cold.solved.all())
    assert int(warm.iterations[0, 0]) == int(cold.iterations[0, 0])
    assert warm.iterations[0, 1:].float().mean() < cold.iterations[0, 1:].float().mean()


# ---- auto-tuning ------------------------------------------------------------


A = jtests.A
B = jtests.B


def _linear_policy_torch():
    """tests/test_autotuning.py:_policy in the port."""
    T = jtests.HORIZON_MPC
    At, Bt = torch.tensor(A), torch.tensor(B)

    def dyn(y, x, u, w):
        return y - (At.to(x) @ x + Bt.to(x) * u[0])

    def stage_cost(x, u, w):
        return 0.5 * x @ (w[:2] * x) + 0.5 * w[2] * (u @ u)

    def final_cost(x, u, w):
        return 0.5 * x @ (w[:2] * x)

    ts = calipso_tpu_torch.TrajOptSolver(
        [lambda x, u, w: 0.5 * x @ (w[:2] * x) + 0.5 * w[2] * (u @ u), *[stage_cost] * (T - 2), final_cost],
        [dyn] * (T - 1), [2] * T, [1] * (T - 1),
        equality=[lambda x, u, w: x - w[3:5], *[None] * (T - 1)],
        parameters=[np.array([1.0, 1.0, 0.1, 0.0, 0.0])] + [np.array([1.0, 1.0, 0.1])] * (T - 2)
        + [np.array([10.0, 10.0])],
        options=calipso_tpu_torch.Options(
            residual_tolerance=1e-8, equality_tolerance=1e-7, complementarity_tolerance=1e-7,
            line_search_mode="serial",
        ),
        device="cpu",
    )

    def theta_builder(weights, state):
        ten = torch.full((2,), 10.0, dtype=weights.dtype, device=weights.device)
        return torch.cat([weights, state] + [weights] * (T - 2) + [ten])

    pol = ttune.make_mpc_policy(ts, np.zeros(ts.num_variables), theta_builder, ts._action_indices[0], 3)
    sim = lambda x, u: At.to(x) @ x + Bt.to(x) * u[0]
    loss = ttune.rollout_loss(pol.policy, sim, 8, np.eye(2), 0.01 * np.eye(1), np.zeros(2), np.zeros(1))
    return pol, loss


def _linear_policy_jax():
    _, pol = jtests._policy()
    sim = lambda x, u: jnp.asarray(A) @ x + jnp.asarray(B) * u[0]
    return jtune.rollout_loss(pol.policy, sim, 8, np.eye(2), 0.01 * np.eye(1), np.zeros(2), np.zeros(1))


def test_linear_policy_gradient():
    """The loss's gradient by loss.backward() through the differentiable
    solve: central differences within the reference test's bound
    (5e-3 relative) and jax.grad of the reference's loss to 1e-7."""
    _, loss = _linear_policy_torch()
    w0 = torch.tensor([1.0, 1.0, 0.1], dtype=torch.float64, requires_grad=True)
    x0 = torch.tensor([[1.0, 0.0]], dtype=torch.float64)
    value = loss(w0, x0)
    value.backward()
    g = w0.grad.numpy()
    jloss = _linear_policy_jax()
    want = np.asarray(jax.grad(jloss)(jnp.array([1.0, 1.0, 0.1]), jnp.array([1.0, 0.0])))
    assert np.abs(g - want).max() <= HISTORY_RTOL * np.abs(want).max(), (g, want)
    eps = 1e-5
    with torch.no_grad():
        for i in range(3):
            e = torch.zeros(3, dtype=torch.float64)
            e[i] = eps
            fd = float(loss(w0 + e, x0) - loss(w0 - e, x0)) / (2 * eps)
            assert abs(g[i] - fd) < 5e-3 * max(1.0, abs(fd)), (i, g[i], fd)


def test_autotune_history_matches_jax():
    """tests/test_autotuning.py:test_autotune_reduces_loss in both
    packages: the loss falls and its history is the reference's."""
    _, loss = _linear_policy_torch()
    x0 = torch.tensor([[1.0, 0.0]], dtype=torch.float64)
    w, history = ttune.autotune(loss, torch.tensor([1.0, 1.0, 1.0], dtype=torch.float64), x0, max_iterations=4)
    _, want = jtune.autotune(_linear_policy_jax(), jnp.array([1.0, 1.0, 1.0]), jnp.array([1.0, 0.0]), max_iterations=4)
    assert history[-1] < history[0], history
    assert len(history) == len(want)
    np.testing.assert_allclose(history, want, rtol=HISTORY_RTOL, atol=0)


def test_rollout_loss_is_the_lane_mean():
    """With B lanes the loss is the mean of the lanes' losses, and each
    lane's is its loss alone."""
    _, loss = _linear_policy_torch()
    w = torch.tensor([1.0, 1.0, 0.1], dtype=torch.float64)
    x0s = torch.tensor([[1.0, 0.0], [0.5, -0.2]], dtype=torch.float64)
    with torch.no_grad():
        both = float(loss(w, x0s))
        one = [float(loss(w, x0s[i : i + 1])) for i in range(2)]
    assert abs(both - 0.5 * sum(one)) <= 1e-12 * abs(both)


def _cartpole_tuning(pkg):
    """The cart-pole MPC tuning of tests/test_autotuning.py in package
    `pkg`: (loss, w0, x0)."""
    T = 4
    if pkg == "jax":
        from calipso_tpu.models import cartpole

        Pk, cat, ones = calipso_tpu, jnp.concatenate, lambda w: 10.0 * jnp.ones(4)
        w0, x0 = jnp.array([1.0, 1.0, 1.0, 1.0]), jnp.array([0.1, np.pi - 0.2, 0.0, 0.0])
        extra, make_policy, rollout = {}, jtune.make_mpc_policy, jtune.rollout_loss
    else:
        from calipso_tpu_torch.models import cartpole

        Pk, cat = calipso_tpu_torch, torch.cat
        ones = lambda w: torch.full((4,), 10.0, dtype=w.dtype, device=w.device)
        w0 = torch.ones(4, dtype=torch.float64)
        x0 = torch.tensor([[0.1, np.pi - 0.2, 0.0, 0.0]], dtype=torch.float64)
        extra, make_policy, rollout = dict(device="cpu"), ttune.make_mpc_policy, ttune.rollout_loss

    def stage_cost(x, u, w):
        return 0.5 * x @ (w[:4] * x) + 0.05 * (u @ u)

    def final_cost(x, u, w):
        return 0.5 * x @ (w[:4] * x)

    opts = Pk.Options(residual_tolerance=1e-6, equality_tolerance=1e-6, complementarity_tolerance=1e-6,
                      line_search_mode="serial")
    ts = Pk.TrajOptSolver(
        [lambda x, u, w: 0.5 * x @ (w[:4] * x) + 0.05 * (u @ u), *[stage_cost] * (T - 2), final_cost],
        [cartpole.discrete] * (T - 1), [4] * T, [1] * (T - 1),
        equality=[lambda x, u, w: x - w[4:8], *[None] * (T - 1)],
        parameters=[np.concatenate([np.ones(4), np.zeros(4)])] + [np.ones(4)] * (T - 2) + [10.0 * np.ones(4)],
        options=opts, **extra,
    )
    theta_builder = lambda weights, state: cat([weights, state] + [weights] * (T - 2) + [ones(weights)])
    pol = make_policy(ts, np.zeros(ts.num_variables), theta_builder, ts._action_indices[0], 4)

    def sim(x, u):
        y = x + 0.05 * cartpole.continuous(x, u)
        for _ in range(3):
            y = x + 0.05 * cartpole.continuous(0.5 * (x + y), u)
        return y

    loss = rollout(pol.policy, sim, 5, np.diag([1.0, 5.0, 0.1, 0.1]), 0.01 * np.eye(1),
                   np.array([0.0, np.pi, 0.0, 0.0]), np.zeros(1))
    return loss, w0, x0


@pytest.mark.heavy
def test_cartpole_autotuning_matches_jax():
    """tests/test_autotuning.py:test_cartpole_mpc_autotuning in both
    packages (max_iterations=3): the loss falls, with the reference's
    history."""
    loss, w0, x0 = _cartpole_tuning("torch")
    _, history = ttune.autotune(loss, w0, x0, max_iterations=3)
    assert history[-1] < history[0], history
    jloss, jw0, jx0 = _cartpole_tuning("jax")
    _, want = jtune.autotune(jloss, jw0, jx0, max_iterations=3)
    assert len(history) == len(want)
    np.testing.assert_allclose(history, want, rtol=HISTORY_RTOL, atol=0)
