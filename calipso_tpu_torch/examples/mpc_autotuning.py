"""Cart-pole MPC auto-tuning (`examples/mpc_autotuning.py`): learn MPC
cost weights by gradient descent on a closed-loop rollout loss, the
gradient from `loss.backward()` through the solver's implicit
differentiation (counterpart of the reference's hand-written chain rule,
examples/autotuning/{autotuning,cartpole}.jl). Each policy evaluation is
a T=4 solve on schur (n = 19: the T=1 kernels), one lane, float64.

Run:  python -m calipso_tpu_torch.examples.mpc_autotuning [--cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from calipso_tpu_torch import Options, TrajOptSolver
from calipso_tpu_torch.apps import autotuning
from calipso_tpu_torch.models import cartpole
from calipso_tpu_torch.models.constants import Const

T, nx, nu = 4, 4, 1  # short MPC horizon: every policy eval is a full solve
_TERMINAL = Const(10.0 * np.ones(4))


def stage_cost(x, u, w):
    return 0.5 * x @ (w[:4] * x) + 0.05 * (u @ u)


def build(device="cuda"):
    """The script's tuning problem: (rollout loss, w0, x0 (1, nx), policy)."""
    objective = [stage_cost] * (T - 1) + [lambda x, u, w: 0.5 * x @ (w[:4] * x)]
    equality = [lambda x, u, w: x - w[4:8], *[None] * (T - 1)]
    parameters = (
        [np.concatenate([np.ones(4), np.zeros(4)])]
        + [np.ones(4)] * (T - 2)
        + [10.0 * np.ones(4)]
    )
    ts = TrajOptSolver(
        objective,
        [cartpole.discrete] * (T - 1),
        [nx] * T,
        [nu] * (T - 1),
        equality=equality,
        parameters=parameters,
        options=Options(residual_tolerance=1e-6, equality_tolerance=1e-6,
                        complementarity_tolerance=1e-6),
        device=device,
    )

    def theta_builder(weights, state):
        return torch.cat([weights, state] + [weights] * (T - 2) + [_TERMINAL.like(weights)])

    pol = autotuning.make_mpc_policy(
        ts,
        guess=np.zeros(ts.num_variables),
        theta_builder=theta_builder,
        action_indices=ts._action_indices[0],
        num_weights=4,
    )

    def sim(x, u):  # implicit-midpoint plant via fixed-point iteration
        y = x + 0.05 * cartpole.continuous(x, u)
        for _ in range(3):
            y = x + 0.05 * cartpole.continuous(0.5 * (x + y), u)
        return y

    loss = autotuning.rollout_loss(
        pol.policy,
        sim,
        horizon=5,
        state_cost=np.diag([1.0, 5.0, 0.1, 0.1]),
        action_cost=0.01 * np.eye(1),
        state_reference=np.array([0.0, np.pi, 0.0, 0.0]),
        action_reference=np.zeros(1),
    )
    w0 = torch.ones(4, dtype=torch.float64, device=ts.solver.device)
    x0 = torch.tensor([[0.1, np.pi - 0.2, 0.0, 0.0]], dtype=torch.float64, device=ts.solver.device)
    return loss, w0, x0, pol


def main(device="cuda", max_iterations=5):
    """Tune; {"weights0", "weights", "history", "policy"}."""
    loss, w0, x0, pol = build(device)
    w_tuned, history = autotuning.autotune(loss, w0, x0, max_iterations=max_iterations, verbose=True)
    w0, w_tuned = w0.cpu().numpy(), w_tuned.cpu().numpy()
    print(f"weights {w0} -> {np.round(w_tuned, 3)}")
    print(f"rollout loss {history[0]:.5f} -> {history[-1]:.5f}")
    assert history[-1] < history[0]
    return {"weights0": w0, "weights": w_tuned, "history": history, "policy": pol}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else "cuda")
