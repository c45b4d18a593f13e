"""Acrobot MPC auto-tuning (`examples/autotuning_acrobot.py`; reference
examples/autotuning/acrobot.jl), in float64:

1. solve the reference swing-up trajectory with the full-horizon trajopt
   solver (H=31: riccati at stage width d = 5, the lanes kernels);
2. build a short-horizon MPC policy (T=4, schur at n = 19: the T=1
   kernels) whose stage cost log-weights are the learnable parameters,
   differentiable through the solver's implicit differentiation;
3. descend the closed-loop rollout tracking loss against the reference
   tail (reference autotuning.jl:124-170 autotune!).

Run:  python -m calipso_tpu_torch.examples.autotuning_acrobot [--cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from calipso_tpu_torch import Options, TrajOptSolver, linear_interpolation
from calipso_tpu_torch.apps import autotuning
from calipso_tpu_torch.models import acrobot
from calipso_tpu_torch.models.constants import Const

H, nx, nu = 31, 4, 1
T = 4  # MPC horizon: every policy evaluation is a full contact-free solve
T0, R = 24, 6  # the rollout starts on the reference near the top, R steps
STATE_INITIAL = np.zeros(4)
STATE_GOAL = np.array([np.pi, 0.0, 0.0, 0.0])
_INITIAL, _GOAL, _TERMINAL = Const(STATE_INITIAL), Const(STATE_GOAL), Const(10.0 * np.ones(4))


def swingup(device="cuda"):
    """Part 1, the reference swing-up (reference acrobot.jl horizon=101;
    shorter here): {"solved", "iterations", "seconds", "states",
    "actions", "solver", "result"}."""
    objective = [lambda x, u, w: 1.0 * x[2:] @ x[2:] + 1.0 * u @ u] * (H - 1) + [
        lambda x, u, w: 1.0 * x[2:] @ x[2:]
    ]
    equality = [
        lambda x, u, w: x - _INITIAL.like(x),
        *[None] * (H - 2),
        lambda x, u, w: x - _GOAL.like(x),
    ]
    ref = TrajOptSolver(
        objective,
        [acrobot.discrete] * (H - 1),
        [nx] * H,
        [nu] * (H - 1),
        equality=equality,
        options=Options(),
        device=device,
    )
    ref.initialize_states(linear_interpolation(STATE_INITIAL, STATE_GOAL, H))
    ref.initialize_actions([0.11 * np.ones(nu)] * (H - 1))
    t0 = time.time()
    res = ref.solve()
    if ref.solver.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    states, actions = ref.get_trajectory(res)
    return {
        "solved": bool(res.solved), "iterations": int(res.iterations), "seconds": wall,
        "states": states, "actions": actions, "solver": ref, "result": res,
    }


def stage_cost(x, u, w):
    dx = x - _GOAL.like(x)
    return 0.5 * dx @ (w[:4] * dx) + 0.05 * (u @ u)


def terminal_cost(x, u, w):
    dx = x - _GOAL.like(x)
    return 0.5 * dx @ (w[:4] * dx)


def tuning(state_ref, action_ref, device="cuda"):
    """Parts 2 and 3's problem: (rollout loss, w0, x0 (1, nx), policy)."""
    mpc = TrajOptSolver(
        [stage_cost] * (T - 1) + [terminal_cost],
        [acrobot.discrete] * (T - 1),
        [nx] * T,
        [nu] * (T - 1),
        equality=[lambda x, u, w: x - w[4:8], *[None] * (T - 1)],
        parameters=[np.concatenate([np.ones(4), np.zeros(4)])]
        + [np.ones(4)] * (T - 2)
        + [10.0 * np.ones(4)],
        options=Options(
            residual_tolerance=1e-6, equality_tolerance=1e-6, complementarity_tolerance=1e-6
        ),
        device=device,
    )

    def theta_builder(log_weights, state):
        # tune log-weights: keeps every stage cost PSD, so a gradient step
        # can never hand the MPC an indefinite objective
        weights = torch.exp(log_weights)
        return torch.cat([weights, state] + [weights] * (T - 2) + [_TERMINAL.like(weights)])

    pol = autotuning.make_mpc_policy(
        mpc,
        guess=np.zeros(mpc.num_variables),
        theta_builder=theta_builder,
        action_indices=mpc._action_indices[0],
        num_weights=4,
    )
    xref_tail = np.stack(state_ref[T0 : T0 + R])
    uref_tail = np.concatenate([np.stack(action_ref[T0 : T0 + R - 1]), np.zeros((1, 1))])

    def sim(x, u):  # implicit-midpoint plant via fixed-point iteration
        y = x + 0.05 * acrobot.continuous(x, u)
        for _ in range(3):
            y = x + 0.05 * acrobot.continuous(0.5 * (x + y), u)
        return y

    loss = autotuning.rollout_loss(
        pol.policy,
        sim,
        horizon=R,
        state_cost=np.diag([10.0, 10.0, 1.0, 1.0]),
        action_cost=0.01 * np.eye(1),
        state_reference=xref_tail,
        action_reference=uref_tail,
    )
    dev = mpc.solver.device
    w0 = torch.zeros(4, dtype=torch.float64, device=dev)  # exp(0): the untuned unit weights
    x0 = torch.tensor((np.asarray(state_ref[T0]) + np.array([0.05, -0.05, 0.0, 0.0]))[None], dtype=torch.float64, device=dev)
    return loss, w0, x0, pol


def main(device="cuda", max_iterations=5):
    """The script: {"swingup": swingup's outcome, "weights0", "weights",
    "history", "seconds" (the tuning's), "policy"}."""
    ref = swingup(device)
    assert ref["solved"], "reference swing-up failed"
    print(f"reference swing-up solved: {ref['iterations']} iterations")
    loss, w0, x0, pol = tuning(ref["states"], ref["actions"], device)
    t0 = time.time()
    w_tuned, history = autotuning.autotune(loss, w0, x0, max_iterations=max_iterations, verbose=True)
    wall = time.time() - t0
    w0, w_tuned = w0.cpu().numpy(), w_tuned.cpu().numpy()
    print(f"weights {np.exp(w0)} -> {np.round(np.exp(w_tuned), 3)}")
    print(f"rollout loss {history[0]:.5f} -> {history[-1]:.5f}")
    assert history[-1] < history[0], "auto-tuning did not reduce the rollout loss"
    print("ok")
    return {"swingup": ref, "weights0": w0, "weights": w_tuned, "history": history, "seconds": wall, "policy": pol}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else "cuda")
