"""MPC auto-tuning: learn MPC cost weights by gradient descent on a
closed-loop rollout loss.

The counterpart of `calipso_tpu/apps/autotuning.py`. The gradient of the
loss comes from `loss.backward()` through the differentiable solve
(`solver/diffable.py`), in place of `jax.value_and_grad`; a rollout is a
host loop over its steps. The reference batches scenario rollouts with
`vmap`; here the B initial states are the solve's lanes, and the loss is
the mean of the B lanes' rollout losses (the reference's loss when B =
1). The policy's parameter builder and the plant are written for one lane
and mapped over the lanes with `torch.func.vmap`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from calipso_tpu_torch.solver.diffable import make_differentiable_solve


class MPCPolicy(NamedTuple):
    """policy(weights (nw,), states (B, nx)) -> actions (B, nu),
    differentiable in the weights; `solve` is the differentiable solve
    behind it (its `state` holds the last call's solved flags)."""

    policy: Callable
    num_weights: int
    solve: Callable


def make_mpc_policy(trajopt_solver, guess, theta_builder: Callable, action_indices, num_weights: int):
    """Wrap a trajopt solver into a differentiable MPC policy u = pi(weights,
    state): the first action of the solve with parameters
    theta_builder(weights, state), built for each lane. action_indices
    selects the first-stage action from the flat solution. The solves run
    on the trajopt solver's device, cold from `guess`."""
    solver = trajopt_solver.solver
    solve_w = make_differentiable_solve(solver.fns, solver.layout, solver.options)
    device = solver.device
    guess = torch.as_tensor(np.asarray(guess, dtype=float))
    idx = torch.as_tensor(np.asarray(action_indices), device=device)
    build = vmap(theta_builder, in_dims=(None, 0))

    def policy(weights, states):
        theta = build(weights, states)
        w = solve_w(theta, guess.to(device=device, dtype=theta.dtype))
        return w[:, idx]

    return MPCPolicy(policy, num_weights, solve_w)


def rollout_loss(policy, dynamics, horizon, state_cost, action_cost, state_reference, action_reference):
    """Closed-loop rollout loss L(weights, x0 (B, nx)): the mean over the
    lanes of (sum_t of 0.5 dx' Q dx + 0.5 du' R du, plus the final state's
    term) / horizon. dynamics(x, u) -> next state is the simulation model
    for one lane; policy gives u_t = pi(weights, x_t)."""
    arrays = [np.asarray(a, dtype=float) for a in (state_cost, action_cost, state_reference, action_reference)]

    def loss(weights, x0):
        Q, R, xref, uref = (torch.as_tensor(a, dtype=x0.dtype, device=x0.device) for a in arrays)
        at = lambda ref, t: ref[t] if ref.dim() > 1 else ref
        sim = vmap(dynamics)
        quad = lambda d, W: 0.5 * ((d @ W) * d).sum(dim=-1)
        x, total = x0, x0.new_zeros(x0.shape[0])
        for t in range(horizon - 1):
            u = policy(weights, x)
            xn = sim(x, u)
            total = total + quad(x - at(xref, t), Q) + quad(u - at(uref, t), R)
            x = xn
        total = total + quad(x - at(xref, -1), Q)
        return (total / horizon).mean()

    return loss


def autotune(loss, weights0, x0, *, max_iterations=10, gradient_tolerance=1.0e-3, max_linesearch=25, verbose=False):
    """Gradient descent with backtracking on the rollout loss (reference
    autotuning.jl:124-170). Returns (weights, the loss after each accepted
    step, the first entry at weights0)."""

    def value_and_grad(w):
        w = w.detach().requires_grad_(True)
        cost = loss(w, x0)
        cost.backward()
        return cost.detach(), w.grad.detach()

    weights = torch.as_tensor(weights0).detach().clone()
    cost, grad = value_and_grad(weights)
    history = [float(cost)]
    for i in range(max_iterations):
        if float(grad.abs().max()) < gradient_tolerance:
            break
        step = 1.0
        for _ in range(max_linesearch):
            with torch.no_grad():
                cost_cand = loss(weights - step * grad, x0)
            if float(cost_cand) < float(cost):
                break
            step *= 0.5
        else:
            break
        weights = weights - step * grad
        cost, grad = value_and_grad(weights)
        history.append(float(cost))
        if verbose:
            print(f"autotune iter {i}: cost {float(cost):.6f}")
    return weights, history
