"""Receding-horizon MPC: warm-started repeated trajopt solves in a closed
loop, B scenarios at once.

The counterpart of `calipso_tpu/apps/mpc.py`. The measured state enters
through a stage parameter, so one solver serves every control step, and
the previous step's primal-dual point (`Blocks`) is the next step's
starting iterate (`Options.warmstart`). The reference's closed loop is a
`lax.scan` over one scenario (batched by `vmap`); here it is a host loop
over the control steps, each step one batched solve of all B scenarios,
the lane axis first. The plant and the parameter builder are written for
one lane, as every user callable of the port is (`solver/problem.py`),
and mapped over the lanes with `torch.func.vmap`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from calipso_tpu_torch.solver.api import solve_fn
from calipso_tpu_torch.solver.kkt import Blocks


class MPCStep(NamedTuple):
    """Per-control-step telemetry of a rollout, lanes first."""

    states: torch.Tensor  # (B, steps, nx) measured states
    actions: torch.Tensor  # (B, steps, nu) applied first-stage actions
    solved: torch.Tensor  # (B, steps) convergence flags
    iterations: torch.Tensor  # (B, steps) iteration counts


def make_mpc_controller(trajopt_solver, guess, theta_builder: Callable, *, warmstart: bool = True):
    """Build an MPC step `(states (B, nx), warm) -> (actions (B, nu), warm',
    solved (B,), iterations (B,))`.

    trajopt_solver: a TrajOptSolver whose stage-0 equality pins the state
        to a parameter (e.g. ``lambda x, u, w: x - w``); the steps run on
        its device.
    guess: flat variable guess (n,) of the cold (first) solve.
    theta_builder: maps one lane's measured state to its flat parameter
        vector (stage-major order).
    warmstart: start each solve from the previous step's primal-dual point
        (pass ``warm=None`` on the first call, then the returned carry)."""
    solver = trajopt_solver.solver
    opts = solver.options.replace(warmstart=warmstart)
    run = solve_fn(solver.fns, solver.layout, opts)
    device = solver.device
    a_idx = torch.as_tensor(np.asarray(trajopt_solver._action_indices[0]), device=device)
    guess = torch.as_tensor(np.asarray(guess, dtype=float))
    build = vmap(theta_builder)

    def step(states, warm=None):
        states = states.to(device)
        theta = build(states)
        res = run(guess.to(device=device, dtype=theta.dtype).expand(states.shape[0], -1).contiguous(), theta, warm)
        st = res.state
        return st.p.x[:, a_idx], st.p, st.solved, st.total_i

    step.stats = run.stats
    return step


def mpc_rollout(controller, simulate: Callable, x0, num_steps: int) -> MPCStep:
    """Closed-loop rollout of B scenarios: a cold solve at x0 (B, nx), then
    `num_steps - 1` warm-started steps. `simulate(x, u) -> x_next`, the
    plant for one lane (it need not match the controller's model), is
    mapped over the lanes. A step that did not converge shows in `solved`,
    never as an exception."""
    sim = vmap(simulate)
    x = x0
    warm = None
    xs, us, ss, its = [], [], [], []
    for _ in range(num_steps):
        u, warm, solved, iters = controller(x, warm)
        xs.append(x)
        us.append(u)
        ss.append(solved)
        its.append(iters)
        x = sim(x, u)
    stack = lambda v: torch.stack(v, dim=1)
    return MPCStep(stack(xs), stack(us), stack(ss), stack(its))
