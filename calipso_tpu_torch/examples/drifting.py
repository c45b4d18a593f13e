"""Cybertruck drift parking (`examples/drifting.py`; reference
examples/contact_implicit/drifting.jl): plan a drift into a parking pose
with four contact points, friction-cone forces and contact
complementarity, on schur at n = 286 (past the T=1 kernels' width: the
library route on the card), in float64. The reference notes the problem
is schedule-sensitive ("may need to run more than once",
drifting.jl:125); the script pins the converging configuration of the
JAX package's test suite (schur backend, 1e-3 contract).

Run:  python -m calipso_tpu_torch.examples.drifting [--cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from calipso_tpu_torch import Options, TrajOptSolver
from calipso_tpu_torch.models import cyberdrift

OPTIONS = Options(
    residual_tolerance=1e-3,
    optimality_tolerance=1e-3,
    equality_tolerance=1e-3,
    complementarity_tolerance=1e-3,
    slack_tolerance=1e-3,
    penalty_initial=10.0,
    linear_solver="schur",
)


def build(device="cuda", options=OPTIONS):
    """The script's problem, options and guess: (TrajOptSolver, problem)."""
    prob = cyberdrift.drift_problem()
    kw = {
        k: v
        for k, v in prob.items()
        if k not in ("state_guess", "state_initial", "state_goal", "action_guess", "penalty_initial")
    }
    ts = TrajOptSolver(options=options, device=device, **kw)
    ts.initialize_states(prob["state_guess"])
    rng = np.random.default_rng(1)
    ts.initialize_actions(
        [
            np.concatenate([1e-3 * rng.normal(size=2), np.tile([1.0, 0.1, 0.1], 4)])
            for _ in range(14)
        ]
    )
    return ts, prob


def solve(device="cuda", inner=None, options=OPTIONS):
    """Build and solve, without the script's assertions; `inner`, when
    given, is installed as the solver's per-step callback. Returns
    {"solved", "iterations", "seconds", "pose_error", "final_pose",
    "variables", "solver", "result"}."""
    ts, prob = build(device, options)
    if inner is not None:
        ts.solver.callbacks(inner=inner)
    t0 = time.time()
    res = ts.solve()
    if ts.solver.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    states, _ = ts.get_trajectory(res)
    goal = np.asarray(prob["state_goal"])
    return {
        "solved": bool(res.solved),
        "iterations": int(res.iterations),
        "seconds": wall,
        "pose_error": float(np.abs(states[-1][0:3] - goal[0:3]).max()),
        "final_pose": states[-1][0:3],
        "variables": res.variables.detach().cpu().numpy(),
        "solver": ts,
        "result": res,
    }


def main(device="cuda"):
    """The script: solve, then its two assertions."""
    out = solve(device)
    assert out["solved"], "drift solve failed"
    print(
        f"drift parked: {out['iterations']} iterations, final pose error {out['pose_error']:.4f} "
        f"(x, y, yaw = {np.round(out['final_pose'], 3)})"
    )
    assert out["pose_error"] < 1e-2
    print("ok")
    return out


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else "cuda")
