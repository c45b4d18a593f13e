"""Rocket soft landing with a second-order-cone thrust constraint
(`examples/rocket_landing.py`; reference test/examples/rocket_landing.jl:
T=101, 903 variables, 100 three-dimensional SOCs), on the cr backend,
in float64 with the script's non-TPU tolerances (1e-4, iterative
refinement to 1e-10 in at most 10 steps).

Run:  python -m calipso_tpu_torch.examples.rocket_landing [--cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from calipso_tpu_torch import Options, TrajOptSolver
from calipso_tpu_torch.models import rocket

TOL = 1e-4


def options():
    """The script's options off a TPU."""
    return Options(
        residual_tolerance=TOL, optimality_tolerance=TOL, slack_tolerance=TOL,
        equality_tolerance=TOL, complementarity_tolerance=TOL,
        iterative_refinement_tolerance=1e-10,
        max_iterative_refinement=10,
        linear_solver="cr",  # parallel-in-time factorization: best single-solve backend
    )


def main(device="cuda"):
    """Solve the landing; {"solved", "iterations", "seconds",
    "final_position_error", "min_cone_margin", "variables", "solver",
    "result"}."""
    prob = rocket.landing_problem(horizon=101)
    kw = {k: v for k, v in prob.items() if k not in ("state_guess", "state_initial", "state_goal")}
    ts = TrajOptSolver(options=options(), device=device, **kw)
    ts.initialize_states(prob["state_guess"])
    rng = np.random.default_rng(0)
    ts.initialize_actions([1e-3 * rng.normal(size=3) for _ in range(100)])

    t0 = time.time()
    res = ts.solve()
    if ts.solver.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    print(f"solved={bool(res.solved)} iterations={int(res.iterations)} wall={wall:.2f}s")

    states, actions = ts.get_trajectory(res)
    # the thrust stays inside the cone at every stage (reference
    # rocket_landing.jl:82 checks the same property)
    margins = [float(u[2] - np.linalg.norm(u[:2])) for u in actions]
    position = float(np.linalg.norm(np.asarray(states[-1])[:3]))
    print(f"final position error: {position:.2e}")
    print(f"min thrust-cone margin u3 - |u12|: {min(margins):.3e} (> 0)")
    assert bool(res.solved) and min(margins) > -1e-6
    return {
        "solved": bool(res.solved),
        "iterations": int(res.iterations),
        "seconds": wall,
        "final_position_error": position,
        "min_cone_margin": min(margins),
        "variables": res.variables.detach().cpu().numpy(),
        "solver": ts,
        "result": res,
    }


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else "cuda")
