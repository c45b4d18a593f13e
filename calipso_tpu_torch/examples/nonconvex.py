"""Non-convex NLP examples (`examples/nonconvex.py`; reference
examples/nonconvex/{wachter,maratos,complementarity}.jl): three classic
hard small problems solved with verbose output, each a single `Solver`
solve on the schur backend (the T=1 kernels at B = 1, n = 3, 2 and 6).

Run:  python -m calipso_tpu_torch.examples.nonconvex [--cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from calipso_tpu_torch import Options, Solver, empty_constraint


def _outcome(solver, res):
    return {
        "solved": bool(res.solved),
        "iterations": int(res.iterations),
        "variables": res.variables.detach().cpu().numpy(),
        "solver": solver,
        "result": res,
    }


def wachter(device="cuda"):
    """Wächter's counterexample: vanilla line-search IPMs stall; the filter
    + slack reset handles it (x* = [1, 0, 0.5])."""
    solver = Solver(
        lambda x: x[0],
        lambda x: torch.stack([x[0] ** 2 - x[1] - 1.0, x[0] - x[2] - 0.5]),
        lambda x: x[1:3],
        3,
        options=Options(verbose=True, print_frequency=5),
        device=device,
    )
    res = solver.solve(torch.tensor([-2.0, 3.0, 1.0], dtype=torch.float64))
    out = _outcome(solver, res)
    assert out["solved"]
    np.testing.assert_allclose(out["variables"], [1.0, 0.0, 0.5], atol=1e-3)
    return out


def maratos(device="cuda"):
    """The Maratos effect problem: full steps get rejected by naive merit
    functions near the solution (x* = [1, 0])."""
    solver = Solver(
        lambda x: 2.0 * (x[0] ** 2 + x[1] ** 2 - 1.0) - x[0],
        lambda x: torch.stack([x[0] ** 2 + x[1] ** 2 - 1.0]),
        empty_constraint,
        2,
        options=Options(verbose=True, print_frequency=5),
        device=device,
    )
    res = solver.solve(torch.tensor([2.0, 1.0], dtype=torch.float64))
    out = _outcome(solver, res)
    assert out["solved"]
    np.testing.assert_allclose(out["variables"], [1.0, 0.0], atol=1e-3)
    return out


def complementarity(device="cuda"):
    """Knitro's mixed-complementarity example: x >= 0 complementary to
    F(x) >= 0, formulated with slack pairs (reference complementarity.jl)."""

    def cone(x):
        # x[:3] >= 0 and the three complementarity residuals as slacks
        return torch.cat([x[:3], x[3:6]])

    def eq(x):
        f1 = -x[0] - x[1] + x[2] + 2.0
        f2 = x[0] - 2.0 * x[2] + 1.0
        f3 = x[0] + x[1] + 2.0 * x[2] - 6.0
        # slack definitions + complementarity products
        return torch.stack(
            [
                x[3] - f1,
                x[4] - f2,
                x[5] - f3,
                x[0] * x[3] + x[1] * x[4] + x[2] * x[5],
            ]
        )

    solver = Solver(
        lambda x: (x[0] - 1.0) ** 2 + (x[2] - 1.5) ** 2,
        eq,
        cone,
        6,
        options=Options(verbose=True, print_frequency=10),
        device=device,
    )
    res = solver.solve(torch.ones(6, dtype=torch.float64))
    out = _outcome(solver, res)
    assert out["solved"]
    print("complementarity solution:", np.round(out["variables"][:3], 4))
    return out


PROBLEMS = {"wachter": wachter, "maratos": maratos, "complementarity": complementarity}


def main(device="cuda"):
    """Solve the three problems in the script's order; {name: outcome}."""
    return {name: fn(device) for name, fn in PROBLEMS.items()}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else "cuda")
