"""User-facing solver API: `solve_fn`, `Solver`, `SolveResult`.

The counterpart of `calipso_tpu/solver/api.py`. The functional core
`solve_fn` is batch-first: its closure takes x0 (B, n) and theta (B, p)
and returns a SolveResult whose every field carries the lane axis. A
`Solver.solve` is a batch of one, returned without the lane axis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from calipso_tpu_torch.options import Options
from calipso_tpu_torch.ops.cones import ConeLayout
from calipso_tpu_torch.solver.kkt import Blocks
from calipso_tpu_torch.solver.problem import ProblemFunctions
from calipso_tpu_torch.solver.solve import State, make_solve, resolve_options


class SolveResult(NamedTuple):
    state: State
    sensitivity: torch.Tensor  # (..., total, num_parameters); zeros (not ported)

    @property
    def variables(self):
        return self.state.p.x

    @property
    def solution(self) -> Blocks:
        return self.state.p

    @property
    def solved(self):
        return self.state.solved

    @property
    def iterations(self):
        return self.state.total_i


def solve_fn(fns, layout: ConeLayout, opts: Options, callbacks=None):
    """Functional batched solve: (x0 (B, n), theta (B, p) or None, warm)
    -> SolveResult with a leading lane axis. The closure carries `stats`
    (see `make_solve`)."""
    core = make_solve(fns, layout, opts, callbacks)

    def run(x0, theta=None, warm=None) -> SolveResult:
        state = core(x0, theta, warm)
        sens = x0.new_zeros((x0.shape[0], fns.dims.total, fns.dims.parameters))
        return SolveResult(state, sens)

    run.stats = core.stats
    return run


def resolve_device(device="cuda") -> torch.device:
    """The device a solver runs on: the card unless the caller names
    another. Without a CUDA device, asking for the card raises: a solve
    never falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the solver runs on the GPU unless asked otherwise; "
            "pass device='cpu' to solve on the CPU"
        )
    return device


def _print_banner(dims, opts):
    print("-" * 72)
    print("CALIPSO-TPU (torch)  conic augmented-Lagrangian interior-point solver")
    print(
        f"variables {dims.variables}  equality {dims.equality}  cone {dims.cone}"
        f"  parameters {dims.parameters}"
    )
    print(
        f"linear_solver {opts.linear_solver}  line_search {opts.line_search_mode}"
        f"  differentiate {opts.differentiate}"
    )
    print("-" * 72)


def _print_status(result, dims, opts):
    st = result.state
    print("-" * 72)
    print(f"solution gradients: {opts.differentiate}")
    print(f"solve status:       {'success' if bool(st.solved) else 'failure'}")
    print(
        f"iterations:         {int(st.total_i)} "
        f"(outer {int(st.outer_i)}, LU fallbacks {int(st.num_fallbacks)})"
    )
    print(
        f"violations:         residual {float(st.residual_violation):.2e}  "
        f"equality {float(st.equality_violation):.2e}  "
        f"comp {float(st.cone_product_violation):.2e}  "
        f"slack {float(st.slack_violation):.2e}"
    )
    if dims.variables < 10:
        print(f"solution:           {np.round(result.variables.cpu().numpy(), 3)}")
    print("-" * 72)


def _lane(tree, i):
    """Drop the lane axis: element i of every tensor of a result tree."""
    if isinstance(tree, tuple):
        return type(tree)(*(_lane(a, i) for a in tree))
    return tree[i]


class Solver:
    """Conic AL-IPM solver for
        min_x c(x; theta)  s.t.  g(x; theta) = 0,  h(x; theta) in K,
    with the callables written in torch for one unbatched x (see
    `solver/problem.py` for the rules).

    Example (the Wachter problem):
        solver = Solver(lambda x: x[0],
                        lambda x: torch.stack([x[0]**2 - x[1] - 1, x[0] - x[2] - 0.5]),
                        lambda x: x[1:3], 3)
        solver.initialize(torch.tensor([-2.0, 3.0, 1.0], dtype=torch.float64))
        result = solver.solve()

    The solve runs on `device` (the card unless asked otherwise; every
    input is moved there) in the dtype of x0 (or of `parameters`, when x0
    is the stored initial guess)."""

    def __init__(
        self,
        objective,
        equality,
        cone,
        num_variables: int,
        *,
        parameters=None,
        num_parameters: Optional[int] = None,
        nonnegative_indices=None,
        second_order_indices=None,
        options: Options = Options(),
        device="cuda",
        _fns=None,  # pre-built (structured) problem functions
    ):
        self.device = resolve_device(device)
        if parameters is not None:
            parameters = torch.as_tensor(parameters).reshape(-1)
            num_parameters = parameters.shape[0]
        self.parameters = parameters
        npar = int(num_parameters or 0)
        self.fns = _fns if _fns is not None else ProblemFunctions(
            objective, equality, cone, num_variables, npar
        )
        self.layout = ConeLayout(self.fns.dims.cone, nonnegative_indices, second_order_indices)
        self.options = resolve_options(options, self.fns)
        self.dims = self.fns.dims
        self._callbacks = None
        self._run = solve_fn(self.fns, self.layout, self.options)
        self._guess = None
        self._warm = None

    def callbacks(self, inner=None, outer=None):
        """Install host-side per-step / per-outer-iteration callbacks; each
        receives a dict of per-lane tensors."""
        self._callbacks = (inner, outer)
        self._run = solve_fn(self.fns, self.layout, self.options, self._callbacks)
        return self

    def initialize(self, x0):
        """Set the primal initial guess."""
        self._guess = torch.as_tensor(x0)
        return self

    def solve(self, x0=None, parameters=None, warm: Optional[Blocks] = None) -> SolveResult:
        theta = parameters if parameters is not None else self.parameters
        if x0 is None:
            x0 = self._guess
            if x0 is None:
                raise ValueError("no initial guess: call initialize(x0) or pass x0")
            if isinstance(parameters, torch.Tensor):
                x0 = x0.to(device=parameters.device, dtype=parameters.dtype)
        x0 = torch.as_tensor(x0).to(self.device)
        if theta is not None:
            theta = torch.as_tensor(theta).to(device=self.device, dtype=x0.dtype)[None]
        if warm is None and self.options.warmstart:
            warm = self._warm
        if warm is not None:
            warm = Blocks(*(torch.as_tensor(a).to(self.device)[None] for a in warm))
        if self.options.verbose:
            _print_banner(self.dims, self.options)
        result = _lane(self._run(x0[None], theta, warm), 0)
        if self.options.verbose:
            _print_status(result, self.dims, self.options)
        self._warm = result.state.p
        return result
