"""Scenario batches: B independent solves in lockstep.

The counterpart of `calipso_tpu/parallel/batch.py`. The solver is
batch-first (see `solver/solve.py`), so a batch needs no transform: the
lane axis is the leading axis of every tensor. A batch runs on the
solver's device (the card unless asked otherwise), where every input is
moved. With `Options(differentiate=True)` a batch's result carries each
lane's sensitivity to its parameters, (B, total, p) (`solve_fn`).
`aot_save` / `aot_load` write and check a manifest of the kernel
libraries a batch's routes use (`utils/aot.py`); checkpoints, profiling
and iteration stats are in `utils/`. Sharding a batch over devices
(`mesh=`) is ROADMAP Queue 1 item 19.
"""

from __future__ import annotations

import torch

from calipso_tpu_torch.ops.cones import ConeLayout
from calipso_tpu_torch.options import Options
from calipso_tpu_torch.solver.api import SolveResult, resolve_device, solve_fn
from calipso_tpu_torch.solver.kkt import Blocks
from calipso_tpu_torch.solver.problem import ProblemFunctions


def _refuse_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError("mesh=: batch sharding is ROADMAP Queue 1 item 19")


class _Batched:
    """What both batched solvers share: the solve closure `_run`."""

    @property
    def stats(self):
        """Counters of the last solve ("host_syncs": loop tests)."""
        return self._run.stats

    def _dtype(self):
        """The dtype a solve takes when the caller names none: none for a
        BatchedSolver (the dtype of x0), whose aot_save takes float32 and
        aot_load the manifest's, as the reference's do."""
        return None

    def aot_save(self, path, batch_size, num_parameters=None, dtype=None):
        """Build, or find built, the kernel libraries this batch's routes
        use at `batch_size` lanes in `dtype` (the solver's natural dtype
        when None), and write their manifest to `path` (see
        `utils/aot.py`). Returns `path`."""
        from calipso_tpu_torch.utils import aot

        return aot.save(self, path, batch_size, num_parameters, dtype or self._dtype() or torch.float32)

    def aot_load(self, path, dtype=None):
        """Check the manifest at `path` against this process (its sources,
        dtype, routes, versions and environment) and load its libraries;
        raises ValueError naming the first field that differs or the
        library that is missing. `dtype` is the one solves will take (the
        solver's natural dtype when None). Returns self."""
        from calipso_tpu_torch.utils import aot

        aot.load(self, path, dtype or self._dtype())
        return self


class BatchedSolver(_Batched):
    """A whole conic solve over a leading batch axis of (x0, theta):

        bs = BatchedSolver(objective, equality, cone, n, num_parameters=p)
        results = bs.solve(x0_batch, theta_batch)

    The callables are torch functions of one lane (see
    `solver/problem.py`). The batch runs on `device` (the card unless
    asked otherwise) in the dtype of `x0_batch`."""

    def __init__(
        self,
        objective,
        equality,
        cone,
        num_variables: int,
        *,
        num_parameters: int = 0,
        nonnegative_indices=None,
        second_order_indices=None,
        options: Options = Options(),
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.fns = ProblemFunctions(objective, equality, cone, num_variables, num_parameters)
        self.layout = ConeLayout(self.fns.dims.cone, nonnegative_indices, second_order_indices)
        self.options = options
        self._run = solve_fn(self.fns, self.layout, options)

    def solve(self, x0_batch, theta_batch=None, mesh=None, axis="batch") -> SolveResult:
        _refuse_mesh(mesh)
        x0_batch = torch.as_tensor(x0_batch).to(self.device)
        if theta_batch is not None:
            theta_batch = torch.as_tensor(theta_batch).to(device=self.device, dtype=x0_batch.dtype)
        return self._run(x0_batch, theta_batch)


class BatchedTrajOptSolver(_Batched):
    """Batched scenario solves over a configured TrajOptSolver, built by
    `ts.batched()`:

        bts = ts.batched()
        res = bts.solve(parameters=theta_batch)              # (B, p) rows
        res = bts.solve(parameters=theta_batch, warm=res.state.p)

    Scenario variation enters through per-stage `parameters` and/or
    per-lane initial guesses. The solve runs on the TrajOptSolver's
    device, in the dtype of `parameters` (or of `guess` when there are no
    parameters)."""

    def __init__(self, ts):
        solver = ts.solver
        self._ts = ts
        self.device = solver.device
        self.fns, self.layout = solver.fns, solver.layout
        self.options = solver.options
        self._run = solve_fn(self.fns, self.layout, self.options)

    def _dtype(self):
        g = getattr(self._ts, "_guess", None)
        return torch.float64 if g is None else torch.as_tensor(g).dtype

    def solve(self, parameters=None, guess=None, warm=None, mesh=None, axis="batch") -> SolveResult:
        """Solve B scenarios. `parameters`: (B, p) flat per-stage parameter
        rows (or None for a parameterless problem). `guess`: (B, n) or (n,)
        or None (the TrajOptSolver's guess, broadcast). `warm`: a batched
        primal-dual Blocks from a previous batched solve (used when
        Options.warmstart is set); numpy arrays are accepted too."""
        _refuse_mesh(mesh)
        if parameters is not None:
            parameters = torch.as_tensor(parameters)
        if guess is None:
            g = getattr(self._ts, "_guess", None)
            if g is None:
                raise ValueError("no initial guess: call initialize_states/actions or pass guess")
            guess = torch.as_tensor(g)
            if parameters is not None:
                guess = guess.to(dtype=parameters.dtype)
        else:
            guess = torch.as_tensor(guess)
        B = None
        for a in (parameters, guess):
            if a is not None and a.dim() == 2:
                B = a.shape[0]
                break
        if B is None:
            raise ValueError(
                "cannot infer batch size: pass a batched `parameters` (B, p) "
                "or a batched `guess` (B, n)"
            )
        device = self.device
        if parameters is None:
            dtype = guess.dtype
            parameters = torch.zeros((B, self.fns.dims.parameters), dtype=dtype, device=device)
        else:
            dtype = torch.result_type(parameters, guess)
        guess = guess.to(device=device, dtype=dtype)
        if guess.dim() == 1:
            guess = guess.expand(B, -1)
        guess = guess.contiguous()
        parameters = parameters.to(device=device, dtype=dtype)
        if warm is not None:
            warm = Blocks(*(torch.as_tensor(a).to(device=device, dtype=dtype) for a in warm))
        return self._run(guess, parameters, warm)
