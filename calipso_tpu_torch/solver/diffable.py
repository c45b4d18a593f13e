"""Differentiable solve: w*(theta) as a `torch.autograd.Function` whose
backward pass is the implicit function theorem.

The counterpart of `calipso_tpu/solver/diffable.py` (a `jax.custom_vjp`).
The forward pass solves the B lanes and, when theta needs a gradient,
their sensitivity (`solver/differentiate.py`), which it keeps for the
backward pass: theta_bar = sens' w_bar, lane by lane. The initial guess
gets no gradient: at a regular solution w* does not depend on where the
solve started.
"""

from __future__ import annotations

import torch

from calipso_tpu_torch.solver import differentiate
from calipso_tpu_torch.solver.solve import make_solve, resolve_options


def make_differentiable_solve(fns, layout, opts):
    """Returns solve_w(theta (B, p), x0 (B, n) or (n,)) -> the flat
    primal-dual solutions w* (B, total), differentiable in theta. The
    function carries `stats` (see `make_solve`) and, after each call,
    `state`: the solver State of its lanes (solved flags, iterations)."""
    opts = resolve_options(opts, fns)
    core = make_solve(fns, layout, opts)

    class _Solve(torch.autograd.Function):
        @staticmethod
        def forward(ctx, theta, x0, need_sens):
            st = core(x0, theta)
            solve_w.state = st
            if need_sens:
                ctx.save_for_backward(differentiate.solution_sensitivity(fns, layout, opts, st, theta))
            return st.p.all

        @staticmethod
        def backward(ctx, wbar):
            (sens,) = ctx.saved_tensors
            return torch.einsum("bkp,bk->bp", sens, wbar), None, None

    def solve_w(theta, x0):
        if x0.dim() == 1:
            x0 = x0.expand(theta.shape[0], -1)
        x0 = x0.to(dtype=theta.dtype, device=theta.device).contiguous()
        need = torch.is_grad_enabled() and theta.requires_grad
        return _Solve.apply(theta, x0, need)

    solve_w.stats = core.stats
    solve_w.state = None
    return solve_w
