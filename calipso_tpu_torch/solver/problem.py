"""Problem abstraction: user callables + `torch.func` derivatives.

The counterpart of `calipso_tpu/solver/problem.py`. The user writes the
objective, equality and cone callables for ONE lane in torch:
f(x, theta) -> scalar, g(x, theta) -> (m_e,), h(x, theta) -> (m_c,).
Every oracle here is batched: it takes x (B, n) and theta (B, p) and maps
the per-lane transform over the lane axis with `torch.func.vmap`.

Rules for user callables (they run under vmap and forward/reverse AD):
build vectors from computed scalars with `torch.stack`, not
`torch.tensor([...])`; create constants on the input's device and dtype
(`torch.tensor(c, dtype=x.dtype, device=x.device)`); update nothing in
place.

Every derivative is reverse mode (`jacrev`, and `jacrev(grad)` for
Hessians): under `vmap`, forward mode (`jacfwd`, and `hessian`, which is
`jacfwd(jacrev)`) returns wrong derivatives through `torch.linalg.solve`
(measured with torch 2.13 on the cartpole dynamics, errors of order 1e2),
and user dynamics solve small linear systems.

The theta-derivatives (fxt, gt, ht, gty_xt, htz_xt) serve implicit
differentiation (`solver/differentiate.py`), which runs after the solve
loop and inside `torch.autograd.Function.forward`, where grad mode is
off; they switch it on themselves, since `vmap(jacrev(.))` under
`torch.no_grad()` returns wrong derivatives (torch 2.13).
"""

from __future__ import annotations

import inspect
from typing import Callable, NamedTuple

import torch
from torch.func import grad, jacrev, vmap


def empty_constraint(x, theta=None):
    """No-op constraint; follows x's dtype and device."""
    return x.new_zeros((0,))


def num_positional(fn: Callable, default: int) -> int:
    """Count required positional parameters (defaulted or keyword-only
    arguments such as a timestep `h=0.05` do not count); `default` when
    the signature cannot be read."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return default
    return sum(
        1
        for p in sig.parameters.values()
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
        and p.default is inspect.Parameter.empty
    )


def _normalize(fn: Callable) -> Callable:
    """Accept f(x) or f(x, theta); always call as f(x, theta)."""
    if fn is empty_constraint or num_positional(fn, 2) >= 2:
        return fn
    return lambda x, theta, _f=fn: _f(x)


def probe_size(fn, *shapes) -> int:
    """Number of elements `fn` returns on zero inputs of these shapes
    (float64 on the CPU: a construction-time shape probe)."""
    args = [torch.zeros(s, dtype=torch.float64) for s in shapes]
    with torch.no_grad():
        return int(torch.as_tensor(fn(*args)).numel())


def with_grad(fn):
    """fn run with grad mode on, whatever the caller's (see module doc)."""

    def run(*args):
        with torch.enable_grad():
            return fn(*args)

    return run


class Dimensions(NamedTuple):
    """Problem dimensions."""

    variables: int
    parameters: int
    equality: int
    cone: int

    @property
    def symmetric(self) -> int:
        return self.variables + self.equality + self.cone

    @property
    def total(self) -> int:
        return self.variables + 2 * self.equality + 3 * self.cone


class ProblemFunctions:
    """Dense autodiff oracle for (f, g, h) and the derivatives the solver
    evaluates. Every method is batched over a leading lane axis; the
    theta-derivatives are (B, n, p) (fxt, gty_xt, htz_xt), (B, m_e, p)
    (gt) and (B, m_c, p) (ht)."""

    def __init__(self, objective, equality, cone, num_variables, num_parameters=0):
        f = _normalize(objective)
        g = _normalize(equality if equality is not None else empty_constraint)
        h = _normalize(cone if cone is not None else empty_constraint)

        f1 = lambda x, theta: torch.as_tensor(f(x, theta)).reshape(())
        g1 = lambda x, theta: torch.as_tensor(g(x, theta)).reshape(-1)
        h1 = lambda x, theta: torch.as_tensor(h(x, theta)).reshape(-1)

        me = probe_size(g1, (num_variables,), (num_parameters,))
        mc = probe_size(h1, (num_variables,), (num_parameters,))
        self.dims = Dimensions(int(num_variables), int(num_parameters), me, mc)

        gty = lambda x, theta, y: g1(x, theta) @ y
        htz = lambda x, theta, z: h1(x, theta) @ z

        self.f = vmap(f1)
        self.g = vmap(g1)
        self.h = vmap(h1)
        self.fx = vmap(grad(f1))
        self.gx = vmap(jacrev(g1))
        self.hx = vmap(jacrev(h1))
        self.gty_x = vmap(grad(gty))
        self.htz_x = vmap(grad(htz))
        self._fxx = vmap(jacrev(grad(f1)))
        self._gty_xx = vmap(jacrev(grad(gty)))
        self._htz_xx = vmap(jacrev(grad(htz)))

        # parameter derivatives (implicit differentiation)
        self.fxt = with_grad(vmap(jacrev(grad(f1), argnums=1)))
        self.gt = with_grad(vmap(jacrev(g1, argnums=1)))
        self.ht = with_grad(vmap(jacrev(h1, argnums=1)))
        self.gty_xt = with_grad(vmap(jacrev(grad(gty), argnums=1)))
        self.htz_xt = with_grad(vmap(jacrev(grad(htz), argnums=1)))

    def lagrangian_hessian_xx(self, x, theta, y, z, constraint_tensor=True):
        """fxx + sum_i y_i grad^2 g_i + sum_i z_i grad^2 h_i, (B, n, n)."""
        H = self._fxx(x, theta)
        if constraint_tensor:
            if self.dims.equality > 0:
                H = H + self._gty_xx(x, theta, y)
            if self.dims.cone > 0:
                H = H + self._htz_xx(x, theta, z)
        return H
