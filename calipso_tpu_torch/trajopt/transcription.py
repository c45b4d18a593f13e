"""Stagewise trajectory optimization -> standard conic NLP transcription.

The counterpart of `calipso_tpu/trajopt/transcription.py`: the same
interleaved [x_1, u_1, x_2, u_2, ..., x_T] variable layout, the same row
ordering (dynamics, per-stage equality, general equality; nonnegative
then second-order cone rows), and the same two evaluators: the grouped
stage evaluators of `trajopt/structured.py` (default, `structured=True`)
or autodiff of the assembled flat functions (`structured=False`).

Stage callables are written in torch for one unbatched stage (see
`solver/problem.py` for the rules they follow).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.func import jacrev

from calipso_tpu_torch.options import Options
from calipso_tpu_torch.solver.api import Solver, SolveResult
from calipso_tpu_torch.solver.problem import num_positional, probe_size


def linear_interpolation(initial_state, final_state, horizon: int):
    """Linearly interpolated state trajectory, as float64 CPU tensors."""
    a = torch.as_tensor(np.asarray(initial_state, dtype=float))
    b = torch.as_tensor(np.asarray(final_state, dtype=float))
    ts = torch.linspace(0.0, 1.0, horizon, dtype=torch.float64)[:, None]
    traj = (1.0 - ts) * a[None, :] + ts * b[None, :]
    return [traj[i] for i in range(horizon)]


def _normalize_stage(fn: Callable) -> Callable:
    """Wrap stage callables to the uniform (x, u, w) signature."""
    if fn is None:
        return None
    if num_positional(fn, 3) >= 3:
        return fn
    return lambda x, u, w, _f=fn: _f(x, u)


class Cost:
    """Stage cost C_t(x, u, w)."""

    def __init__(self, fn: Callable):
        self.raw_fn = fn  # identity key for stage grouping
        self.fn = _normalize_stage(fn)

    def __call__(self, x, u, w):
        return torch.as_tensor(self.fn(x, u, w)).reshape(())


class Dynamics:
    """Implicit discrete dynamics F_t(y, x, u, w) = 0."""

    def __init__(self, fn: Callable):
        self.raw_fn = fn
        n = num_positional(fn, 4)
        self.fn = fn if n >= 4 else (lambda y, x, u, w, _f=fn: _f(y, x, u))

    def __call__(self, y, x, u, w):
        return torch.as_tensor(self.fn(y, x, u, w)).reshape(-1)


class Constraint:
    """Per-stage constraint E_t/H_t(x, u, w)."""

    def __init__(self, fn: Callable):
        self.raw_fn = fn
        self.fn = _normalize_stage(fn)

    def __call__(self, x, u, w):
        return torch.as_tensor(self.fn(x, u, w)).reshape(-1)


def _as_list(spec, horizon, ctor):
    if spec is None:
        return [None] * horizon
    out = [item if item is None or isinstance(item, ctor) else ctor(item) for item in spec]
    if len(out) != horizon:
        raise ValueError(f"expected {horizon} stage entries, got {len(out)}")
    return out


class TrajOptSolver:
    """Stagewise trajopt solver: per-stage objective (length T), dynamics
    (length T-1), optional per-stage equality / nonnegative /
    second-order constraint lists, optional whole-trajectory
    `equality_general`, per-stage parameter vectors. It solves on
    `device`, the card unless asked otherwise (`device="cpu"`)."""

    def __init__(
        self,
        objective: Sequence,
        dynamics: Sequence,
        num_states: Sequence[int],
        num_actions: Sequence[int],
        *,
        equality: Optional[Sequence] = None,
        equality_general: Optional[Callable] = None,
        nonnegative: Optional[Sequence] = None,
        second_order: Optional[Sequence[Sequence]] = None,
        parameters: Optional[Sequence] = None,
        options: Options = Options(),
        structured: bool = True,
        device="cuda",
    ):
        T = len(num_states)
        if len(num_actions) != T - 1:
            raise ValueError(f"need {T - 1} action dimensions, got {len(num_actions)}")
        self.horizon = T
        self.num_states = [int(k) for k in num_states]
        self.num_actions = [int(k) for k in num_actions] + [0]

        costs = _as_list(objective, T, Cost)
        dyns = [d if isinstance(d, Dynamics) else Dynamics(d) for d in dynamics]
        eqs = _as_list(equality, T, Constraint)
        nns = _as_list(nonnegative, T, Constraint)
        if second_order is None:
            socs: List[List[Constraint]] = [[] for _ in range(T)]
        else:
            if len(second_order) != T:
                raise ValueError(f"expected {T} second_order stage lists")
            socs = [[c if isinstance(c, Constraint) else Constraint(c) for c in stage]
                    for stage in second_order]
        self._eq_general = equality_general

        # parameters: per-stage vectors flattened
        if parameters is None:
            params = [np.zeros(0) for _ in range(T)]
        else:
            if len(parameters) != T:
                raise ValueError(f"expected {T} stage parameter vectors")
            params = [np.asarray(p, dtype=float).reshape(-1) for p in parameters]
        self._param_dims = [len(p) for p in params]
        self._param_offsets = np.concatenate([[0], np.cumsum(self._param_dims)]).astype(int)
        flat_params = np.concatenate(params) if sum(self._param_dims) else np.zeros(0)

        # interleaved variable layout [x1, u1, x2, u2, ..., xT]
        offsets, starts, off = [], [], 0
        for t in range(T):
            starts.append(off)
            x_idx = np.arange(off, off + self.num_states[t])
            off += self.num_states[t]
            u_idx = np.arange(off, off + self.num_actions[t])
            off += self.num_actions[t]
            offsets.append((x_idx, u_idx))
        self.num_variables = off
        self._state_indices = [o[0] for o in offsets]
        self._action_indices = [o[1] for o in offsets[:-1]]

        def split(zflat, t):
            lo, nx, nu = starts[t], self.num_states[t], self.num_actions[t]
            return zflat[lo : lo + nx], zflat[lo + nx : lo + nx + nu]

        def stage_param(theta, t):
            return theta[self._param_offsets[t] : self._param_offsets[t + 1]]

        def objective_flat(zflat, theta):
            total = 0.0
            for t in range(T):
                x, u = split(zflat, t)
                total = total + costs[t](x, u, stage_param(theta, t))
            return total

        def equality_flat(zflat, theta):
            rows = []
            for t in range(T - 1):
                x, u = split(zflat, t)
                y, _ = split(zflat, t + 1)
                rows.append(dyns[t](y, x, u, stage_param(theta, t)))
            for t in range(T):
                if eqs[t] is not None:
                    x, u = split(zflat, t)
                    rows.append(eqs[t](x, u, stage_param(theta, t)))
            if self._eq_general is not None:
                rows.append(torch.as_tensor(self._eq_general(zflat, theta)).reshape(-1))
            if not rows:
                return zflat.new_zeros((0,))
            return torch.cat(rows)

        def cone_flat(zflat, theta):
            rows = []
            for t in range(T):
                if nns[t] is not None:
                    x, u = split(zflat, t)
                    rows.append(nns[t](x, u, stage_param(theta, t)))
            for t in range(T):
                for c in socs[t]:
                    x, u = split(zflat, t)
                    rows.append(c(x, u, stage_param(theta, t)))
            if not rows:
                return zflat.new_zeros((0,))
            return torch.cat(rows)

        # cone index layout: nonnegative block then the SOC blocks
        def stage_shapes(t):
            return (self.num_states[t],), (self.num_actions[t],), (self._param_dims[t],)

        num_nn = sum(probe_size(nns[t], *stage_shapes(t)) for t in range(T) if nns[t] is not None)
        soc_dims = [probe_size(c, *stage_shapes(t)) for t in range(T) for c in socs[t]]
        nn_idx = np.arange(num_nn)
        soc_idx, off = [], num_nn
        for d in soc_dims:
            soc_idx.append(np.arange(off, off + d))
            off += d

        fns = (
            self._build_structured(costs, dyns, eqs, nns, socs, len(flat_params))
            if structured
            else None
        )
        self.solver = Solver(
            objective_flat,
            equality_flat,
            cone_flat,
            self.num_variables,
            parameters=flat_params if len(flat_params) else None,
            num_parameters=len(flat_params),
            nonnegative_indices=nn_idx,
            second_order_indices=soc_idx,
            options=options,
            device=device,
            _fns=fns,
        )
        self.options = options
        self.dims = self.solver.dims

    def _build_structured(self, costs, dyns, eqs, nns, socs, num_parameters):
        """Build grouped, vmapped stage evaluators (see
        calipso_tpu_torch.trajopt.structured)."""
        from calipso_tpu_torch.trajopt.stage_structure import ConeSpan, EqSpan, StageStructure
        from calipso_tpu_torch.trajopt.structured import StructuredProblemFunctions

        T = self.horizon
        nxs, nus = self.num_states, self.num_actions

        xu_cols = []
        for t in range(T):
            cols = [self._state_indices[t]]
            if t < T - 1:
                cols.append(self._action_indices[t])
            xu_cols.append(np.concatenate(cols).astype(np.int64))
        p_cols = [
            np.arange(self._param_offsets[t], self._param_offsets[t + 1], dtype=np.int64)
            for t in range(T)
        ]

        _probe_cache = {}

        def probe(fn, *shapes):
            # one probe per (callable, shapes), not one per stage
            key = (id(getattr(fn, "raw_fn", fn)), shapes)
            if key not in _probe_cache:
                _probe_cache[key] = probe_size(fn, *shapes)
            return _probe_cache[key]

        def stage_wrap(c, nx):
            def fn(zrow, wrow, _c=c, _nx=nx):
                return _c(zrow[:_nx], zrow[_nx:], wrow)

            return fn

        cost_entries = []
        for t in range(T):
            c = costs[t]
            key = (id(c.raw_fn), nxs[t], nus[t])
            cost_entries.append((key, stage_wrap(c, nxs[t]), xu_cols[t], p_cols[t]))

        eq_spans, cone_spans = [], []
        eq_entries = []
        row = 0
        for t in range(T - 1):
            d = dyns[t]
            nx, nu, nxn = nxs[t], nus[t], nxs[t + 1]
            rdim = probe(d, (nxn,), (nx,), (nu,), (len(p_cols[t]),))
            zc = np.concatenate([xu_cols[t], self._state_indices[t + 1]]).astype(np.int64)

            def stage_dyn(zrow, wrow, _d=d, _nx=nx, _nu=nu):
                return _d(zrow[_nx + _nu :], zrow[:_nx], zrow[_nx : _nx + _nu], wrow)

            key = (id(d.raw_fn), nx, nu, nxn)
            eq_entries.append((key, stage_dyn, zc, p_cols[t], np.arange(row, row + rdim)))
            eq_spans.append(EqSpan(row, rdim, t, True, nxn))
            row += rdim
        for t in range(T):
            if eqs[t] is None:
                continue
            rdim = probe(eqs[t], (nxs[t],), (nus[t],), (len(p_cols[t]),))
            if rdim == 0:
                continue
            key = (id(eqs[t].raw_fn), nxs[t], nus[t])
            eq_entries.append(
                (key, stage_wrap(eqs[t], nxs[t]), xu_cols[t], p_cols[t],
                 np.arange(row, row + rdim))
            )
            eq_spans.append(EqSpan(row, rdim, t, False, 0))
            row += rdim
        general_rows = None
        general = None
        general_stages: list = []
        if self._eq_general is not None:
            general = lambda z, th: torch.as_tensor(self._eq_general(z, th)).reshape(-1)
            rg = probe_size(general, (self.num_variables,), (num_parameters,))
            general_rows = np.arange(row, row + rg)
            row += rg
            # the stages the general rows touch: union of nonzero Jacobian
            # columns over a few random probe points
            rng_probe = np.random.default_rng(1234)
            touched = np.zeros(self.num_variables, dtype=bool)
            jac_g = jacrev(general)
            for _ in range(3):
                zp = torch.as_tensor(rng_probe.normal(size=self.num_variables))
                tp = torch.as_tensor(rng_probe.normal(size=num_parameters))
                touched |= np.any(jac_g(zp, tp).detach().numpy() != 0.0, axis=0)
            for t in range(T):
                lo = int(self._state_indices[t][0])
                hi = lo + nxs[t] + nus[t]
                if touched[lo:hi].any():
                    general_stages.append(t)
        num_equality = row

        cone_entries = []
        row = 0
        for t in range(T):
            if nns[t] is None:
                continue
            rdim = probe(nns[t], (nxs[t],), (nus[t],), (len(p_cols[t]),))
            if rdim == 0:
                continue
            key = (id(nns[t].raw_fn), nxs[t], nus[t])
            cone_entries.append(
                (key, stage_wrap(nns[t], nxs[t]), xu_cols[t], p_cols[t],
                 np.arange(row, row + rdim))
            )
            cone_spans.append(ConeSpan(row, rdim, t))
            row += rdim
        for t in range(T):
            for c in socs[t]:
                rdim = probe(c, (nxs[t],), (nus[t],), (len(p_cols[t]),))
                if rdim == 0:
                    continue
                key = (id(c.raw_fn), nxs[t], nus[t])
                cone_entries.append(
                    (key, stage_wrap(c, nxs[t]), xu_cols[t], p_cols[t],
                     np.arange(row, row + rdim))
                )
                cone_spans.append(ConeSpan(row, rdim, t))
                row += rdim
        num_cone = row

        fns = StructuredProblemFunctions(
            self.num_variables,
            num_parameters,
            cost_entries,
            eq_entries,
            cone_entries,
            num_equality,
            num_cone,
            general_equality=general,
            general_rows=general_rows,
        )
        fns.stage_structure = StageStructure(
            [int(self._state_indices[t][0]) for t in range(T)],
            [nxs[t] + nus[t] for t in range(T)],
            eq_spans,
            cone_spans,
            general is not None,
            num_general=(len(general_rows) if general_rows is not None else 0),
            general_stages=general_stages,
        )
        return fns

    # ---- trajectory accessors ----------------------------------------------

    def initialize_states(self, states):
        z = self._guess_buffer()
        for t, xs in enumerate(states):
            z[self._state_indices[t]] = np.asarray(xs, dtype=float)
        self._guess = z
        self.solver.initialize(torch.as_tensor(z))
        return self

    def initialize_actions(self, actions):
        z = self._guess_buffer()
        for t, us in enumerate(actions):
            z[self._action_indices[t]] = np.asarray(us, dtype=float)
        self._guess = z
        self.solver.initialize(torch.as_tensor(z))
        return self

    def _guess_buffer(self):
        g = getattr(self, "_guess", None)
        if g is None:
            g = np.zeros(self.num_variables)
        return np.array(g)

    def solve(self, parameters=None, warm=None) -> SolveResult:
        return self.solver.solve(parameters=parameters, warm=warm)

    def batched(self):
        """Batched scenario solving over this problem (see
        calipso_tpu_torch.parallel.batch.BatchedTrajOptSolver)."""
        from calipso_tpu_torch.parallel.batch import BatchedTrajOptSolver

        return BatchedTrajOptSolver(self)

    def get_trajectory(self, result: SolveResult):
        z = result.variables.detach().cpu().numpy()
        states = [z[idx] for idx in self._state_indices]
        actions = [z[idx] for idx in self._action_indices]
        return states, actions
