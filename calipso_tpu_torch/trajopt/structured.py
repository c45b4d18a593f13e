"""Structure-exploiting trajopt evaluators: grouped stage derivatives under
`torch.func.vmap`, placed into the flat problem arrays.

The counterpart of `calipso_tpu/trajopt/structured.py`. Stages are
grouped by (callable identity, dimensions); each group's values,
gradients, Jacobians and Hessians come from ONE vmapped stage-local
transform over the flattened (lane, stage) axis, then are placed into the
flat vectors and dense matrices with static index tables:

  * values and Jacobian rows by concatenation in group order (plus a
    static row permutation when that order is not row order), Jacobian
    columns by a scatter of each member's distinct columns -- exact;
  * gradients and Hessians, whose members overlap (a dynamics stage shares
    its next-state columns with the following stage), by contraction
    with 0/1 one-hot column maps -- deterministic on the GPU, unlike an
    atomic scatter-add.

Derivatives are reverse mode only, as in `solver/problem.py` (forward
mode under vmap is wrong through `torch.linalg.solve`).

Same call surface as `solver/problem.ProblemFunctions`: every oracle takes
z (B, n) and theta (B, p) with the lane axis first. The riccati backend
also reads the Lagrangian Hessian in stage-block tridiagonal form
(`lagrangian_hessian_blocks`), placed from the same grouped Hessians with
0/1 stage and offset maps, so no dense (n, n) Hessian is built on its
path. The theta-derivatives belong to differentiation (ROADMAP Queue 1
item 18).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad, jacrev, vmap

from calipso_tpu_torch.solver.problem import Dimensions


class _Group(NamedTuple):
    fn: Callable  # stage function of (zrow, wrow) -> (rdim,) or scalar
    zcols: np.ndarray  # (G, width) flat variable indices feeding each stage
    pcols: np.ndarray  # (G, npw) flat parameter indices
    rows: np.ndarray  # (G, rdim) output row indices ([] for costs)
    width: int
    npw: int
    rdim: int


def _group_stages(entries):
    """entries: list of (key, fn, zcols, pcols, rows); groups stages by
    (key, shapes) in first-seen order."""
    table = {}
    order = []
    for key, fn, zc, pc, rw in entries:
        gkey = (key, len(zc), len(pc), len(rw))
        if gkey not in table:
            table[gkey] = []
            order.append(gkey)
        table[gkey].append((fn, zc, pc, rw))
    groups = []
    for gkey in order:
        items = table[gkey]
        zcols = np.stack([it[1] for it in items])
        pcols = np.stack([it[2] for it in items])
        rows = np.stack([it[3] for it in items])
        groups.append(
            _Group(items[0][0], zcols, pcols, rows, zcols.shape[1], pcols.shape[1], rows.shape[1])
        )
    return groups


def _row_perm(groups, m, general_rows):
    """Rows in group order (general rows last) must tile [0, m); returns
    None when that order is row order, else the permutation that restores
    row order after concatenation."""
    parts = [np.asarray(g.rows).ravel() for g in groups]
    if general_rows is not None:
        parts.append(np.asarray(general_rows).ravel())
    cat = np.concatenate(parts) if parts else np.zeros((0,), np.int64)
    if cat.size != m or not np.array_equal(np.sort(cat), np.arange(m)):
        raise ValueError("stage constraint rows must tile 0..m-1 exactly once")
    if np.array_equal(cat, np.arange(m)):
        return None
    return np.argsort(cat, kind="stable")


def _scal(fn):
    """The scalarized dual term fn(z, w) @ y of a constraint stage."""
    return lambda zrow, wrow, yrow: fn(zrow, wrow) @ yrow


class StructuredProblemFunctions:
    """Drop-in replacement for ProblemFunctions built from stagewise
    callables; same (batched) call surface."""

    def __init__(
        self,
        num_variables: int,
        num_parameters: int,
        cost_entries,  # list of (key, fn(z,w)->scalar, zcols, pcols)
        eq_entries,  # list of (key, fn(z,w)->(r,), zcols, pcols, rows)
        cone_entries,  # same shape as eq_entries
        num_equality: int,
        num_cone: int,
        general_equality=None,  # optional fn(zflat, theta) -> (rg,)
        general_rows=None,
    ):
        n, p = int(num_variables), int(num_parameters)
        self.dims = Dimensions(n, p, int(num_equality), int(num_cone))
        self._n, self._p = n, p
        self.cost_groups = _group_stages(
            [(k, fn, zc, pc, np.zeros((0,), np.int64)) for (k, fn, zc, pc) in cost_entries]
        )
        self.eq_groups = _group_stages(eq_entries)
        self.cone_groups = _group_stages(cone_entries)
        self.general = general_equality
        self.general_rows = (
            np.asarray(general_rows, np.int64) if general_rows is not None else None
        )
        self._eq_perm = _row_perm(
            self.eq_groups, self.dims.equality,
            self.general_rows if general_equality is not None else None,
        )
        self._cone_perm = _row_perm(self.cone_groups, self.dims.cone, None)
        self._cache = {}

    # ---- static tables on the solve's device ------------------------------

    def _tables(self, ref):
        """Index tables and one-hot column maps for ref's device and dtype,
        built once per (device, dtype)."""
        key = (str(ref.device), ref.dtype)
        if key not in self._cache:
            dev, n = ref.device, self._n

            def group_tables(g):
                onehot = np.zeros(g.zcols.shape + (n + 1,))
                np.put_along_axis(onehot, g.zcols[..., None], 1.0, axis=-1)
                return dict(
                    zc=torch.as_tensor(g.zcols, device=dev),
                    pc=torch.as_tensor(g.pcols, device=dev),
                    rows=torch.as_tensor(g.rows, device=dev),
                    C=torch.as_tensor(onehot[..., :n], dtype=ref.dtype, device=dev),
                )

            as_idx = lambda a: None if a is None else torch.as_tensor(a, device=dev)
            self._cache[key] = dict(
                cost=[group_tables(g) for g in self.cost_groups],
                eq=[group_tables(g) for g in self.eq_groups],
                cone=[group_tables(g) for g in self.cone_groups],
                eq_perm=as_idx(self._eq_perm),
                cone_perm=as_idx(self._cone_perm),
                general_rows=as_idx(self.general_rows),
            )
        return self._cache[key]

    def _stage_args(self, g, tab, z, theta):
        """Flattened (B*G, width) stage inputs and (B*G, npw) parameters."""
        rows = z.shape[0] * g.zcols.shape[0]
        zpad = torch.cat([z, z.new_zeros((z.shape[0], 1))], dim=-1)
        tpad = torch.cat([theta, theta.new_zeros((theta.shape[0], 1))], dim=-1)
        return (
            zpad[:, tab["zc"]].reshape(rows, g.width),
            tpad[:, tab["pc"]].reshape(rows, g.npw),
        )

    @staticmethod
    def _place_cols(v, C):
        """(B, G, w) member gradients -> (B, n) flat sum."""
        return torch.einsum("bgw,gwn->bn", v, C)

    @staticmethod
    def _place_hess(H, C):
        """(B, G, w, w) member Hessians -> (B, n, n) flat sum."""
        return torch.einsum("gwm,bgwn->bmn", C, torch.einsum("bgwv,gvn->bgwn", H, C))

    # ---- values --------------------------------------------------------------

    def f(self, z, theta):
        tabs = self._tables(z)
        total = z.new_zeros(z.shape[0])
        for g, tab in zip(self.cost_groups, tabs["cost"]):
            Zf, Wf = self._stage_args(g, tab, z, theta)
            total = total + vmap(g.fn)(Zf, Wf).reshape(z.shape[0], -1).sum(dim=-1)
        return total

    def _values(self, groups, tabs, perm, z, theta, general):
        B = z.shape[0]
        parts = []
        for g, tab in zip(groups, tabs):
            Zf, Wf = self._stage_args(g, tab, z, theta)
            parts.append(vmap(g.fn)(Zf, Wf).reshape(B, -1))
        if general:
            parts.append(vmap(self.general)(z, theta))
        if not parts:
            return z.new_zeros((B, 0))
        out = torch.cat(parts, dim=-1)
        return out if perm is None else out[:, perm]

    def g(self, z, theta):
        tabs = self._tables(z)
        return self._values(
            self.eq_groups, tabs["eq"], tabs["eq_perm"], z, theta, self.general is not None
        )

    def h(self, z, theta):
        tabs = self._tables(z)
        return self._values(self.cone_groups, tabs["cone"], tabs["cone_perm"], z, theta, False)

    # ---- first derivatives ---------------------------------------------------

    def fx(self, z, theta):
        tabs = self._tables(z)
        out = torch.zeros_like(z)
        for g, tab in zip(self.cost_groups, tabs["cost"]):
            Zf, Wf = self._stage_args(g, tab, z, theta)
            grads = vmap(grad(g.fn))(Zf, Wf).reshape(z.shape[0], -1, g.width)
            out = out + self._place_cols(grads, tab["C"])
        return out

    def _jacobian(self, groups, tabs, perm, z, theta, general):
        B, n = z.shape
        parts = []
        for g, tab in zip(groups, tabs):
            Zf, Wf = self._stage_args(g, tab, z, theta)
            J = vmap(jacrev(g.fn))(Zf, Wf).reshape(B, -1, g.rdim, g.width)
            cols = tab["zc"][None, :, None, :].expand(B, -1, g.rdim, -1)
            Jp = J.new_zeros((B, J.shape[1], g.rdim, n)).scatter(-1, cols, J)
            parts.append(Jp.reshape(B, -1, n))
        if general:
            parts.append(vmap(jacrev(self.general))(z, theta))
        if not parts:
            return z.new_zeros((B, 0, n))
        out = torch.cat(parts, dim=1)
        return out if perm is None else out[:, perm]

    def gx(self, z, theta):
        tabs = self._tables(z)
        return self._jacobian(
            self.eq_groups, tabs["eq"], tabs["eq_perm"], z, theta, self.general is not None
        )

    def hx(self, z, theta):
        tabs = self._tables(z)
        return self._jacobian(self.cone_groups, tabs["cone"], tabs["cone_perm"], z, theta, False)

    def _dual_grad(self, groups, tabs, z, theta, dual):
        out = torch.zeros_like(z)
        for g, tab in zip(groups, tabs):
            Zf, Wf = self._stage_args(g, tab, z, theta)
            Yf = dual[:, tab["rows"]].reshape(-1, g.rdim)
            grads = vmap(grad(_scal(g.fn)))(Zf, Wf, Yf).reshape(z.shape[0], -1, g.width)
            out = out + self._place_cols(grads, tab["C"])
        return out

    def gty_x(self, z, theta, y):
        tabs = self._tables(z)
        out = self._dual_grad(self.eq_groups, tabs["eq"], z, theta, y)
        if self.general is not None:
            yg = y[:, tabs["general_rows"]]
            out = out + vmap(grad(_scal(self.general)))(z, theta, yg)
        return out

    def htz_x(self, z, theta, dual):
        tabs = self._tables(z)
        return self._dual_grad(self.cone_groups, tabs["cone"], z, theta, dual)

    # ---- second derivatives --------------------------------------------------

    def lagrangian_hessian_xx(self, x, theta, y, z, constraint_tensor=True):
        """fxx + sum_i y_i grad^2 g_i + sum_i z_i grad^2 h_i, (B, n, n)."""
        tabs = self._tables(x)
        B = x.shape[0]
        H = x.new_zeros((B, self._n, self._n))
        for g, tab in zip(self.cost_groups, tabs["cost"]):
            Zf, Wf = self._stage_args(g, tab, x, theta)
            Hg = vmap(jacrev(grad(g.fn)))(Zf, Wf).reshape(B, -1, g.width, g.width)
            H = H + self._place_hess(Hg, tab["C"])
        if not constraint_tensor:
            return H
        for groups, gtabs, dual in (
            (self.eq_groups, tabs["eq"], y),
            (self.cone_groups, tabs["cone"], z),
        ):
            if dual.shape[-1] == 0:
                continue
            for g, tab in zip(groups, gtabs):
                Zf, Wf = self._stage_args(g, tab, x, theta)
                Yf = dual[:, tab["rows"]].reshape(-1, g.rdim)
                Hg = vmap(jacrev(grad(_scal(g.fn))))(Zf, Wf, Yf).reshape(B, -1, g.width, g.width)
                H = H + self._place_hess(Hg, tab["C"])
        if self.general is not None:
            yg = y[:, tabs["general_rows"]]
            H = H + vmap(jacrev(grad(_scal(self.general))))(x, theta, yg)
        return H

    # ---- stage-block tridiagonal Hessian (riccati backend) ------------------

    def _block_maps(self):
        """Per-group static placement maps (t_idx, Q0, Q1), computed once.
        None when a group's members disagree on their (stage offset,
        segment) pattern or there is no stage structure; the riccati
        backend then gathers its blocks from the dense Hessian."""
        st = getattr(self, "stage_structure", None)
        if st is None:
            return None  # not cached: the structure may be attached later
        if not hasattr(self, "_block_maps_cache"):
            try:
                maps = {
                    kind: [self._group_map(g, st) for g in groups]
                    for kind, groups in (
                        ("cost", self.cost_groups), ("eq", self.eq_groups), ("cone", self.cone_groups)
                    )
                }
            except ValueError:
                maps = None
            self._block_maps_cache = maps
        return self._block_maps_cache

    @staticmethod
    def _group_map(g: _Group, st):
        """Static placement of one group's stage-local variable columns:
        member i's columns land in stage t_i (segment 0) and optionally
        stage t_i + 1 (segment 1, the dynamics' next state). Q0/Q1 are
        0/1 (width, dmax) maps from width index to block offset, shared by
        every member (ValueError if they are not)."""
        n = st.num_variables
        zc = np.asarray(g.zcols)
        if np.any(zc >= n):
            raise ValueError("sentinel-padded columns")  # not stage-local
        zt = st.inv_t[zc]  # (G, w) stage of each column
        zo = st.inv_o[zc]  # (G, w) offset within the stage block
        t_idx = zt.min(axis=1)  # (G,)
        seg = zt - t_idx[:, None]
        if seg.max(initial=0) > 1:
            raise ValueError("columns span more than two stages")
        if not (np.all(seg == seg[0]) and np.all(zo == zo[0])):
            raise ValueError("members disagree on the placement pattern")
        seg0, off0 = seg[0], zo[0]
        w, dmax = zc.shape[1], st.dmax
        Q0 = np.zeros((w, dmax))
        Q1 = np.zeros((w, dmax))
        Q0[seg0 == 0, off0[seg0 == 0]] = 1.0
        Q1[seg0 == 1, off0[seg0 == 1]] = 1.0
        return t_idx, Q0, (Q1 if np.any(seg0 == 1) else None)

    def _map_tensors(self, ref):
        """The block maps as tensors on ref's device and dtype: per group
        (Q0, S0, Q1, S1, So), S* the 0/1 (G, T) or (G, T-1) one-hot stage
        maps of t_idx, t_idx + 1 and the coupling block t_idx."""
        key = ("maps", str(ref.device), ref.dtype)
        if key not in self._cache:
            T = self.stage_structure.horizon
            as_t = lambda a: torch.as_tensor(a, dtype=ref.dtype, device=ref.device)

            def onehot(idx, size):
                out = np.zeros((len(idx), size))
                out[np.arange(len(idx)), idx] = 1.0
                return as_t(out)

            def tensors(m):
                t_idx, Q0, Q1 = m
                if Q1 is None:
                    return as_t(Q0), onehot(t_idx, T), None, None, None
                return (
                    as_t(Q0), onehot(t_idx, T), as_t(Q1),
                    onehot(t_idx + 1, T), onehot(t_idx, T - 1),
                )

            self._cache[key] = {
                kind: [tensors(m) for m in maps] for kind, maps in self._block_maps().items()
            }
        return self._cache[key]

    def lagrangian_hessian_blocks(self, x, theta, y, z, constraint_tensor=True):
        """Stage-block tridiagonal Lagrangian Hessian: D (B, T, dmax, dmax)
        diagonal and O (B, T-1, dmax, dmax) sub-diagonal blocks (O_t =
        H[stage t+1 rows, stage t columns]) carrying every stage-local
        term, and Hgen, the dense (B, n, n) Hessian of the
        equality_general dual term, or None without one."""
        st = self.stage_structure
        tabs, maps = self._tables(x), self._map_tensors(x)
        B, T, dmax = x.shape[0], st.horizon, st.dmax
        D = x.new_zeros((B, T, dmax, dmax))
        O = x.new_zeros((B, max(T - 1, 0), dmax, dmax))

        def add_group(D, O, H, m):
            """H (B, G, w, w) member Hessians -> block contributions."""
            q0, S0, q1, S1, So = m
            place = lambda qa, qb: torch.einsum("ja,lgjk,kc->lgac", qa, H, qb)
            D = D + torch.einsum("gt,lgac->ltac", S0, place(q0, q0))
            if q1 is not None:
                D = D + torch.einsum("gt,lgac->ltac", S1, place(q1, q1))
                O = O + torch.einsum("gt,lgac->ltac", So, place(q1, q0))
            return D, O

        for g, tab, m in zip(self.cost_groups, tabs["cost"], maps["cost"]):
            Zf, Wf = self._stage_args(g, tab, x, theta)
            H = vmap(jacrev(grad(g.fn)))(Zf, Wf).reshape(B, -1, g.width, g.width)
            D, O = add_group(D, O, H, m)
        if constraint_tensor:
            for kind, groups, dual in (("eq", self.eq_groups, y), ("cone", self.cone_groups, z)):
                if dual.shape[-1] == 0:
                    continue
                for g, tab, m in zip(groups, tabs[kind], maps[kind]):
                    Zf, Wf = self._stage_args(g, tab, x, theta)
                    Yf = dual[:, tab["rows"]].reshape(-1, g.rdim)
                    H = vmap(jacrev(grad(_scal(g.fn))))(Zf, Wf, Yf)
                    D, O = add_group(D, O, H.reshape(B, -1, g.width, g.width), m)
        Hgen = None
        if constraint_tensor and self.general is not None:
            yg = y[:, tabs["general_rows"]]
            Hgen = vmap(jacrev(grad(_scal(self.general))))(x, theta, yg)
        return D, O, Hgen
