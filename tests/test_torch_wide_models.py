"""Numpy models of the order of operations of the wide stage routine
(`csrc/riccati_wide.cuh`, `wide::factor_stage`) that `factor_stream` past
d = 64 and `solve_batched_fused` past d = 32 share, held to the plain
versions on the CPU in float64:

- the stage: the Schur update of S_t and, for the fused solve, of r_t (the
  carry rows M_{t-1}' and u_{t-1}'), then the right-looking Cholesky of the
  stacked panel [S_t ; O_t ; r_t'] in blocks of 32 columns: in each, 8-wide
  panels (the last one padded with identity), each diagonal block factored
  with one reciprocal square root a pivot, the strip rows below it
  solved against it and the block's later columns updated, rank 8; then
  the columns past the block, rank 32; the first update of each element
  reads O_t and r_t from where they lie;
- the fused solve's backward sweep: the coupling u_t - M_t x_{t+1} over
  the rows of M_t', then L_t' x_t = r in 32-row blocks from the bottom,
  each block's pivots from the bottom by the reciprocal, its columns then
  taken off the rows above;
- the NaN rules: a stage that is not positive definite (at its first
  pivot or at its last, in its last panel) puts NaN over the lower
  triangle of L_t and of every later L and over every M from M_t on
  (`factor_stream`), or over all of the lane's x (the fused solve).

Widths at the edges of the kernels and their plans: 33 (the first past
the register kernel), 54, 64, 65 (the first wide `factor_stream`), 82,
120 and 121 (float64's widest `factor_stream` and the first past it),
165, 169 and 170 (float32's), 256; T = 1, 2 and 8."""

import numpy as np
import pytest
import torch

from calipso_tpu_torch.ops import cuda_riccati

PANEL = 8  # wide::kPanel
BLOCK_COLS = 32  # wide::kBlock: the columns a block of panels spans
BLOCK = 32  # the backward sweep's rows a diagonal block (a warp)
WIDTHS = [33, 54, 64, 65, 82, 120, 121, 165, 169, 170, 256]
STREAM_WIDTHS = [d for d in WIDTHS if 64 < d <= cuda_riccati.MAX_D[torch.float32]]
HORIZONS = [1, 2, 8]
WHERE = ["first", "middle", "last", "last pivot"]
RTOL = 1e-10  # float64, relative to the largest entry: the same arithmetic in another order


def _inputs(d, T, where):
    """Three lanes, D_t = A A' + d I, O_t = 0.3 N(0, 1), b; lane 1 not
    positive definite at its first, middle or last stage (D negated), or at
    the middle stage's last pivot (its last diagonal entry made very
    negative: the stage fails in its last panel). Returns the failing
    stage too."""
    rng = np.random.default_rng(1000 * d + 10 * T + WHERE.index(where))
    A = rng.normal(size=(3, T, d, d))
    D = A @ np.swapaxes(A, -1, -2) + d * np.eye(d)
    O = 0.3 * rng.normal(size=(3, T - 1, d, d))
    b = rng.normal(size=(3, T, d))
    bad = {"first": 0, "middle": (T - 1) // 2, "last": T - 1, "last pivot": (T - 1) // 2}[where]
    if where == "last pivot":
        D[1, bad, -1, -1] = -1e6
    else:
        D[1, bad] *= -1.0
    return D, O, b, bad


def _stage(P, d, nO, rrow, carry, D, O, b):
    """wide::factor_stage on one lane's panel P ((2d + 1) x d rows; the
    carry in rows d.., u_{t-1} in row 2d): returns False where a pivot
    fails. Rows of P end as L_t (top, lower triangle), M_t' and u_t'."""
    R = d + nO + rrow
    S, r = D.copy(), (b.copy() if rrow else None)
    if carry:
        A = P[d:2 * d]
        S = S - A @ A.T  # lower triangle used
        if rrow:
            r = r - A @ P[2 * d]  # r_t = b_t - M_{t-1}' u_{t-1}
    Q = np.zeros((R, d))
    Q[:d] = S
    if nO:
        Q[d:d + nO] = O
    if rrow:
        Q[d + nO] = r
    for p0 in range(0, d, BLOCK_COLS):
        p1 = min(p0 + BLOCK_COLS, d)
        for j0 in range(p0, p1, PANEL):
            w = min(PANEL, d - j0)
            a = np.eye(PANEL)
            a[:w, :w] = np.tril(Q[j0:j0 + w, j0:j0 + w])
            inv = np.zeros(PANEL)
            for k in range(PANEL):
                piv = a[k, k]
                if not (piv > 0 and np.isfinite(piv)):
                    return False
                inv[k] = 1.0 / np.sqrt(piv)  # rsqrt
                a[k, k] = piv * inv[k]
                a[k + 1:, k] *= inv[k]
                for i in range(k + 1, PANEL):
                    a[i, k + 1:i + 1] -= a[i, k] * a[k + 1:i + 1, k]
            v = np.zeros((R - j0 - w, PANEL))
            v[:, :w] = Q[j0 + w:, j0:j0 + w]
            for k in range(PANEL):
                v[:, k] *= inv[k]
                v[:, k + 1:] -= np.outer(v[:, k], a[k + 1:, k])
            Q[j0:j0 + w, j0:j0 + w] = a[:w, :w]
            Q[j0 + w:, j0:j0 + w] = v[:, :w]
            jt = j0 + PANEL
            if jt < p1:  # the block's later columns
                Q[jt:, jt:p1] -= Q[jt:, j0:jt] @ Q[jt:p1, j0:jt].T
        if p1 < d:  # the columns past the block, BLOCK_COLS deep
            Q[p1:, p1:] -= Q[p1:, p0:p1] @ Q[p1:d, p0:p1].T
    P[:R] = Q
    return True


def _factor_stream_model(D, O):
    """factor_stream past d = 64: the stage with no r row, L_t (lower
    triangle, zeros above) and M_t out; NaN from the failing stage on."""
    B, T, d = D.shape[0], D.shape[1], D.shape[-1]
    L, M = np.zeros_like(D), np.zeros_like(O)
    lower = np.tril(np.ones((d, d), bool))
    for lane in range(B):
        P = np.zeros((2 * d + 1, d))
        for t in range(T):
            nO = d if t < T - 1 else 0
            if not _stage(P, d, nO, 0, t > 0, D[lane, t], O[lane, t] if nO else None, None):
                L[lane, t:] = np.where(lower, np.nan, 0.0)
                M[lane, t:] = np.nan
                break
            L[lane, t] = np.where(lower, P[:d], 0.0)
            if nO:
                M[lane, t] = P[d:2 * d].T
    return L, M


def _fused_model(D, O, b):
    """solve_batched_fused past d = 32: the stages with the r row (u_t the
    panel's last row), then the blocked backward sweep; NaN over all of a
    failing lane's x."""
    B, T, d = b.shape
    x = np.zeros_like(b)
    for lane in range(B):
        P = np.zeros((2 * d + 1, d))
        Ls, Ms, u = [], [], []
        ok = True
        for t in range(T):
            nO = d if t < T - 1 else 0
            if not _stage(P, d, nO, 1, t > 0, D[lane, t], O[lane, t] if nO else None, b[lane, t]):
                ok = False
                break
            Ls.append(np.tril(P[:d]))
            Ms.append(P[d:2 * d].copy() if nO else None)
            u.append(P[d + nO].copy())
        if not ok:
            x[lane] = np.nan
            continue
        xv = None
        for t in reversed(range(T)):
            Lt = Ls[t]
            r = u[t] - (Ms[t].T @ xv if xv is not None else 0.0)
            inv = 1.0 / np.diag(Lt)
            for j1 in range(d, 0, -BLOCK):
                j0 = max(j1 - BLOCK, 0)
                for j in reversed(range(j0, j1)):
                    xj = r[j] * inv[j]
                    r[j0:j] -= Lt[j, j0:j] * xj
                    r[j] = xj
                r[:j0] -= Lt[j0:j1, :j0].T @ r[j0:j1]
            x[lane, t] = xv = r
    return x


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("where", WHERE)
@pytest.mark.parametrize("T", HORIZONS)
@pytest.mark.parametrize("d", WIDTHS)
def test_fused_stacked_panel_model_matches_plain(d, T, where):
    """The (2d + 1)-row stacked panel with the forward sweep as its last
    row, then the blocked backward sweep: x within RTOL of
    solve_batched_plain; lane 1 NaN over all of its x on both, lanes 0 and
    2 finite."""
    D, O, b, _ = _inputs(d, T, where)
    xm = _fused_model(D, O, b)
    xp = cuda_riccati.solve_batched_plain(torch.tensor(D), torch.tensor(O), torch.tensor(b)).numpy()
    assert np.isnan(xm[1]).all() and np.isnan(xp[1]).all()
    assert np.isfinite(xm[[0, 2]]).all()
    assert _rel(xm[[0, 2]], xp[[0, 2]]) <= RTOL


@pytest.mark.parametrize("where", WHERE)
@pytest.mark.parametrize("T", HORIZONS)
@pytest.mark.parametrize("d", STREAM_WIDTHS)
def test_factor_stream_stage_model_matches_plain(d, T, where):
    """The 2d-row stacked panel of factor_stream past d = 64, up to its
    MAX_D: L and M within RTOL of factor_stream_plain, NaN on the same
    stages (from the failing one on for lane 1, none for lanes 0 and 2),
    zeros above L's diagonal."""
    D, O, _, bad = _inputs(d, T, where)
    Lm, Mm = _factor_stream_model(D, O)
    Lp, Mp = (a.numpy() for a in cuda_riccati.factor_stream_plain(torch.tensor(D), torch.tensor(O)))
    stage_nan = lambda A: np.isnan(A).any(axis=(-2, -1))
    assert (stage_nan(Lm) == stage_nan(Lp)).all() and (stage_nan(Mm) == stage_nan(Mp)).all()
    assert stage_nan(Lm)[1].tolist() == [t >= bad for t in range(T)] and not stage_nan(Lm)[[0, 2]].any()
    ok = ~stage_nan(Lp)
    assert _rel(Lm[ok], Lp[ok]) <= RTOL
    if T > 1:
        assert _rel(Mm[ok[:, :-1]], Mp[ok[:, :-1]]) <= RTOL
    assert (np.triu(Lm, 1) == 0).all()


# The wide stream sweeps (`sweep_wide` in csrc/riccati_stream.cu, d past 64):
# each stage a blocked substitution over 32-row diagonal blocks (forward
# from the top, backward from the bottom, the last block ragged), each
# block's pivots by the reciprocal from the block alone, then the block's
# columns taken off the rows still to solve and its share of the coupling
# taken off the next stage's right-hand side, so that the coupling comes
# block by block as the solution does.
SWEEP_WIDTHS = [65, 82, 96, 97, 120, 121, 165, 169]
SWEEP_HORIZONS = [1, 2, 8]
SWEEP_COLUMNS = [1, 2, 17]
SWEEP_RTOL = 1e-12  # float64: the plain solve's arithmetic in another order


def _sweep_inputs(d, T, K):
    """Three lanes of a factor as factor_stream gives it: L_t lower
    triangular with a diagonal near sqrt(d) (zeros above), M_t = 0.3 N(0,
    1) / sqrt(d), b (B, T, d, K); lane 1 not positive definite from its
    middle stage on (NaN over the lower triangle of L and over M from
    there, the factor's contract)."""
    rng = np.random.default_rng(100 * d + 10 * T + K)
    L = np.tril(rng.normal(size=(3, T, d, d))) + np.sqrt(d) * np.eye(d)
    M = 0.3 * rng.normal(size=(3, T - 1, d, d)) / np.sqrt(d)
    bad = (T - 1) // 2
    L[1, bad:] = np.where(np.tril(np.ones((d, d), bool)), np.nan, 0.0)
    M[1, bad:] = np.nan
    return L, M, rng.normal(size=(3, T, d, K))


def _diag_solve(Lq, r, fwd):
    """One diagonal block, a column of r (its rows) a warp: pivot j's value
    r_j / l_jj by the reciprocal, then the other rows take column j
    (forward, the rows below) or row j (backward, the rows above)."""
    inv = 1.0 / np.diag(Lq)
    n = Lq.shape[0]
    for j in range(n) if fwd else reversed(range(n)):
        v = r[j] * inv[j]
        if fwd:
            r[j + 1:] -= np.outer(Lq[j + 1:, j], v)
        else:
            r[:j] -= np.outer(Lq[j, :j], v)
        r[j] = v


def _sweep_model(L, M, rhs, fwd):
    """The forward sweep u (fwd) from b, or the backward sweep x from u."""
    B, T, d, _ = rhs.shape
    out = np.zeros_like(rhs)
    blocks = [(j0, min(j0 + BLOCK, d)) for j0 in range(0, d, BLOCK)]
    for lane in range(B):
        stages = range(T) if fwd else reversed(range(T))
        r = rhs[lane, 0 if fwd else T - 1].copy()
        for t in stages:
            tn = t + 1 if fwd else t - 1
            rn = rhs[lane, tn].copy() if 0 <= tn < T else None
            Lt = L[lane, t]
            for j0, j1 in blocks if fwd else reversed(blocks):
                _diag_solve(Lt[j0:j1, j0:j1], r[j0:j1], fwd)
                if fwd:
                    r[j1:] -= Lt[j1:, j0:j1] @ r[j0:j1]  # row tiles: rows i >= j1
                    if rn is not None:
                        rn -= M[lane, t, j0:j1].T @ r[j0:j1]  # column tiles: rows of M_t
                else:
                    r[:j0] -= Lt[j0:j1, :j0].T @ r[j0:j1]  # column tiles: rows j of L_t
                    if rn is not None:
                        rn -= M[lane, t - 1, :, j0:j1] @ r[j0:j1]  # row tiles of M_{t-1}
            out[lane, t] = r
            r = rn
    return out


def _hold_sweep(got, want):
    same_nan = np.isnan(got) == np.isnan(want)
    assert same_nan.all()
    assert np.isnan(want[1]).any() and np.isfinite(want[[0, 2]]).all()
    ok = ~np.isnan(want)
    assert _rel(got[ok], want[ok]) <= SWEEP_RTOL


@pytest.mark.parametrize("K", SWEEP_COLUMNS)
@pytest.mark.parametrize("T", SWEEP_HORIZONS)
@pytest.mark.parametrize("d", SWEEP_WIDTHS)
def test_wide_forward_sweep_model_matches_plain(d, T, K):
    """The blocked forward sweep, the coupling b_{t+1} - M_t' u_t taken
    block by block: u within SWEEP_RTOL of solve_fwd_stream_plain, NaN
    where it has NaN (lane 1 from its middle stage on)."""
    L, M, b = _sweep_inputs(d, T, K)
    want = cuda_riccati.solve_fwd_stream_plain(torch.tensor(L), torch.tensor(M), torch.tensor(b)).numpy()
    _hold_sweep(_sweep_model(L, M, b, fwd=True), want)


@pytest.mark.parametrize("K", SWEEP_COLUMNS)
@pytest.mark.parametrize("T", SWEEP_HORIZONS)
@pytest.mark.parametrize("d", SWEEP_WIDTHS)
def test_wide_backward_sweep_model_matches_plain(d, T, K):
    """The blocked backward sweep from the plain u, the coupling u_{t-1} -
    M_{t-1} x_t taken block by block: x within SWEEP_RTOL of
    solve_bwd_stream_plain, NaN over all of lane 1 (the NaN stage's x
    reaches every earlier stage through M)."""
    L, M, b = _sweep_inputs(d, T, K)
    Lt, Mt = torch.tensor(L), torch.tensor(M)
    u = cuda_riccati.solve_fwd_stream_plain(Lt, Mt, torch.tensor(b))
    want = cuda_riccati.solve_bwd_stream_plain(Lt, Mt, u).numpy()
    assert np.isnan(want[1]).all()
    _hold_sweep(_sweep_model(L, M, u.numpy(), fwd=False), want)
