"""Numpy models of the order of operations of the CUDA kernels that keep
a warp's rows in registers -- `factor_lanes` for d <= 32 (the stacked
panel [S_t ; O_t] with shuffled l_jk and a Gram coupling), `solve_t1` and
`factor_t1` for n <= 32 (reciprocal pivots; the solve's forward sweep
down the columns of L and backward sweep down its rows; the factor's
shuffled l_jk) and the fused `solve_batched_fused` for d <= 32 (the
panel factor with the forward sweep folded in, then the backward sweep)
-- held to the plain versions on the CPU in float64, so the widths at the
kernels' edges and the lanes that are not positive definite are checked
where no card is needed. Also the build key of the kernels' libraries,
which covers the header they share."""

import numpy as np
import pytest
import torch

from calipso_tpu_torch.ops import _build, cuda_riccati
from tests.test_torch_riccati import FACTOR_ATOL, SOLVE_ATOL, _tridiag_batch
from tests.test_torch_stream import _dot4


def _gram4(o):
    """o @ o.T in factor_lanes' order: entry (i, j) as four partial sums
    of o_ik o_jk over k = 0, 4, 8, ...; 1, 5, ...; 2, ...; 3, ..., each in
    increasing k, added pairwise."""
    p = [np.zeros((o.shape[0], o.shape[0])) for _ in range(4)]
    for k in range(o.shape[1]):
        p[k % 4] = p[k % 4] + np.outer(o[:, k], o[:, k])
    return (p[0] + p[1]) + (p[2] + p[3])


def _panel_pivots(s, o):
    """panel_pivots (csrc/riccati_reg.cuh) on the rows s of a d x d block
    and o of the block below it, in place: at pivot k the diagonal s_kk,
    its sqrt and one reciprocal, column k of s and of o scaled by it (s_kk
    set to the sqrt), then for each j > k the broadcast l_jk = s_jk and
    every row's s_ij -= s_ik l_jk and o_ij -= o_ik l_jk. Returns the
    reciprocals 1 / l_kk, or None at a pivot that is not positive or not
    finite."""
    inv = np.zeros(s.shape[0])
    for k in range(s.shape[0]):
        piv = s[k, k]
        if not (piv > 0 and np.isfinite(piv)):
            return None
        lkk = np.sqrt(piv)
        inv[k] = 1.0 / lkk
        s[:, k] *= inv[k]
        s[k, k] = lkk
        o[:, k] *= inv[k]
        for j in range(k + 1, s.shape[0]):
            ljk = s[j, k]
            s[:, j] -= s[:, k] * ljk
            o[:, j] -= o[:, k] * ljk
    return inv


def _factor_lanes_model(D, O):
    """factor_lanes' arithmetic for d <= 32, lane by lane, with thread i's
    registers as row i of two arrays: s (S_t) and o (O_t). S_t = D_t minus
    the Gram product of the previous stage's o rows (_gram4), then
    _panel_pivots. The lower triangle of s ends as L_t, o as M_t'. A
    failed pivot: NaN over the lower triangle of L_t and of every later L,
    and over every M from M_t on."""
    B, T, d = D.shape[0], D.shape[1], D.shape[-1]
    L, M = np.zeros_like(D), np.zeros_like(O)
    lower = np.tril(np.ones((d, d), bool))
    for b in range(B):
        o_prev, failed = None, None
        for t in range(T):
            s = D[b, t].copy()
            if o_prev is not None:
                s -= _gram4(o_prev)
            o = O[b, t].copy() if t < T - 1 else np.zeros((d, d))
            if _panel_pivots(s, o) is None:
                failed = t
                break
            L[b, t] = np.where(lower, s, 0.0)
            if t < T - 1:
                M[b, t] = o.T
                o_prev = o
        if failed is not None:
            L[b, failed:] = np.where(lower, np.nan, 0.0)
            M[b, failed:] = np.nan
    return L, M


def _solve_t1_model(L, b):
    """solve_t1's arithmetic for n <= 32, system by system: 1 / L_ii once;
    from the top u_j = r_j (1 / L_jj), broadcast, the rows below take
    column j of L; from the bottom x_j = r_j (1 / L_jj), the rows above take
    row j of L."""
    x = np.zeros_like(b)
    for s in range(b.shape[0]):
        inv = 1.0 / np.diag(L[s])
        r = b[s].copy()
        for j in range(r.size):
            uj = r[j] * inv[j]
            r[j + 1:] -= L[s, j + 1:, j] * uj
            r[j] = uj
        for j in reversed(range(r.size)):
            xj = r[j] * inv[j]
            r[:j] -= L[s, j, :j] * xj
            r[j] = xj
        x[s] = r
    return x


@pytest.mark.parametrize("where", [0, 1, 2], ids=["first", "middle", "last"])
@pytest.mark.parametrize("T", [1, 2, 31])
@pytest.mark.parametrize("d", [1, 8, 9, 16, 17, 31, 32])
def test_factor_lanes_model_matches_plain(d, T, where):
    """The register factor at the widths of its two buckets (up to 16, up
    to 32) and their edges, the rocket's d=9 and T=31; lane 0 of three is
    not positive definite at its first, middle or last stage, with NaN on
    the same stages as the plain version and the other lanes finite."""
    rng = np.random.default_rng(1000 * d + 10 * T + where)
    D, O, _ = _tridiag_batch(rng, 3, T, d)
    bad = (0, (T - 1) // 2, T - 1)[where]
    D[0, bad] = -np.eye(d)
    Lm, Mm = _factor_lanes_model(D, O)
    Lp, Mp = (a.numpy() for a in cuda_riccati.factor_lanes_plain(torch.tensor(D), torch.tensor(O)))
    stage_nan = lambda A: np.isnan(A).any(axis=(-2, -1))
    assert (stage_nan(Lm) == stage_nan(Lp)).all() and (stage_nan(Mm) == stage_nan(Mp)).all()
    assert stage_nan(Lm)[0].tolist() == [t >= bad for t in range(T)]
    assert not stage_nan(Lm)[1:].any() and np.isfinite(Lm[1:]).all() and np.isfinite(Mm[1:]).all()
    ok = ~stage_nan(Lp)
    np.testing.assert_allclose(Lm[ok], Lp[ok], atol=FACTOR_ATOL, rtol=0)
    np.testing.assert_allclose(Mm[ok[:, :-1]], Mp[ok[:, :-1]], atol=FACTOR_ATOL, rtol=0)
    assert (np.triu(Lm, 1) == 0).all()


@pytest.mark.parametrize("n", [1, 5, 31, 32])
def test_solve_t1_model_matches_plain(n):
    """The register solve at n = 1, an odd width, the width below the warp
    and the flagship's 32; system 1 of four is not positive definite and
    comes out NaN on both."""
    rng = np.random.default_rng(n)
    A = rng.normal(size=(4, n, n))
    S = A @ np.swapaxes(A, 1, 2) + n * np.eye(n)
    S[1] *= -1.0
    b = rng.normal(size=(4, n))
    L = cuda_riccati.factor_t1_plain(torch.tensor(S))
    xp = cuda_riccati.solve_t1_plain(L, torch.tensor(b)).numpy()
    xm = _solve_t1_model(L.numpy(), b)
    assert np.isnan(xm[1]).all() and np.isnan(xp[1]).all()
    keep = [0, 2, 3]
    assert np.isfinite(xm[keep]).all()
    np.testing.assert_allclose(xm[keep], xp[keep], atol=SOLVE_ATOL, rtol=0)


def _factor_t1_model(S):
    """factor_t1's arithmetic for n <= 32, system by system: thread i's
    registers as row i of s, _panel_pivots with no block below; NaN over
    the lower triangle of a system that is not positive definite, zeros
    above it."""
    n = S.shape[-1]
    lower = np.tril(np.ones((n, n), bool))
    L = np.zeros_like(S)
    for b in range(S.shape[0]):
        s = S[b].copy()
        ok = _panel_pivots(s, np.zeros((0, n))) is not None
        L[b] = np.where(lower, s if ok else np.nan, 0.0)
    return L


def _solve_batched_model(D, O, b):
    """solve_batched_fused's arithmetic for d <= 32, lane by lane. Forward,
    a stage at a time: S_t = D_t - _gram4 of the previous o rows and r_t =
    b_t - _dot4 of those rows with u_{t-1} (row i is column i of M_{t-1}),
    _panel_pivots on [S_t ; O_t], then u_j = r_j (1 / l_jj), broadcast,
    the rows below take column j of L_t. Backward from the last stage: r =
    u_t - _dot4(M_t, x_{t+1}) (M_t = o', row i the column i of the o rows),
    x_j = r_j (1 / l_jj) from the bottom, the rows above take row j of L_t.
    A stage that fails puts NaN over all of the lane's x."""
    B, T, d = b.shape
    x = np.full_like(b, np.nan)
    for lane in range(B):
        kept, o, u = [], np.zeros((d, d)), None
        for t in range(T):
            s, r = D[lane, t].copy(), b[lane, t].copy()
            if t > 0:
                s -= _gram4(o)
                r -= _dot4(o, u)
            o = O[lane, t].copy() if t < T - 1 else np.zeros((d, d))
            inv = _panel_pivots(s, o)
            if inv is None:
                break
            for j in range(d):
                uj = r[j] * inv[j]
                r[j + 1:] -= s[j + 1:, j] * uj
                r[j] = uj
            kept.append((s, o, inv, r))
            u = r
        else:
            nxt = None
            for t in reversed(range(T)):
                s, o, inv, r = (a.copy() for a in kept[t])
                if nxt is not None:
                    r -= _dot4(o.T, nxt)
                for j in reversed(range(d)):
                    xj = r[j] * inv[j]
                    r[:j] -= s[j, :j] * xj
                    r[j] = xj
                x[lane, t] = nxt = r
    return x


@pytest.mark.parametrize("n", [1, 5, 31, 32])
def test_factor_t1_model_matches_plain(n):
    """The register factor at n = 1, an odd width, the width below the
    warp and the flagship's 32; system 1 of four is not positive definite:
    NaN over its lower triangle on both, zeros above the diagonal
    everywhere."""
    rng = np.random.default_rng(100 + n)
    A = rng.normal(size=(4, n, n))
    S = A @ np.swapaxes(A, 1, 2) + n * np.eye(n)
    S[1] *= -1.0
    Lp = cuda_riccati.factor_t1_plain(torch.tensor(S)).numpy()
    Lm = _factor_t1_model(S)
    lower = np.tril(np.ones((n, n), bool))
    assert np.isnan(Lm[1][lower]).all() and np.isnan(Lp[1][lower]).all()
    assert (Lm[:, ~lower] == 0).all()
    keep = [0, 2, 3]
    assert np.isfinite(Lm[keep]).all()
    np.testing.assert_allclose(Lm[keep], Lp[keep], atol=FACTOR_ATOL, rtol=0)


@pytest.mark.parametrize("where", [0, 1, 2], ids=["first", "middle", "last"])
@pytest.mark.parametrize("T", [1, 2, 31])
@pytest.mark.parametrize("d", [1, 9, 16, 17, 31, 32])
def test_solve_batched_model_matches_plain(d, T, where):
    """The fused register solve at d = 1, the rocket's 9, the edges of its
    width buckets (16, 17) and of the warp (31, 32), T = 1, 2 and the
    rocket's 31; lane 0 of three is not positive definite at its first,
    middle or last stage: all of its x NaN on both, the others finite."""
    rng = np.random.default_rng(2000 + 100 * d + 10 * T + where)
    D, O, b = _tridiag_batch(rng, 3, T, d)
    D[0, (0, (T - 1) // 2, T - 1)[where]] = -np.eye(d)
    xp = cuda_riccati.solve_batched_plain(torch.tensor(D), torch.tensor(O), torch.tensor(b)).numpy()
    xm = _solve_batched_model(D, O, b)
    assert np.isnan(xm[0]).all() and np.isnan(xp[0]).all()
    assert np.isfinite(xm[1:]).all()
    np.testing.assert_allclose(xm[1:], xp[1:], atol=SOLVE_ATOL, rtol=0)


def test_build_key_covers_the_shared_header(tmp_path):
    """A library's path changes with the source and with any header beside
    it, so that an edited header never loads a library built before the
    edit; an unchanged tree keeps its path."""
    src = tmp_path / "kernel.cu"
    header = tmp_path / "shared.cuh"
    src.write_text('#include "shared.cuh"\n')
    header.write_text("// v1\n")
    first = _build.library_path(src)
    assert _build.library_path(src) == first
    header.write_text("// v2\n")
    second = _build.library_path(src)
    assert second != first
    src.write_text('#include "shared.cuh"\n// edited\n')
    assert _build.library_path(src) not in (first, second)
    shipped = [_build.library_path(p) for p in _build.SOURCES]
    assert len(set(shipped)) == len(shipped)
    assert (_build.PACKAGE_DIR / "csrc" / "riccati_reg.cuh").exists()
