"""Numpy models of the order of operations of the two CUDA kernels that
keep a warp's rows in registers -- `factor_lanes` for d <= 32 (the
stacked panel [S_t ; O_t] with shuffled l_jk and a Gram coupling) and
`solve_t1` for n <= 32 (reciprocal pivots, a forward sweep down the
columns of L, a backward sweep down its rows) -- held to the plain
versions on the CPU in float64, so the widths at the kernels' edges and
the lanes that are not positive definite are checked where no card is
needed."""

import numpy as np
import pytest
import torch

from calipso_tpu_torch.ops import cuda_riccati
from tests.test_torch_riccati import FACTOR_ATOL, SOLVE_ATOL, _tridiag_batch


def _gram4(o):
    """o @ o.T in factor_lanes' order: entry (i, j) as four partial sums
    of o_ik o_jk over k = 0, 4, 8, ...; 1, 5, ...; 2, ...; 3, ..., each in
    increasing k, added pairwise."""
    p = [np.zeros((o.shape[0], o.shape[0])) for _ in range(4)]
    for k in range(o.shape[1]):
        p[k % 4] = p[k % 4] + np.outer(o[:, k], o[:, k])
    return (p[0] + p[1]) + (p[2] + p[3])


def _factor_lanes_model(D, O):
    """factor_lanes' arithmetic for d <= 32, lane by lane, with thread i's
    registers as row i of two arrays: s (S_t) and o (O_t). S_t = D_t minus
    the Gram product of the previous stage's o rows (_gram4); at pivot k
    the diagonal s_kk, its sqrt and one reciprocal, column k of s and of o
    scaled by it (s_kk set to the sqrt), then for each j > k the broadcast
    l_jk = s_jk and every row's s_ij -= s_ik l_jk and o_ij -= o_ik l_jk.
    The lower triangle of s ends as L_t, o as M_t'. A failed pivot: NaN
    over the lower triangle of L_t and of every later L, and over every M
    from M_t on."""
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
            for k in range(d):
                piv = s[k, k]
                if not (piv > 0 and np.isfinite(piv)):
                    failed = t
                    break
                lkk = np.sqrt(piv)
                inv = 1.0 / lkk
                s[:, k] *= inv
                s[k, k] = lkk
                o[:, k] *= inv
                for j in range(k + 1, d):
                    ljk = s[j, k]
                    s[:, j] -= s[:, k] * ljk
                    o[:, j] -= o[:, k] * ljk
            if failed is not None:
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
