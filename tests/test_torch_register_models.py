"""Numpy models of the order of operations of the CUDA kernels that keep
a warp's rows in registers -- `factor_lanes` for d <= 32 (the stacked
panel [S_t ; O_t] with shuffled l_jk and a Gram coupling), `solve_t1` and
`factor_t1` for n <= 32 (reciprocal pivots; the solve's forward sweep
down the columns of L and backward sweep down its rows; the factor's
shuffled l_jk) and their panel kernels for n in 33..128 (32-wide panels,
the trailing update, the blocked substitution) and the fused `solve_batched_fused` for d <= 32 (the
panel factor with the forward sweep folded in, then the backward sweep),
also on `solve_batched_lanes`' batch-last copies through a model of the
kernel's stage gather, and the tiled transpose that makes those copies --
held to the plain versions on the CPU in float64, so the widths at the
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


def _factor_t1_panel_model(S):
    """factor_t1's arithmetic for n in 33..128 (factor_t1_panel_kernel),
    system by system: the matrix padded with rows of the identity to 32 P;
    at panel p the diagonal block's rows s and the strip below it through
    _panel_pivots (each warp repeats the diagonal pivots on its own strip:
    the same arithmetic, so one call on the stacked strips), then each
    lower trailing block less L21 L21' one k at a time. A bad pivot in any
    panel: NaN over the whole lower triangle, zeros above it."""
    B, n = S.shape[0], S.shape[-1]
    N = 32 * -(-n // 32)
    lower = np.tril(np.ones((n, n), bool))
    L = np.zeros_like(S)
    for b in range(B):
        A = np.eye(N)
        A[:n, :n] = S[b]
        ok = True
        for c0 in range(0, N, 32):
            s, o = A[c0:c0 + 32, c0:c0 + 32].copy(), A[c0 + 32:, c0:c0 + 32].copy()
            if _panel_pivots(s, o) is None:
                ok = False
                break
            A[c0:c0 + 32, c0:c0 + 32], A[c0 + 32:, c0:c0 + 32] = s, o
            for k in range(32):
                A[c0 + 32:, c0 + 32:] -= np.outer(o[:, k], o[:, k])
        L[b] = np.where(lower, A[:n, :n] if ok else np.nan, 0.0)
    return L


def _solve_t1_panel_model(L, b):
    """solve_t1's arithmetic for n in 33..128 (solve_t1_panel_kernel),
    system by system, with L padded by zero rows and b by zeros to 32 P:
    from the top each diagonal block solved as the register kernel does
    (reciprocal pivots), then the rows below less their row of the panel
    dotted with u (_dot4); from the bottom each diagonal block's transpose,
    then the columns left of it less sum_j L[j][t] x_j (_dot4 over j)."""
    B, n = b.shape
    N = 32 * -(-n // 32)
    x = np.zeros_like(b)
    for s in range(B):
        A = np.zeros((N, N))
        A[:n, :n] = L[s]
        inv = np.ones(N)
        inv[:n] = 1.0 / np.diag(L[s])
        r = np.zeros(N)
        r[:n] = b[s]
        for c0 in range(0, N, 32):
            for j in range(c0, c0 + 32):
                uj = r[j] * inv[j]
                r[j + 1:c0 + 32] -= A[j + 1:c0 + 32, j] * uj
                r[j] = uj
            if c0 + 32 < N:
                r[c0 + 32:] -= _dot4(A[c0 + 32:, c0:c0 + 32], r[c0:c0 + 32])
        for c0 in reversed(range(0, N, 32)):
            for j in reversed(range(c0, c0 + 32)):
                xj = r[j] * inv[j]
                r[c0:j] -= A[j, c0:j] * xj
                r[j] = xj
            if c0:
                r[:c0] -= _dot4(A[c0:c0 + 32, :c0].T, r[c0:c0 + 32])
        x[s] = r[:n]
    return x


def _gather_stage_batch_last(Dl, OTl, bl, n, b):
    """Stage n's slot of lane b as the fused register kernel fills it from
    the batch-last arrays (csrc/riccati_fused.cu, copy_fused_stage): slot
    element e of D_n from flat index (n d^2 + e) B + b of Dl (T, d, d, B),
    of O'_n from the same index of OTl (T-1, d, d, B) but at the last stage
    (nothing: zeros), of b_n from (n d + e) B + b of bl (T, d, B). Returns
    the three flat blocks."""
    T, d, B = bl.shape
    e = np.arange(d * d)
    Ds = Dl.reshape(-1)[(n * d * d + e) * B + b]
    Os = OTl.reshape(-1)[(n * d * d + e) * B + b] if n < T - 1 else np.zeros(d * d)
    bs = bl.reshape(-1)[(n * d + np.arange(d)) * B + b]
    return Ds, Os, bs


def _solve_batched_model(D, O, b, batch_last=False):
    """solve_batched_fused's arithmetic for d <= 32, lane by lane. Forward,
    a stage at a time: S_t = D_t - _gram4 of the previous o rows and r_t =
    b_t - _dot4 of those rows with u_{t-1} (row i is column i of M_{t-1}),
    _panel_pivots on [S_t ; O_t], then u_j = r_j (1 / l_jj), broadcast,
    the rows below take column j of L_t. Backward from the last stage: r =
    u_t - _dot4(M_t, x_{t+1}) (M_t = o', row i the column i of the o rows),
    x_j = r_j (1 / l_jj) from the bottom, the rows above take row j of L_t.
    A stage that fails puts NaN over all of the lane's x. With
    `batch_last`, solve_batched_lanes: each stage's blocks come through
    _gather_stage_batch_last from the wrapper's copies, and thread c reads
    its o row as column c of the slot's O_t' (Os[k d + c])."""
    B, T, d = b.shape
    if batch_last:
        copies = [a.numpy() for a in cuda_riccati.batch_last(*(torch.tensor(a) for a in (D, O, b)))]

    def stage(lane, t):
        if batch_last:
            Ds, Os, bs = _gather_stage_batch_last(*copies, t, lane)
            return Ds.reshape(d, d).copy(), Os.reshape(d, d).T.copy(), bs.copy()
        return D[lane, t].copy(), O[lane, t].copy() if t < T - 1 else np.zeros((d, d)), b[lane, t].copy()

    x = np.full_like(b, np.nan)
    for lane in range(B):
        kept, o, u = [], np.zeros((d, d)), None
        for t in range(T):
            s, o_t, r = stage(lane, t)
            if t > 0:
                s -= _gram4(o)
                r -= _dot4(o, u)
            o = o_t
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


@pytest.mark.parametrize("n", [33, 64, 65, 110, 128])
def test_t1_panel_models_match_plain(n):
    """The panel kernels' order of operations at a ragged and a full last
    panel, the bunny hop's n=110 and the widest n: system 1 of three fails
    only at its last pivot (in the last panel): NaN over its whole lower
    triangle on both, zeros above every diagonal; the others' factor and
    solve match the plain versions."""
    rng = np.random.default_rng(200 + n)
    A = rng.normal(size=(3, n, n))
    S = A @ np.swapaxes(A, 1, 2) + n * np.eye(n)
    S[1, n - 1, n - 1] = -5.0
    b = rng.normal(size=(3, n))
    Lp = cuda_riccati.factor_t1_plain(torch.tensor(S)).numpy()
    Lm = _factor_t1_panel_model(S)
    lower = np.tril(np.ones((n, n), bool))
    assert np.isnan(Lm[1][lower]).all() and np.isnan(Lp[1][lower]).all()
    assert (Lm[:, ~lower] == 0).all()
    keep = [0, 2]
    np.testing.assert_allclose(Lm[keep], Lp[keep], atol=FACTOR_ATOL, rtol=0)
    xm = _solve_t1_panel_model(Lm[keep], b[keep])
    xp = cuda_riccati.solve_t1_plain(torch.tensor(Lp[keep]), torch.tensor(b[keep])).numpy()
    np.testing.assert_allclose(xm, xp, atol=SOLVE_ATOL, rtol=0)


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


@pytest.mark.parametrize("T", [1, 2, 8])
@pytest.mark.parametrize("d", [1, 9, 32, 54])
def test_batch_last_gather_matches_batch_first(d, T):
    """The batch-last stage gather, on solve_batched_lanes' copies of seeded
    (B, T, d, d) inputs at B = 7 (not a multiple of the 4 lanes a block):
    every lane's slot at every stage holds D_n, O_n' and b_n of that lane,
    bit for bit, at d = 1, the rocket's 9, the warp's 32 and the
    quadruped's 54."""
    rng = np.random.default_rng(3000 + 10 * d + T)
    B = 7
    D, O, b = _tridiag_batch(rng, B, T, d)
    copies = [a.numpy() for a in cuda_riccati.batch_last(*(torch.tensor(a) for a in (D, O, b)))]
    assert [c.shape for c in copies] == [(T, d, d, B), (T - 1, d, d, B), (T, d, B)]
    for lane in range(B):
        for n in range(T):
            Ds, Os, bs = _gather_stage_batch_last(*copies, n, lane)
            assert np.array_equal(Ds.reshape(d, d), D[lane, n])
            assert np.array_equal(Os.reshape(d, d), O[lane, n].T if n < T - 1 else np.zeros((d, d)))
            assert np.array_equal(bs, b[lane, n])


@pytest.mark.parametrize("T", [1, 31])
@pytest.mark.parametrize("d", [1, 9, 32])
def test_solve_batched_lanes_model_matches_plain(d, T):
    """The fused register solve driven through the batch-last gather and
    the transposed o read gives the batch-first model's x bit for bit and
    holds to the plain version, at d = 1, the rocket's 9 and the warp's 32,
    T = 1 and the rocket's 31, B = 5; lane 3 is not positive definite at
    its middle stage: all of its x NaN on both, the others finite."""
    rng = np.random.default_rng(4000 + 10 * d + T)
    D, O, b = _tridiag_batch(rng, 5, T, d)
    D[3, T // 2] = -np.eye(d)
    xp = cuda_riccati.solve_batched_plain(torch.tensor(D), torch.tensor(O), torch.tensor(b)).numpy()
    xm = _solve_batched_model(D, O, b, batch_last=True)
    assert np.array_equal(xm, _solve_batched_model(D, O, b), equal_nan=True)
    assert np.isnan(xm[3]).all() and np.isnan(xp[3]).all()
    keep = [0, 1, 2, 4]
    assert np.isfinite(xm[keep]).all()
    np.testing.assert_allclose(xm[keep], xp[keep], atol=SOLVE_ATOL, rtol=0)


def _transpose_model(X, R, C, d=0):
    """The transpose kernel (csrc/riccati_fused.cu) tile by tile: each 32 x
    32 tile of X read as (R, C), input column c of a tile written to
    output row c or, where d > 0, to t d^2 + i d + j for c = t d^2 + j d +
    i; returns the flat (C, R) result."""
    X = X.reshape(R, C)
    out = np.full(R * C, np.nan)
    for r0 in range(0, R, 32):
        for c0 in range(0, C, 32):
            tile = X[r0:r0 + 32, c0:c0 + 32]
            for k in range(tile.shape[1]):
                c = c0 + k
                if d > 0:
                    t, e = divmod(c, d * d)
                    j, i = divmod(e, d)
                    c = t * d * d + i * d + j
                out[c * R + r0:c * R + r0 + tile.shape[0]] = tile[:, k]
    return out


@pytest.mark.parametrize("B,T,d", [(7, 3, 9), (33, 2, 54), (40, 1, 5), (1, 4, 32)])
def test_transpose_model_matches_batch_last_plain(B, T, d):
    """The transpose kernel's tiling and its in-block index map give the
    batch-last copies of batch_last_plain and, read back, batch_first_plain,
    bit for bit: ragged tiles (B = 7, 33; T d^2 not a multiple of 32), T
    = 1 (an empty O) and one lane."""
    rng = np.random.default_rng(5000 + B + T + d)
    D, O, b = _tridiag_batch(rng, B, T, d)
    want = [a.numpy() for a in cuda_riccati.batch_last_plain(*(torch.tensor(a) for a in (D, O, b)))]
    got = [
        _transpose_model(D, B, T * d * d).reshape(T, d, d, B),
        _transpose_model(O, B, (T - 1) * d * d, d).reshape(T - 1, d, d, B),
        _transpose_model(b, B, T * d).reshape(T, d, B),
    ]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    back = _transpose_model(got[2], T * d, B).reshape(B, T, d)
    assert np.array_equal(back, cuda_riccati.batch_first_plain(torch.tensor(want[2])).numpy())
    assert np.array_equal(back, b)


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
