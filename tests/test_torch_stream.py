"""The port's stream route of the riccati backend against the JAX package
on the CPU in float64: the plain versions of the CUDA kernels
`factor_stream`, `solve_fwd_stream` and `solve_bwd_stream` against the
interpret-mode Pallas stream kernels they replace and the reference scan,
the first stage that is not positive definite, and `solve_multi` with
several right-hand sides per lane against `calipso_tpu.ops.riccati`.

Also a numpy model of the order of operations of the CUDA kernels
redesigned for the card -- `factor_stream`'s blocked factor of the
stacked panel [S_t ; O_t] in 8-wide panels, the pivot-broadcast
substitutions of `solve_fwd_stream` and `solve_bwd_stream` (reciprocal
pivots), and `solve_lanes`' two sweeps with their four-way partial-sum
coupling -- held to the plain versions, so the panel edges and the
orders of operations are checked where no card is needed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calipso_tpu.ops import pallas_riccati as pr
from calipso_tpu.ops import riccati as jrc
from calipso_tpu_torch.ops import cuda_riccati, riccati
from tests.test_torch_riccati import FACTOR_ATOL, SOLVE_ATOL, _tridiag_batch


def _stream_plain(D, O, b):
    L, M = cuda_riccati.factor_stream_plain(torch.tensor(D), torch.tensor(O))
    u = cuda_riccati.solve_fwd_stream_plain(L, M, torch.tensor(b)[..., None])
    x = cuda_riccati.solve_bwd_stream_plain(L, M, u)[..., 0]
    return L.numpy(), M.numpy(), x.numpy()


@pytest.mark.parametrize(
    "B,T,d,tile",
    # tests/test_pallas_riccati.py:89-92: d=13 is padded to 16 inside the
    # stream wrappers, T=1, odd T, and T=4 runs the 2-stage chunk pipeline
    [(4, 5, 6, 2), (4, 1, 5, 4), (6, 3, 4, 3), (3, 3, 16, 3), (2, 2, 13, 2), (4, 4, 6, 2), (2, 4, 16, 2)],
)
def test_stream_plain_match_pallas_interpret_and_scan(B, T, d, tile):
    D, O, b = _tridiag_batch(np.random.default_rng(T * 100 + d + tile), B, T, d)
    Lt, Mt, xt = _stream_plain(D, O, b)
    jD, jO, jb = jnp.asarray(D), jnp.asarray(O), jnp.asarray(b)
    Lp, Mp = pr.factor_lanes_stream(jD, jO, batch_tile=tile, interpret=True)
    Lr, Mr = jax.vmap(jrc.factor)(jD, jO)
    for L, M in ((Lp, Mp), (Lr, Mr)):
        np.testing.assert_allclose(Lt, np.asarray(L), atol=FACTOR_ATOL, rtol=0)
        np.testing.assert_allclose(Mt, np.asarray(M), atol=FACTOR_ATOL, rtol=0)
    xp = pr.solve_lanes_stream(Lp, Mp, jb, batch_tile=tile, interpret=True)
    xr = jax.vmap(jrc.solve)(Lr, Mr, jb)
    for x in (xp, xr):
        np.testing.assert_allclose(xt, np.asarray(x), atol=SOLVE_ATOL, rtol=0)


def test_stream_first_nan_stage_matches_the_scan():
    """Lanes 0 and 2 turn indefinite at stages 1 and 4 of 6: the plain
    stream factor is NaN from the same stage on as the reference scan
    (by propagation) and the Pallas stream kernel, and exact before it."""
    B, T, d = 3, 6, 7
    D, O, b = _tridiag_batch(np.random.default_rng(11), B, T, d)
    D[0, 1] = -np.eye(d)
    D[2, 4] -= 50.0 * np.eye(d)
    Lt, Mt = (a.numpy() for a in cuda_riccati.factor_stream_plain(torch.tensor(D), torch.tensor(O)))
    Lr, Mr = (np.asarray(a) for a in jax.vmap(jrc.factor)(jnp.asarray(D), jnp.asarray(O)))
    Lp, _ = pr.factor_lanes_stream(jnp.asarray(D), jnp.asarray(O), batch_tile=B, interpret=True)
    first_bad = lambda L: [
        int(np.argmax(row)) if row.any() else -1 for row in ~np.isfinite(L).all(axis=(-2, -1))
    ]
    assert first_bad(Lt) == first_bad(Lr) == first_bad(np.asarray(Lp)) == [1, -1, 4]
    stage_bad = ~np.isfinite(Lt).all(axis=(-2, -1))
    assert (stage_bad == ~np.isfinite(Lr).all(axis=(-2, -1))).all()
    ok = ~stage_bad
    np.testing.assert_allclose(Lt[ok], Lr[ok], atol=FACTOR_ATOL, rtol=0)
    np.testing.assert_allclose(Mt[ok[:, :-1]], Mr[ok[:, :-1]], atol=FACTOR_ATOL, rtol=0)


@pytest.mark.parametrize("d", [6, 40])
def test_solve_multi_matches_jax(d):
    """K=5 right-hand sides per lane on both routes' stage widths; one
    column equals the single solve."""
    B, T, K = 3, 5, 5
    rng = np.random.default_rng(d)
    D, O, _ = _tridiag_batch(rng, B, T, d)
    Bm = rng.normal(size=(B, T, d, K))
    L, M = riccati.factor(torch.tensor(D), torch.tensor(O))
    X = riccati.solve_multi(L, M, torch.tensor(Bm)).numpy()
    Lr, Mr = jax.vmap(jrc.factor)(jnp.asarray(D), jnp.asarray(O))
    Xr = np.asarray(jax.vmap(jrc.solve_multi)(Lr, Mr, jnp.asarray(Bm)))
    np.testing.assert_allclose(X, Xr, atol=SOLVE_ATOL, rtol=0)
    x2 = riccati.solve(L, M, torch.tensor(Bm[..., 2])).numpy()
    np.testing.assert_allclose(x2, X[..., 2], atol=1e-12, rtol=0)


def test_route_by_stage_width_and_cpu_plain():
    """route() decides by d alone up to 64, at 33; on CPU tensors both routes take
    their plain versions and count no launch."""
    assert [riccati.route(d, dt, 2) for d in (1, 9, 31, 32, 33, 54, 64) for dt in (torch.float32, torch.float64)] == (
        ["lanes"] * 8 + ["stream"] * 6
    )
    D, O, b = (torch.tensor(a) for a in _tridiag_batch(np.random.default_rng(5), 2, 3, 33))
    before = dict(cuda_riccati.LAUNCHES)
    L, M = riccati.factor(D, O)
    x = riccati.solve(L, M, b)
    assert cuda_riccati.LAUNCHES == before
    Lp, Mp = cuda_riccati.factor_lanes_plain(D, O)
    assert torch.equal(L, Lp) and torch.equal(M, Mp)
    np.testing.assert_allclose(x.numpy(), cuda_riccati.solve_lanes_plain(Lp, Mp, b).numpy(), atol=1e-12)


PANEL = 8  # factor_stream's panel width (csrc/riccati_stream.cu kPanel)


def _factor_stream_model(D, O):
    """factor_stream's arithmetic in numpy, lane by lane: per stage the
    stacked panel P = [S_t ; O_t] (2d x d; the last stage has no O), S_t =
    D_t - B B' with B the previous panel's bottom rows (M_{t-1}'); then per
    8-wide panel the diagonal block's Cholesky padded to 8 x 8 with
    identity, the strip rows below it solved against it, and the rank-8
    update of the trailing columns. The top rows end as L_t, the bottom
    ones as M_t'. A failed pivot: NaN over the lower triangle of L_t and of
    every later L, and over every M from M_t on."""
    B, T, d = D.shape[0], D.shape[1], D.shape[-1]
    L, M = np.zeros_like(D), np.zeros_like(O)
    lower = np.tril(np.ones((d, d), bool))
    for b in range(B):
        carry, failed = None, None
        for t in range(T):
            nrow = 2 * d if t < T - 1 else d
            P = np.zeros((nrow, d))
            P[:d] = D[b, t] if carry is None else D[b, t] - carry @ carry.T
            if t < T - 1:
                P[d:] = O[b, t]
            for j0 in range(0, d, PANEL):
                w = min(PANEL, d - j0)
                a = np.eye(PANEL)
                a[:w, :w] = np.tril(P[j0:j0 + w, j0:j0 + w])
                for k in range(PANEL):
                    piv = a[k, k]
                    if not (piv > 0 and np.isfinite(piv)):
                        failed = t
                    a[k, k] = np.sqrt(piv) if piv > 0 else np.nan
                    a[k + 1:, k] /= a[k, k]
                    for i in range(k + 1, PANEL):
                        a[i, k + 1:i + 1] -= a[i, k] * a[k + 1:i + 1, k]
                if failed is not None:
                    break
                v = np.zeros((nrow - j0 - w, PANEL))
                v[:, :w] = P[j0 + w:, j0:j0 + w]
                for k in range(PANEL):
                    v[:, k] /= a[k, k]
                    v[:, k + 1:] -= np.outer(v[:, k], a[k + 1:, k])
                P[j0:j0 + w, j0:j0 + w] = a[:w, :w]
                P[j0 + w:, j0:j0 + w] = v[:, :w]
                jt = j0 + PANEL
                if jt < d:
                    P[jt:, jt:] -= P[jt:, j0:jt] @ P[jt:d, j0:jt].T
            if failed is not None:
                break
            L[b, t] = np.where(lower, P[:d], 0.0)
            if t < T - 1:
                carry = P[d:]
                M[b, t] = carry.T
        if failed is not None:
            L[b, failed:] = np.where(lower, np.nan, 0.0)
            M[b, failed:] = np.nan
    return L, M


def _solve_bwd_stream_model(L, M, u):
    """solve_bwd_stream's arithmetic in numpy, column by column: r = u_t -
    M_t x_{t+1}, then from the bottom x_j = r_j / L_jj (by the reciprocal),
    broadcast, and the rows above take row j of L_t."""
    x = np.zeros_like(u)
    B, T, d, K = u.shape
    for b in range(B):
        for c in range(K):
            nxt = None
            for t in reversed(range(T)):
                r = u[b, t, :, c] - (M[b, t] @ nxt if nxt is not None else 0.0)
                inv = 1.0 / np.diag(L[b, t])
                for j in reversed(range(d)):
                    xj = r[j] * inv[j]
                    r[:j] -= L[b, t, j, :j] * xj
                    r[j] = xj
                x[b, t, :, c] = nxt = r
    return x


MODEL_D = [1, 7, 8, 9, 54, 56, 64]
MODEL_T = [1, 2, 5]


def _model_inputs(d, T, where):
    """Three lanes; lane 0 not positive definite at its first, middle or
    last stage (where = 0, 1, 2)."""
    rng = np.random.default_rng(1000 * d + 10 * T + where)
    D, O, _ = _tridiag_batch(rng, 3, T, d)
    bad = (0, (T - 1) // 2, T - 1)[where]
    D[0, bad] = -np.eye(d)
    return D, O, bad


@pytest.mark.parametrize("where", [0, 1, 2], ids=["first", "middle", "last"])
@pytest.mark.parametrize("T", MODEL_T)
@pytest.mark.parametrize("d", MODEL_D)
def test_factor_stream_model_matches_plain(d, T, where):
    """The blocked stacked-panel factor: one panel (d <= 8), a 1-wide last
    panel (9), ragged ones (7, 54), whole ones (56, 64); lane 0 fails at
    the given stage, with NaN on the same stages as the plain version."""
    D, O, bad = _model_inputs(d, T, where)
    Lm, Mm = _factor_stream_model(D, O)
    Lp, Mp = (a.numpy() for a in cuda_riccati.factor_stream_plain(torch.tensor(D), torch.tensor(O)))
    stage_nan = lambda A: np.isnan(A).any(axis=(-2, -1))
    assert (stage_nan(Lm) == stage_nan(Lp)).all() and (stage_nan(Mm) == stage_nan(Mp)).all()
    assert stage_nan(Lm)[0].tolist() == [t >= bad for t in range(T)]
    assert not stage_nan(Lm)[1:].any()
    ok = ~stage_nan(Lp)
    np.testing.assert_allclose(Lm[ok], Lp[ok], atol=FACTOR_ATOL, rtol=0)
    np.testing.assert_allclose(Mm[ok[:, :-1]], Mp[ok[:, :-1]], atol=FACTOR_ATOL, rtol=0)
    assert (np.triu(Lm, 1) == 0).all()


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("T", MODEL_T)
@pytest.mark.parametrize("d", MODEL_D)
def test_solve_bwd_stream_model_matches_plain(d, T, K):
    """The pivot-broadcast backward sweep from the plain forward sweep's u;
    the lane that is not positive definite (middle stage) comes out NaN
    over all of its x on both."""
    D, O, _ = _model_inputs(d, T, 1)
    b = np.random.default_rng(d + T + K).normal(size=(3, T, d, K))
    Lp, Mp = cuda_riccati.factor_stream_plain(torch.tensor(D), torch.tensor(O))
    u = cuda_riccati.solve_fwd_stream_plain(Lp, Mp, torch.tensor(b))
    xp = cuda_riccati.solve_bwd_stream_plain(Lp, Mp, u).numpy()
    xm = _solve_bwd_stream_model(Lp.numpy(), Mp.numpy(), u.numpy())
    assert np.isnan(xm[0]).all() and np.isnan(xp[0]).all()
    np.testing.assert_allclose(xm[1:], xp[1:], atol=SOLVE_ATOL, rtol=0)


def _solve_fwd_stream_model(L, M, b):
    """solve_fwd_stream's arithmetic in numpy, column by column: r = b_t -
    M_{t-1}' u_{t-1} (one running sum), then from the top u_j = r_j / L_jj
    (by the reciprocal), broadcast, and the rows below take column j of
    L_t."""
    u = np.zeros_like(b)
    B, T, d, K = b.shape
    for lane in range(B):
        for c in range(K):
            prev = None
            for t in range(T):
                r = b[lane, t, :, c].copy()
                if prev is not None:
                    acc = np.zeros(d)
                    for k in range(d):
                        acc += M[lane, t - 1, k, :] * prev[k]
                    r -= acc
                inv = 1.0 / np.diag(L[lane, t])
                for j in range(d):
                    uj = r[j] * inv[j]
                    r[j + 1:] -= L[lane, t, j + 1:, j] * uj
                    r[j] = uj
                u[lane, t, :, c] = prev = r
    return u


def _dot4(A, v):
    """A @ v in solve_lanes' order: four partial sums over the columns k =
    0, 4, 8, ...; 1, 5, ...; 2, ...; 3, ..., each in increasing k, added
    pairwise."""
    s = [np.zeros(A.shape[0]) for _ in range(4)]
    for k in range(A.shape[1]):
        s[k % 4] = s[k % 4] + A[:, k] * v[k]
    return (s[0] + s[1]) + (s[2] + s[3])


def _solve_lanes_model(L, M, b):
    """solve_lanes' arithmetic in numpy, lane by lane: the forward sweep
    (r = b_t - M_{t-1}' u_{t-1} by _dot4, u_j = r_j / L_jj by the
    reciprocal, the rows below take column j of L_t), then the backward one
    (r = u_t - M_t x_{t+1} by _dot4, x_j from the bottom, the rows above
    take row j of L_t)."""
    B, T, d = b.shape
    x = np.zeros_like(b)
    for lane in range(B):
        u = np.zeros((T, d))
        for t in range(T):
            r = b[lane, t].copy()
            if t > 0:
                r -= _dot4(M[lane, t - 1].T, u[t - 1])
            inv = 1.0 / np.diag(L[lane, t])
            for j in range(d):
                uj = r[j] * inv[j]
                r[j + 1:] -= L[lane, t, j + 1:, j] * uj
                r[j] = uj
            u[t] = r
        nxt = None
        for t in reversed(range(T)):
            r = u[t].copy()
            if nxt is not None:
                r -= _dot4(M[lane, t], nxt)
            inv = 1.0 / np.diag(L[lane, t])
            for j in reversed(range(d)):
                xj = r[j] * inv[j]
                r[:j] -= L[lane, t, j, :j] * xj
                r[j] = xj
            x[lane, t] = nxt = r
    return x


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("T", MODEL_T)
@pytest.mark.parametrize("d", MODEL_D)
def test_solve_fwd_stream_model_matches_plain(d, T, K):
    """The warp-per-column forward sweep with reciprocal pivots, on the
    plain factor; the lane that is not positive definite (middle stage)
    comes out NaN from that stage on, on both."""
    D, O, bad = _model_inputs(d, T, 1)
    b = np.random.default_rng(d + T + K + 7).normal(size=(3, T, d, K))
    Lp, Mp = cuda_riccati.factor_stream_plain(torch.tensor(D), torch.tensor(O))
    up = cuda_riccati.solve_fwd_stream_plain(Lp, Mp, torch.tensor(b)).numpy()
    um = _solve_fwd_stream_model(Lp.numpy(), Mp.numpy(), b)
    stage_nan = lambda u: np.isnan(u).any(axis=(-2, -1))
    assert (stage_nan(um) == stage_nan(up)).all()
    assert stage_nan(um)[0].tolist() == [t >= bad for t in range(T)] and not stage_nan(um)[1:].any()
    np.testing.assert_allclose(um[~stage_nan(up)], up[~stage_nan(up)], atol=SOLVE_ATOL, rtol=0)


@pytest.mark.parametrize("T", [1, 2, 31])
@pytest.mark.parametrize("d", [1, 5, 8, 9, 16, 17, 32, 33])
def test_solve_lanes_model_matches_plain(d, T):
    """solve_lanes' two sweeps with reciprocal pivots and the partial-sum
    coupling: d below, at and above the four-way split and the warp (one
    row a thread up to 32, two from 33), the rocket's T=31; the lane that
    is not positive definite (middle stage) is NaN over all of its x on
    both."""
    D, O, _ = _model_inputs(d, T, 1)
    b = np.random.default_rng(d + T + 11).normal(size=(3, T, d))
    Lp, Mp = cuda_riccati.factor_lanes_plain(torch.tensor(D), torch.tensor(O))
    xp = cuda_riccati.solve_lanes_plain(Lp, Mp, torch.tensor(b)).numpy()
    xm = _solve_lanes_model(Lp.numpy(), Mp.numpy(), b)
    assert np.isnan(xm[0]).all() and np.isnan(xp[0]).all()
    assert np.isfinite(xm[1:]).all()
    np.testing.assert_allclose(xm[1:], xp[1:], atol=SOLVE_ATOL, rtol=0)
