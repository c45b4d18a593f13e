"""The port's stream route of the riccati backend against the JAX package
on the CPU in float64: the plain versions of the CUDA kernels
`factor_stream`, `solve_fwd_stream` and `solve_bwd_stream` against the
interpret-mode Pallas stream kernels they replace and the reference scan,
the first stage that is not positive definite, and `solve_multi` with
several right-hand sides per lane against `calipso_tpu.ops.riccati`."""

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
    """route() decides by d alone, at 33; on CPU tensors both routes take
    their plain versions and count no launch."""
    assert [riccati.route(d) for d in (1, 9, 32, 33, 54, 64)] == ["lanes"] * 3 + ["stream"] * 3
    D, O, b = (torch.tensor(a) for a in _tridiag_batch(np.random.default_rng(5), 2, 3, 33))
    before = dict(cuda_riccati.LAUNCHES)
    L, M = riccati.factor(D, O)
    x = riccati.solve(L, M, b)
    assert cuda_riccati.LAUNCHES == before
    Lp, Mp = cuda_riccati.factor_lanes_plain(D, O)
    assert torch.equal(L, Lp) and torch.equal(M, Mp)
    np.testing.assert_allclose(x.numpy(), cuda_riccati.solve_lanes_plain(Lp, Mp, b).numpy(), atol=1e-12)
