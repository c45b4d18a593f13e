"""The port's routes past the kernels' widths against the JAX package on
the CPU in float64: the T=1 library route past n = 192 (`chol_library`,
`chol_solve_library`) against `jnp.linalg.cholesky` and the reference's
`chol_solve_cv`, the block-tridiagonal scan past d = 120 (`factor_scan`,
`solve_scan`) against the reference's `factor`, `solve` and
`solve_multi`, the functions that name the routes at their per-dtype
limits, a check that they give a kernel route wherever the reference's
`_use_pallas` gives a float32 Pallas route, the public `solve_batched`
past the fused kernel's d = 64, and a schur solve past the narrow panel
kernels' 128 variables (the pendulum swing-up at horizon 44, n = 131) in
both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import calipso_tpu
from calipso_tpu.ops import riccati as jrc
from calipso_tpu_torch.ops import cuda_riccati, riccati
from calipso_tpu_torch.utils.convert import options_from_jax
from tests.torch_parity import nan_lanes, spd_batch

RTOL = 1e-12  # relative to the largest entry: the same float64 LAPACK calls, summed in another order
SOL_ATOL = 1e-6  # tests/test_torch_slice.py: solutions of one solve in both packages


def _rel_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize(
    "n,dtype,want",
    [(1, F64, "kernel"), (32, F64, "kernel"), (128, F64, "kernel"), (129, F64, "kernel"), (192, F64, "kernel"),
     (193, F64, "library"), (286, F64, "library"), (221, F32, "kernel"), (288, F32, "kernel"), (289, F32, "library"),
     (8, torch.float16, "library")],
)
def test_t1_route_at_its_limit(n, dtype, want):
    assert riccati.t1_route(n, dtype) == want


@pytest.mark.parametrize(
    "d,dtype,want",
    [(9, F64, "lanes"), (32, F64, "lanes"), (33, F64, "stream"), (54, F64, "stream"), (64, F64, "stream"),
     (65, F64, "stream"), (120, F64, "stream"), (121, F64, "scan"), (165, F32, "stream"), (169, F32, "stream"),
     (170, F32, "scan"), (9, torch.float16, "scan")],
)
def test_block_route_at_its_limits(d, dtype, want):
    assert riccati.route(d, dtype, 2) == want


@pytest.mark.parametrize(
    "d,dtype,want",
    [(54, F32, "stream"), (169, F32, "stream"), (170, F32, "t1"), (288, F32, "t1"), (289, F32, "scan"),
     (121, F64, "t1"), (192, F64, "t1"), (193, F64, "scan")],
)
def test_one_stage_route_at_its_limits(d, dtype, want):
    """A one-stage horizon past MAX_D is one dense system: the T=1 kernels
    up to MAX_N, the scan past it."""
    assert riccati.route(d, dtype, 1) == want


def test_one_stage_past_max_d_matches_jax():
    """(3, 1, 121) in float64, one past the stream kernels: factor, solve
    and solve_multi (K=2) on the T=1 route (here the T=1 kernels' plain
    versions) against the reference's `factor`, `solve` and `solve_multi`;
    lane 1 is not positive definite, NaN over its lower triangle and its
    x."""
    B, T, d = 3, 1, cuda_riccati.MAX_D[torch.float64] + 1
    assert riccati.route(d, torch.float64, T) == "t1"
    rng = np.random.default_rng(d)
    D, O = _tridiag(rng, B, T, d, bad=((1, 0),))
    b, bk = rng.normal(size=(B, T, d)), rng.normal(size=(B, T, d, 2))
    Lt, Mt = riccati.factor(torch.tensor(D), torch.tensor(O))
    assert Mt.shape == (B, 0, d, d)
    xt = riccati.solve(Lt, Mt, torch.tensor(b)).numpy()
    Xt = riccati.solve_multi(Lt, Mt, torch.tensor(bk)).numpy()
    Lt = Lt.numpy()
    low = np.tril(np.ones((d, d), bool))
    assert np.isnan(Lt[1, 0][low]).all() and (Lt[1, 0][~low] == 0).all()
    assert np.isnan(xt[1]).all() and np.isnan(Xt[1]).all()
    ok = [0, 2]
    Lr, Mr = (np.asarray(a) for a in jax.vmap(jrc.factor)(jnp.asarray(D[ok]), jnp.asarray(O[ok])))
    _rel_close(Lt[ok], Lr)
    _rel_close(xt[ok], jax.vmap(jrc.solve)(jnp.asarray(Lr), jnp.asarray(Mr), jnp.asarray(b[ok])))
    _rel_close(Xt[ok], jax.vmap(jrc.solve_multi)(jnp.asarray(Lr), jnp.asarray(Mr), jnp.asarray(bk[ok])))


def test_routes_cover_the_reference_pallas_region():
    """Wherever the reference's `_use_pallas(B, T, d, float32, on_tpu=True)`
    gives a route (for T = 1, a resident one, the only one its T=1 dense
    path takes), the port's float32 route is a kernel route: the T=1
    kernels for T = 1 (n up to 221 at B = 32), the lanes or stream kernels
    for T > 1 (d up to 165 at B = 32), and for the riccati backend's
    one-stage horizons (the reference's `factor_cv` at T = 1, resident to
    d = 221) the lanes, stream or T=1 kernels. Only the routing functions
    run."""
    f32 = np.dtype(np.float32)
    seen = {"t1": 0, "block": 0}
    for B in (32, 33, 48, 64, 94, 96, 127, 128, 256, 1024, 8192):
        for T in (1, 2, 8, 31):
            for d in range(1, 401):
                got = jrc._use_pallas(B, T, d, f32, on_tpu=True)
                if T == 1 and got and got[0] == "resident":
                    assert riccati.t1_route(d, F32) == "kernel", (B, T, d, got)
                    assert riccati.route(d, F32, T) in ("lanes", "stream", "t1"), (B, T, d, got)
                    seen["t1"] = max(seen["t1"], d)
                elif T > 1 and got:
                    assert riccati.route(d, F32, T) in ("lanes", "stream"), (B, T, d, got)
                    seen["block"] = max(seen["block"], d)
    assert seen == {"t1": 221, "block": 165}


def test_t1_library_route_matches_jax():
    """(3, 193), one past the float64 kernels: lane 1 is not positive
    definite, NaN over its lower triangle and zeros above;
    jnp.linalg.cholesky gives it no finite factor either. The other lanes'
    factor and solve match the reference's XLA branch (`chol_cv`,
    `chol_solve_cv` under vmap, which take it at this size)."""
    B, n = 3, cuda_riccati.MAX_N[torch.float64] + 1
    assert riccati.t1_route(n, torch.float64) == "library"
    rng = np.random.default_rng(129)
    S = spd_batch(rng, B, n, non_pd=(1,))
    b = rng.normal(size=(B, n))
    before = dict(cuda_riccati.LAUNCHES)
    L = riccati.chol(torch.tensor(S))
    x = riccati.chol_solve(L, torch.tensor(b))
    assert cuda_riccati.LAUNCHES == before  # a CPU tensor counts nothing
    torch.testing.assert_close(L, riccati.chol_library(torch.tensor(S)), rtol=0, atol=0, equal_nan=True)
    L = L.numpy()
    Lj = np.asarray(jax.vmap(jrc.chol_cv)(jnp.asarray(S)))
    assert nan_lanes(L).tolist() == [False, True, False]
    assert (~np.isfinite(Lj).all(axis=(1, 2))).tolist() == [False, True, False]
    low = np.tril(np.ones((n, n), bool))
    assert np.isnan(L[1][low]).all() and (L[1][~low] == 0).all()
    ok = [0, 2]
    _rel_close(L[ok], Lj[ok])
    _rel_close(L[ok], np.asarray(jnp.linalg.cholesky(jnp.asarray(S[ok]))))
    xj = np.asarray(jax.vmap(jrc.chol_solve_cv)(jnp.asarray(Lj[ok]), jnp.asarray(b[ok])))
    _rel_close(x.numpy()[ok], xj)
    assert np.isnan(x.numpy()[1]).all()


def _tridiag(rng, B, T, d, bad=()):
    """Block-tridiagonal SPD batches (strongly diagonal D, couplings 0.3
    N(0, 1)); the (lane, stage) blocks in `bad` negated."""
    A = rng.normal(size=(B, T, d, d))
    D = A @ np.swapaxes(A, -1, -2) + d * np.eye(d)
    O = 0.3 * rng.normal(size=(B, T - 1, d, d))
    for lane, stage in bad:
        D[lane, stage] *= -1.0
    return D, O


def test_scan_route_matches_jax():
    """(3, 5, 121), one past the float64 stream kernels: lane 2's stage 3
    is not positive definite, so its L is NaN over the lower triangle from
    stage 3 on and its M from M_3 on (the reference's scan: not finite
    from the same stage on). The other lanes' factor, solve and
    solve_multi (K=3) match the reference's."""
    B, T, d, BAD, T_BAD = 3, 5, cuda_riccati.MAX_D[torch.float64] + 1, 2, 3
    assert riccati.route(d, torch.float64, T) == "scan"
    rng = np.random.default_rng(65)
    D, O = _tridiag(rng, B, T, d, bad=((BAD, T_BAD),))
    b, bk = rng.normal(size=(B, T, d)), rng.normal(size=(B, T, d, 3))
    before = dict(cuda_riccati.LAUNCHES)
    Lt, Mt = riccati.factor(torch.tensor(D), torch.tensor(O))
    xt = riccati.solve(Lt, Mt, torch.tensor(b)).numpy()
    Xt = riccati.solve_multi(Lt, Mt, torch.tensor(bk)).numpy()
    assert cuda_riccati.LAUNCHES == before
    Lt, Mt = Lt.numpy(), Mt.numpy()
    Lr, Mr = (np.asarray(a) for a in jax.vmap(jrc.factor)(jnp.asarray(D), jnp.asarray(O)))
    low = np.tril(np.ones((d, d), bool))
    assert np.isnan(Lt[BAD, T_BAD:][:, low]).all() and (Lt[BAD, T_BAD:][:, ~low] == 0).all()
    assert np.isnan(Mt[BAD, T_BAD:]).all() and np.isfinite(Mt[BAD, :T_BAD]).all()
    stage_bad = ~np.isfinite(Lt).all(axis=(-2, -1))
    assert (stage_bad == ~np.isfinite(Lr).all(axis=(-2, -1))).all()
    assert stage_bad.any(axis=1).tolist() == [i == BAD for i in range(B)]
    ok = [0, 1]
    _rel_close(Lt[ok], Lr[ok])
    _rel_close(Mt[ok], Mr[ok])
    _rel_close(Lt[BAD, :T_BAD], Lr[BAD, :T_BAD])
    xr = jax.vmap(jrc.solve)(*(jnp.asarray(a[ok]) for a in (Lr, Mr, b)))
    Xr = jax.vmap(jrc.solve_multi)(*(jnp.asarray(a[ok]) for a in (Lr, Mr, bk)))
    _rel_close(xt[ok], xr)
    _rel_close(Xt[ok], Xr)
    assert np.isnan(xt[BAD]).all() and np.isnan(Xt[BAD]).all()


@pytest.mark.parametrize("n", [7, 129])
def test_scan_route_at_one_stage_is_the_t1_route(n):
    """With T=1 the scan is one Cholesky factor and one solve: the same
    numbers as the T=1 library route."""
    rng = np.random.default_rng(n)
    S = torch.tensor(spd_batch(rng, 2, n))[:, None]
    b = torch.tensor(rng.normal(size=(2, 1, n)))
    L, M = riccati.factor_scan(S, S.new_zeros(2, 0, n, n))
    assert M.shape == (2, 0, n, n)
    assert torch.equal(L[:, 0], riccati.chol_library(S[:, 0]))
    assert torch.equal(riccati.solve_scan(L, M, b)[:, 0], riccati.chol_solve_library(L[:, 0], b[:, 0]))


@pytest.mark.parametrize("d", [65, 165])
def test_solve_batched_past_the_fused_width_matches_jax(d):
    """The public `solve_batched` past the fused kernel's d = 64 (on the
    card the stream kernels, then the scan): on CPU tensors its plain
    version, against the reference's `solve_batched(..., use_pallas=False)`
    (its scan factor and solve under vmap) at (3, 3, d) in float64; lane
    1, not positive definite from stage 1 on, is NaN over all of its x
    on both."""
    from calipso_tpu.ops import pallas_riccati as jpr

    B, T = 3, 3
    rng = np.random.default_rng(d)
    D, O = _tridiag(rng, B, T, d, bad=((1, 1),))
    b = rng.normal(size=(B, T, d))
    x = cuda_riccati.solve_batched(*(torch.tensor(a) for a in (D, O, b))).numpy()
    xr = np.asarray(jpr.solve_batched(*(jnp.asarray(a) for a in (D, O, b)), use_pallas=False))
    assert np.isnan(x[1]).all() and not np.isfinite(xr[1]).all()
    ok = [0, 2]
    _rel_close(x[ok], xr[ok])


def test_schur_solve_past_the_kernel_width_matches_jax():
    """The pendulum swing-up at horizon 44 (n = 2·44 + 43 = 131 variables,
    past the narrow panel kernels' 128) on schur with the serial line
    search, in float64 from the problem's state guess and zero actions:
    the port's T=1 factor and solve take the kernel route (on the card,
    the wide panel kernels; here their plain versions), and the solve
    takes the reference's steps (the same solved flag and iterations, the
    solution within the goldens' atol)."""
    from calipso_tpu import TrajOptSolver as JaxTrajOpt
    from calipso_tpu.models import pendulum as jpendulum
    from calipso_tpu_torch import TrajOptSolver
    from calipso_tpu_torch.models import pendulum

    horizon = 44
    jopts = calipso_tpu.Options(linear_solver="schur", line_search_mode="serial")
    out = []
    for build, m, extra in (
        (JaxTrajOpt, jpendulum, {}),
        (TrajOptSolver, pendulum, {"device": "cpu"}),
    ):
        prob = m.swingup_problem(horizon)
        opts = jopts if build is JaxTrajOpt else options_from_jax(jopts)
        ts = build(
            prob["objective"], prob["dynamics"], prob["num_states"], prob["num_actions"],
            equality=prob["equality"], options=opts, **extra,
        )
        assert ts.num_variables == 131
        assert riccati.t1_route(ts.num_variables, torch.float64) == "kernel"
        ts.initialize_states(prob["state_guess"])
        out.append(ts.solve())
    rj, rt = out
    assert bool(rt.solved) == bool(rj.solved) is True
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(rt.variables.numpy(), np.asarray(rj.variables), atol=SOL_ATOL, rtol=0)
