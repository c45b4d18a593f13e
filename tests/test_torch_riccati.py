"""The port's riccati backend against the JAX package on the CPU in
float64: the block-tridiagonal factor and solve (plain versions of the
CUDA kernels `factor_lanes`/`solve_lanes`) against the interpret-mode
Pallas kernels they replace and the reference scan, the inertia signal
of a stage that is not positive definite, and the structured KKT layer
(stage-block Hessian, `_riccati_blocks`, the riccati step and inertia
reads) at a random primal-dual point of the rocket landing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import calipso_tpu
import calipso_tpu_torch
from calipso_tpu.ops import pallas_riccati as pr
from calipso_tpu.ops import riccati as jrc
from calipso_tpu.solver import kkt as jkkt
from calipso_tpu_torch.ops import cuda_riccati, riccati
from calipso_tpu_torch.solver import kkt as tkkt
from calipso_tpu_torch.utils.convert import options_from_jax
from tests.test_riccati import make_block_tridiag

FACTOR_ATOL, SOLVE_ATOL = 1e-8, 1e-7  # those of tests/test_pallas_riccati.py
KKT_ATOL = 1e-12  # the same float64 arithmetic up to summation order
STEP_ATOL = 1e-8  # two factorizations of one system


def _tridiag_batch(rng, B, T, d):
    D = np.zeros((B, T, d, d))
    O = np.zeros((B, T - 1, d, d))
    for i in range(B):
        D[i], O[i], _ = make_block_tridiag(T, d, rng)
    return D, O, rng.normal(size=(B, T, d))


@pytest.mark.parametrize(
    "B,T,d,tile", [(4, 5, 6, None), (4, 1, 5, None), (6, 3, 4, 3), (3, 2, 16, None), (4, 31, 9, None)]
)
def test_lanes_plain_match_pallas_interpret_and_scan(B, T, d, tile):
    """The shapes of tests/test_pallas_riccati.py plus the batched
    rocket's stage blocks (T=31, d=9)."""
    D, O, b = _tridiag_batch(np.random.default_rng(T * 100 + d), B, T, d)
    Lt, Mt = cuda_riccati.factor_lanes_plain(torch.tensor(D), torch.tensor(O))
    xt = cuda_riccati.solve_lanes_plain(Lt, Mt, torch.tensor(b)).numpy()
    Lt, Mt = Lt.numpy(), Mt.numpy()
    jD, jO, jb = jnp.asarray(D), jnp.asarray(O), jnp.asarray(b)
    Lp, Mp = pr.factor_lanes(jD, jO, interpret=True, batch_tile=tile)
    Lr, Mr = jax.vmap(jrc.factor)(jD, jO)
    for L, M in ((Lp, Mp), (Lr, Mr)):
        np.testing.assert_allclose(Lt, np.asarray(L), atol=FACTOR_ATOL, rtol=0)
        np.testing.assert_allclose(Mt, np.asarray(M), atol=FACTOR_ATOL, rtol=0)
    xp = pr.solve_lanes(Lp, Mp, jb, interpret=True, batch_tile=tile)
    xr = jax.vmap(jrc.solve)(Lr, Mr, jb)
    for x in (xp, xr):
        np.testing.assert_allclose(xt, np.asarray(x), atol=SOLVE_ATOL, rtol=0)


def test_non_pd_stage_gives_nan_from_that_stage_on():
    """Lane 1's stage 3 block is indefinite: the lower triangle of L_3
    and of every later L, and every M from M_3 on, are NaN; earlier
    stages and the other lanes are exact. The reference scan (by
    propagation) and the Pallas kernel are not finite from the same
    stage on."""
    B, T, d, BAD, T_BAD = 3, 7, 4, 1, 3
    D, O, b = _tridiag_batch(np.random.default_rng(9), B, T, d)
    D[BAD, T_BAD] = -np.eye(d)
    Lt, Mt = (a.numpy() for a in cuda_riccati.factor_lanes_plain(torch.tensor(D), torch.tensor(O)))
    Lr, Mr = (np.asarray(a) for a in jax.vmap(jrc.factor)(jnp.asarray(D), jnp.asarray(O)))
    Lp, _ = pr.factor_lanes(jnp.asarray(D), jnp.asarray(O), interpret=True)
    low = np.tril(np.ones((d, d), bool))
    assert np.isnan(Lt[BAD, T_BAD:][:, low]).all() and (Lt[BAD, T_BAD:][:, ~low] == 0).all()
    assert np.isnan(Mt[BAD, T_BAD:]).all()
    assert np.isnan(Lt).any(axis=(1, 2, 3)).tolist() == [i == BAD for i in range(B)]
    stage_bad = ~np.isfinite(Lt).all(axis=(-2, -1))
    for L in (Lr, np.asarray(Lp)):
        assert (~np.isfinite(L).all(axis=(-2, -1)) == stage_bad).all()
    assert stage_bad[BAD].tolist() == [t >= T_BAD for t in range(T)]
    ok = np.ones((B, T), bool)
    ok[BAD, T_BAD:] = False
    np.testing.assert_allclose(Lt[ok], Lr[ok], atol=FACTOR_ATOL, rtol=0)
    np.testing.assert_allclose(Mt[ok[:, :-1]], Mr[ok[:, :-1]], atol=FACTOR_ATOL, rtol=0)
    x = cuda_riccati.solve_lanes_plain(*(torch.tensor(a) for a in (Lt, Mt, b))).numpy()
    assert np.isnan(x[BAD]).all() and np.isfinite(np.delete(x, BAD, axis=0)).all()


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor takes the plain version and never counts a launch."""
    D, O, b = (torch.tensor(a) for a in _tridiag_batch(np.random.default_rng(3), 2, 4, 3))
    before = dict(cuda_riccati.LAUNCHES)
    L, M = riccati.factor(D, O)
    x = riccati.solve(L, M, b)
    assert cuda_riccati.LAUNCHES == before
    Lp, Mp = cuda_riccati.factor_lanes_plain(D, O)
    assert torch.equal(L, Lp) and torch.equal(M, Mp)
    assert torch.equal(x, cuda_riccati.solve_lanes_plain(Lp, Mp, b))


# ---- the structured KKT layer at a random point of the rocket landing ------

T_ROCKET, B = 5, 3
INDEFINITE = 1  # a lane whose Hessian blocks are made strongly indefinite


def _rocket_pair():
    from calipso_tpu.models import rocket as jrocket
    from calipso_tpu_torch.models import rocket as trocket

    out = []
    for m, pkg, extra in ((jrocket, calipso_tpu, {}), (trocket, calipso_tpu_torch, dict(device="cpu"))):
        prob = m.landing_problem(horizon=T_ROCKET)
        kw = {k: v for k, v in prob.items() if k not in ("state_guess", "state_initial", "state_goal")}
        opts = calipso_tpu.Options()
        if pkg is calipso_tpu_torch:
            opts = options_from_jax(opts)
        out.append(pkg.TrajOptSolver(options=opts, **extra, **kw).solver)
    return out


@pytest.fixture(scope="module")
def point():
    js, ts = _rocket_pair()
    dims = ts.dims
    n, me, mc = dims.variables, dims.equality, dims.cone
    rng = np.random.default_rng(21)
    s = rng.uniform(0.5, 1.5, size=(B, mc))
    t = rng.uniform(0.5, 1.5, size=(B, mc))
    for v in (s, t):  # every cone is a 3-dimensional SOC: head above the tail norm
        v3 = v.reshape(B, -1, 3)
        v3[..., 1:] = 0.3 * rng.normal(size=v3[..., 1:].shape)
        v3[..., 0] = np.linalg.norm(v3[..., 1:], axis=-1) + 0.5
    return dict(
        js=js, ts=ts, n=n, me=me, mc=mc,
        x=rng.normal(size=(B, n)), th=np.zeros((B, 0)),
        y=rng.normal(size=(B, me)), z=rng.normal(size=(B, mc)), s=s, t=t,
        rho=rng.uniform(0.5, 10.0, size=B), eps_p=rng.uniform(1e-9, 1e-6, size=B),
        eps_d=rng.uniform(1e-9, 1e-6, size=B),
    )


def _t(a):
    return torch.tensor(np.asarray(a))


def _jax_blocks(p):
    fns = p["js"].fns
    return jax.vmap(lambda x, th, y, z: fns.lagrangian_hessian_blocks(x, th, y, z, True))(
        p["x"], p["th"], p["y"], p["z"]
    )


def _torch_blocks(p):
    return p["ts"].fns.lagrangian_hessian_blocks(*(_t(p[k]) for k in ("x", "th", "y", "z")))


def test_hessian_blocks_match_jax_and_the_dense_hessian(point):
    p = point
    Dj, Oj, Hgj = _jax_blocks(p)
    Dt, Ot, Hgt = _torch_blocks(p)
    assert Hgj is None and Hgt is None
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), atol=KKT_ATOL, rtol=0)
    np.testing.assert_allclose(Ot.numpy(), np.asarray(Oj), atol=KKT_ATOL, rtol=0)
    st = p["ts"].fns.stage_structure
    H = p["ts"].fns.lagrangian_hessian_xx(*(_t(p[k]) for k in ("x", "th", "y", "z")))
    np.testing.assert_allclose(st.densify(Dt, Ot).numpy(), H.numpy(), atol=KKT_ATOL, rtol=0)


def _kkt_args(p, fns, to):
    x, th = to(p["x"]), to(p["th"])
    if to is _t:
        gx, hx = fns.gx(x, th), fns.hx(x, th)
    else:
        gx, hx = jax.vmap(fns.gx)(x, th), jax.vmap(fns.hx)(x, th)
    return gx, hx, to(p["s"]), to(p["t"]), to(p["rho"]), to(p["eps_p"]), to(p["eps_d"])


@pytest.mark.parametrize("hessian", ["band", "dense"])
def test_riccati_blocks_match_jax(point, hessian):
    """The stage-block Schur complement from a BandHessian (the solve's
    path) and from a dense Hessian gathered into blocks."""
    p = point
    jst, tst = p["js"].fns.stage_structure, p["ts"].fns.stage_structure
    jl, tl = p["js"].layout, p["ts"].layout
    Dj, Oj, _ = _jax_blocks(p)
    Dt, Ot, _ = _torch_blocks(p)
    if hessian == "band":
        Hj = jax.vmap(lambda D, O: jkkt.BandHessian(D, O, None, jst))(Dj, Oj)
        Ht = tkkt.BandHessian(Dt, Ot, None, tst)
    else:
        Hj = jax.vmap(jst.densify)(Dj, Oj)
        Ht = tst.densify(Dt, Ot)
    want = jax.vmap(lambda H, *a: jkkt._riccati_blocks(jl, jst, H, *a))(Hj, *_kkt_args(p, p["js"].fns, jnp.asarray))
    got = tkkt._riccati_blocks(tl, tst, Ht, *_kkt_args(p, p["ts"].fns, _t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=KKT_ATOL, rtol=0)


def _residual(p, rng):
    from calipso_tpu_torch.solver.kkt import Blocks

    sizes = (p["n"], p["me"], p["mc"], p["me"], p["mc"], p["mc"])
    return Blocks(*(_t(rng.normal(size=(B, k))) for k in sizes))


def test_riccati_step_matches_schur_and_inertia_matches_jax(point):
    """On one batched iterate (lane 1 made indefinite), the riccati step
    equals the schur step where the factor is finite, and the per-lane
    inertia reads equal the reference's riccati ones."""
    p = point
    ts, js = p["ts"], p["js"]
    tst, jst = ts.fns.stage_structure, js.fns.stage_structure
    n, me, mc = p["n"], p["me"], p["mc"]
    Dt, Ot, _ = _torch_blocks(p)
    Dt[INDEFINITE] -= 1e3 * torch.eye(Dt.shape[-1], dtype=Dt.dtype)
    Ht = tkkt.BandHessian(Dt, Ot, None, tst)
    args_t = _kkt_args(p, ts.fns, _t)
    fr = tkkt.factorize(ts.layout, Ht, *args_t, method="riccati", structure=tst)
    fs = tkkt.factorize(ts.layout, Ht, *args_t, method="schur")
    ok = tkkt.inertia_ok(fr)
    assert ok.tolist() == tkkt.inertia_ok(fs).tolist() == [i != INDEFINITE for i in range(B)]
    res = _residual(p, np.random.default_rng(5))
    step_r = tkkt.solve_with(ts.layout, fr, res, n, me, mc, "riccati", tst)
    step_s = tkkt.solve_with(ts.layout, fs, res, n, me, mc)
    for a, b in zip(step_r, step_s):
        np.testing.assert_allclose(a[ok].numpy(), b[ok].numpy(), atol=STEP_ATOL, rtol=0)

    Hj = jax.vmap(lambda D, O: jkkt.BandHessian(D, O, None, jst))(jnp.asarray(Dt.numpy()), jnp.asarray(Ot.numpy()))
    fj = jax.vmap(
        lambda H, *a: jkkt.factorize(js.layout, H, *a, method="riccati", structure=jst)
    )(Hj, *_kkt_args(p, js.fns, jnp.asarray))
    ok_j = jax.vmap(lambda f: jkkt.inertia_ok(f, n, me, mc, "riccati", jst))(fj)
    assert ok.tolist() == np.asarray(ok_j).tolist()
    z_j = jax.vmap(lambda f: jkkt.num_zero_eigs(f, "riccati", jst))(fj)
    assert tkkt.num_zero_eigs(fr, "riccati", tst).tolist() == np.asarray(z_j).tolist()


def test_num_zero_eigs_excludes_padded_pivots(point):
    """Stage blocks of the rocket's ragged layout (the last stage has 6
    of 9 slots real): lane 0 is well scaled, lane 1 has one collapsed
    pivot in a decoupled stage, lane 2 is scaled by 1e-26 so that its
    real pivots (~1e-13) would all count as tiny beside the padded unit
    pivots, were those not excluded. Port and reference count alike."""
    p = point
    tst, jst = p["ts"].fns.stage_structure, p["js"].fns.stage_structure
    T, dmax = tst.horizon, tst.dmax
    rng = np.random.default_rng(13)
    D, O, _ = _tridiag_batch(rng, B, T, dmax)
    pad = tst.blk_idx == tst.num_variables  # (T, dmax)
    for i in range(B):
        for t in range(T):
            D[i, t][pad[t], :] = D[i, t][:, pad[t]] = 0.0
            D[i, t][pad[t], pad[t]] = 1.0
        for t in range(T - 1):
            O[i, t][pad[t + 1], :] = O[i, t][:, pad[t]] = 0.0
    D[1, 2] = np.diag([1e-30] + [1.0] * (dmax - 1))
    O[1, 1] = O[1, 2] = 0.0
    real = ~pad[:, :, None] & ~pad[:, None, :]
    D[2] = np.where(real, 1e-26 * D[2], D[2])
    O[2] *= 1e-26
    L, M = cuda_riccati.factor_lanes_plain(torch.tensor(D), torch.tensor(O))
    fact = tkkt.Factorization(L, M, *([None] * 7))
    got = tkkt.num_zero_eigs(fact, "riccati", tst).tolist()
    Lj, Mj = jax.vmap(jrc.factor)(jnp.asarray(D), jnp.asarray(O))
    want = [
        int(jkkt.num_zero_eigs(jkkt.Factorization(Lj[i], None, Mj[i], *([None] * 7)), "riccati", jst))
        for i in range(B)
    ]
    assert got == want and got[0] == 0 and got[1] == 1 and got[2] == 0
    assert tkkt._tiny_pivots(torch.diagonal(L[2:], dim1=-2, dim2=-1).flatten(1)).item() > 0
