"""The port's schur KKT layer against the JAX package on the CPU in
float64, on one batched iterate handed to both packages through
`calipso_tpu_torch.utils.convert`: residual, condensed RHS, schur
factorization, condensed solve and expansion, the 6-block matvec, and the
per-lane inertia reads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calipso_tpu.ops import cones as jcones
from calipso_tpu.solver import kkt as jkkt
from calipso_tpu_torch.ops import cones as tcones
from calipso_tpu_torch.solver import kkt as tkkt
from calipso_tpu_torch.utils.convert import blocks_from_numpy
from tests.torch_parity import nan_lanes

ATOL = 1e-10
B, N, ME, MC = 5, 8, 3, 7
NN, SOCS = [0, 1, 6], [[2, 3, 4, 5]]
BAD = 2  # a lane whose Hessian is strongly indefinite


@pytest.fixture(scope="module")
def iterate():
    rng = np.random.default_rng(11)
    A = rng.normal(size=(B, N, N))
    H = A @ np.swapaxes(A, 1, 2) + 0.1 * np.eye(N)
    H[BAD] = -H[BAD] - 50.0 * np.eye(N)
    s = rng.uniform(0.5, 1.5, size=(B, MC))
    t = rng.uniform(0.5, 1.5, size=(B, MC))
    for idx in SOCS:
        for v in (s, t):
            v[:, idx[1:]] = 0.2 * rng.normal(size=(B, len(idx) - 1))
            v[:, idx[0]] = np.linalg.norm(v[:, idx[1:]], axis=1) + 0.5
    point = jkkt.Blocks(
        rng.normal(size=(B, N)), rng.normal(size=(B, ME)), s,
        rng.normal(size=(B, ME)), rng.normal(size=(B, MC)), t,
    )
    res = jkkt.Blocks(*(rng.normal(size=a.shape) for a in point))
    return dict(
        H=H, gx=rng.normal(size=(B, ME, N)), hx=rng.normal(size=(B, MC, N)),
        point=point, res=res,
        rho=rng.uniform(0.5, 10.0, size=B), eps_p=rng.uniform(1e-9, 1e-6, size=B),
        eps_d=rng.uniform(1e-9, 1e-6, size=B), kappa=rng.uniform(1e-3, 1.0, size=B),
        lam=rng.normal(size=(B, ME)),
        jl=jcones.ConeLayout(MC, NN, SOCS), tl=tcones.ConeLayout(MC, NN, SOCS),
    )


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_residual_condense_expand_matvec_match_jax(iterate):
    it = iterate
    jl, tl = it["jl"], it["tl"]
    p_t = blocks_from_numpy(it["point"])
    res_t = blocks_from_numpy(it["res"])
    T = _t
    fx, gty, htz = (np.random.default_rng(2).normal(size=(B, N)) for _ in range(3))
    g, h = np.ones((B, ME)), np.ones((B, MC))

    def jres(fx, gty, htz, g, h, p, kappa, rho, lam):
        return jkkt.residual(
            fx, gty, htz, g, h, jcones.product(jl, p.s, p.t), jl.target(jnp.float64),
            p, kappa, rho, lam,
        )

    want = jax.vmap(jres)(fx, gty, htz, g, h, it["point"], it["kappa"], it["rho"], it["lam"])
    got = tkkt.residual(
        T(fx), T(gty), T(htz), T(g), T(h), tcones.product(tl, p_t.s, p_t.t),
        tl.target(torch.float64, "cpu"), p_t, T(it["kappa"]), T(it["rho"]), T(it["lam"]),
    )
    _close(got, tuple(want))

    args_j = (it["point"].s, it["point"].t, it["rho"], it["eps_p"], it["eps_d"])
    args_t = tuple(T(a) for a in args_j)
    rhs_j = jax.vmap(lambda r, *a: jkkt.condensed_rhs(jl, r, *a))(it["res"], *args_j)
    rhs_t = tkkt.condensed_rhs(tl, res_t, *args_t)
    _close(rhs_t, rhs_j)

    exp_j = jax.vmap(lambda r, d, *a: jkkt.expand(jl, r, d, N, ME, MC, *a))(it["res"], rhs_j, *args_j)
    _close(tkkt.expand(tl, res_t, rhs_t, N, ME, MC, *args_t), tuple(exp_j))

    mv_j = jax.vmap(lambda H, gx, hx, d, *a: jkkt.matvec(jl, H, gx, hx, *a, d))(
        it["H"], it["gx"], it["hx"], it["res"], *args_j
    )
    mv_t = tkkt.matvec(tl, T(it["H"]), T(it["gx"]), T(it["hx"]), *args_t, res_t)
    _close(mv_t, tuple(mv_j))


def test_schur_factorize_and_solve_match_jax(iterate):
    it = iterate
    jl, tl = it["jl"], it["tl"]
    args = (it["H"], it["gx"], it["hx"], it["point"].s, it["point"].t, it["rho"], it["eps_p"], it["eps_d"])

    fact_j = jax.vmap(lambda *a: jkkt.factorize(jl, *a, method="schur"))(*args)
    fact_t = tkkt.factorize(tl, *(_t(a) for a in args))
    Lj, Lt = np.asarray(fact_j.L), fact_t.L.numpy()
    assert nan_lanes(Lt).tolist() == nan_lanes(Lj).tolist() == [i == BAD for i in range(B)]
    ok = ~nan_lanes(Lt)
    np.testing.assert_allclose(Lt[ok], Lj[ok], atol=ATOL, rtol=0)

    # per-lane inertia reads: one lane's NaN factor flags that lane only
    ok_j = jax.vmap(lambda f: jkkt.inertia_ok(f, N, ME, MC, "schur"))(fact_j)
    assert tkkt.inertia_ok(fact_t).tolist() == np.asarray(ok_j).tolist()
    z_j = jax.vmap(lambda f: jkkt.num_zero_eigs(f, "schur"))(fact_j)
    assert tkkt.num_zero_eigs(fact_t).tolist() == np.asarray(z_j).tolist()

    step_j = jax.vmap(lambda f, r: jkkt.solve_with(jl, f, r, N, ME, MC, "schur"))(fact_j, it["res"])
    step_t = tkkt.solve_with(tl, fact_t, blocks_from_numpy(it["res"]), N, ME, MC)
    for got, want in zip(step_t, step_j):
        np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok], atol=ATOL, rtol=0)
        assert np.isnan(got.numpy()[~ok]).any(axis=-1).all()


def test_tiny_pivots_count_per_lane():
    """A collapsed pivot counts in its own lane only; NaN pivots never
    count, and one lane's scale never sets another lane's threshold."""
    d = torch.tensor(
        [[1.0, 1.0, 1e-14], [1e6, 1.0, 1.0], [float("nan"), 1.0, 1e-14], [1e-3, 1e-3, 1e-3]],
        dtype=torch.float64,
    )
    assert tkkt._tiny_pivots(d).tolist() == [1, 0, 1, 0]


def test_other_backends_are_refused(iterate):
    """spike without a mesh names Options.spike_mesh (its horizon splits are
    refused in tests/test_torch_spike.py); riccati and cr need a trajopt
    problem's stage structure; an unknown name is refused."""
    it = iterate
    args = (it["H"], it["gx"], it["hx"], it["point"].s, it["point"].t, it["rho"], it["eps_p"], it["eps_d"])
    with pytest.raises(ValueError, match="spike_mesh"):
        tkkt.factorize(it["tl"], *(_t(a) for a in args), method="spike")
    for method in ("riccati", "cr"):
        with pytest.raises(ValueError, match="stage structure"):
            tkkt.factorize(it["tl"], *(_t(a) for a in args), method=method)
    with pytest.raises(ValueError, match="unknown"):
        tkkt.factorize(it["tl"], *(_t(a) for a in args), method="qr")
