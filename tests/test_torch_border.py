"""The riccati backend's general-equality border against the JAX package
on the CPU in float64, on a cheap problem that needs it: the pendulum of
tests/test_features.py:14-47, whose `equality_general` rows pin the first
and the last state (two general stages, r_g = 4), with
linear_solver="riccati" and T=11.

At one seeded primal-dual point: the border columns V, Wg = S_bd^{-1} V,
the capacitance eigenvalues dc and C^{-1} = Lc diag(1/dc) Lc' (the
eigenvector signs are free), the Woodbury correction, the border inertia
per lane, and `solve_sym` with one and with several right-hand sides.
Then a batch of four perturbed guesses solved in both packages, lane by
lane."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import calipso_tpu
import calipso_tpu_torch
from calipso_tpu.solver import kkt as jkkt
from calipso_tpu_torch.solver import kkt as tkkt
from calipso_tpu_torch.utils.convert import options_from_jax

T = 11
B = 3
INDEFINITE = 1  # a lane whose Hessian blocks are made strongly indefinite
BORDER_ATOL = 1e-9
SOL_ATOL = 1e-6


def periodic_pendulum(pkg, options):
    """The pendulum with x_1 = (0, 0) and x_T = (pi, 0) as general rows."""
    if pkg == "jax":
        from calipso_tpu.models import pendulum

        cat, TS, extra = jnp.concatenate, calipso_tpu.TrajOptSolver, {}
        const = lambda v, z: jnp.array(v)
    else:
        from calipso_tpu_torch.models import pendulum

        cat, TS, extra = torch.cat, calipso_tpu_torch.TrajOptSolver, dict(device="cpu")
        options = options_from_jax(options)
        const = lambda v, z: torch.tensor(v, dtype=z.dtype, device=z.device)

    def general(z, theta):
        return cat([z[0:2] - const([0.0, 0.0], z), z[-2:] - const([np.pi, 0.0], z)])

    objective = [
        *[(lambda x, u, w: 0.01 * u @ u + 0.1 * (x[1] ** 2))] * (T - 1),
        lambda x, u, w: 0.1 * (x[1] ** 2),
    ]
    ts = TS(
        objective, [pendulum.discrete] * (T - 1), [2] * T, [1] * (T - 1),
        equality_general=general, options=options, **extra,
    )
    ts.initialize_states(pendulum.swingup_problem(T)["state_guess"])
    ts.initialize_actions([np.zeros(1)] * (T - 1))
    return ts


JOPTS = calipso_tpu.Options(linear_solver="riccati", line_search_mode="serial")


@pytest.fixture(scope="module")
def point():
    js, ts = (periodic_pendulum(pkg, JOPTS).solver for pkg in ("jax", "torch"))
    st = ts.fns.stage_structure
    assert st.general_stages == (0, T - 1) and st.num_general == 4
    dims = ts.dims
    n, me = dims.variables, dims.equality
    rng = np.random.default_rng(7)
    p = dict(
        js=js, ts=ts, n=n, me=me,
        x=rng.normal(size=(B, n)), th=np.zeros((B, 0)), y=rng.normal(size=(B, me)),
        z=np.zeros((B, 0)), s=np.zeros((B, 0)), t=np.zeros((B, 0)),
        rho=rng.uniform(0.5, 10.0, size=B), eps_p=rng.uniform(1e-9, 1e-6, size=B),
        eps_d=rng.uniform(1e-9, 1e-6, size=B),
    )
    fns = js.fns
    Dj, Oj, Hgj = jax.vmap(lambda x, th, y, z: fns.lagrangian_hessian_blocks(x, th, y, z, True))(
        p["x"], p["th"], p["y"], p["z"]
    )
    Dt, Ot, Hgt = ts.fns.lagrangian_hessian_blocks(*(torch.tensor(p[k]) for k in ("x", "th", "y", "z")))
    Dt[INDEFINITE] -= 1e3 * torch.eye(Dt.shape[-1], dtype=Dt.dtype)
    Dj = jnp.asarray(Dt.numpy())
    jst = fns.stage_structure
    Hj = jax.vmap(lambda D, O, H: jkkt.BandHessian(D, O, H, jst))(Dj, Oj, Hgj)
    Ht = tkkt.BandHessian(Dt, Ot, Hgt, st)
    gxj = jax.vmap(fns.gx)(p["x"], p["th"])
    hxj = jax.vmap(fns.hx)(p["x"], p["th"])
    args = [p[k] for k in ("s", "t", "rho", "eps_p", "eps_d")]
    p["fj"] = jax.vmap(
        lambda H, *a: jkkt.factorize(js.layout, H, *a, method="riccati", structure=jst)
    )(Hj, gxj, hxj, *(jnp.asarray(a) for a in args))
    gxt = ts.fns.gx(torch.tensor(p["x"]), torch.tensor(p["th"]))
    hxt = ts.fns.hx(torch.tensor(p["x"]), torch.tensor(p["th"]))
    p["ft"] = tkkt.factorize(ts.layout, Ht, gxt, hxt, *(torch.tensor(a) for a in args), "riccati", st)
    return p


def _close(got, want, atol=BORDER_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def test_border_pieces_match_jax(point):
    p = point
    fj, ft = p["fj"], p["ft"]
    jst, tst = p["js"].fns.stage_structure, p["ts"].fns.stage_structure
    _close(tkkt._border_V(tst, ft.gx).numpy(), jax.vmap(lambda g: jkkt._border_V(jst, g))(fj.gx))
    ok = [i != INDEFINITE for i in range(B)]
    assert tkkt.inertia_ok(ft, tst).tolist() == ok
    ok_j = jax.vmap(lambda f: jkkt.inertia_ok(f, p["n"], p["me"], 0, "riccati", jst))(fj)
    assert np.asarray(ok_j).tolist() == ok
    border_ok_j = jax.vmap(lambda f: jkkt._border_inertia_ok(f, jst))(fj)
    assert tkkt._border_inertia_ok(ft, tst).tolist() == np.asarray(border_ok_j).tolist() == ok
    assert np.isnan(ft.dc[INDEFINITE].numpy()).all()
    good = np.array(ok)
    _close(ft.Wg.numpy()[good], np.asarray(fj.Wg)[good])
    _close(ft.dc.numpy()[good], np.asarray(fj.dc)[good])
    cinv = lambda Lc, dc: Lc @ (Lc.swapaxes(-1, -2) / dc[..., :, None])
    _close(cinv(ft.Lc.numpy(), ft.dc.numpy())[good], cinv(np.asarray(fj.Lc), np.asarray(fj.dc))[good])

    rng = np.random.default_rng(3)
    for shape in ((B, p["n"]), (B, p["n"], 3)):
        dx = rng.normal(size=shape)
        got = tkkt._apply_border(ft, tst, torch.tensor(dx)).numpy()
        want = jax.vmap(lambda f, v: jkkt._apply_border(f, jst, v))(fj, jnp.asarray(dx))
        _close(got[good], np.asarray(want)[good])


@pytest.mark.parametrize("K", [None, 4])
def test_border_solve_sym_matches_jax(point, K):
    """One right-hand side, and K=4 at once (through solve_multi)."""
    p = point
    fj, ft = p["fj"], p["ft"]
    jst, tst = p["js"].fns.stage_structure, p["ts"].fns.stage_structure
    n, me = p["n"], p["me"]
    shape = (B, n + me) if K is None else (B, n + me, K)
    rhs = np.random.default_rng(5).normal(size=shape)
    got = tkkt.solve_sym(p["ts"].layout, ft, torch.tensor(rhs), n, me, 0, "riccati", tst).numpy()
    want = jax.vmap(
        lambda f, r: jkkt.solve_sym(p["js"].layout, f, r, n, me, 0, "riccati", jst)
    )(fj, jnp.asarray(rhs))
    good = np.arange(B) != INDEFINITE
    _close(got[good], np.asarray(want)[good], atol=1e-8)
    if K is not None:
        one = tkkt.solve_sym(p["ts"].layout, ft, torch.tensor(rhs[..., 1]), n, me, 0, "riccati", tst)
        _close(one.numpy()[good], got[good][..., 1], atol=1e-10)


def test_border_batch_matches_jax():
    """Four guesses perturbed by 0.05 N(0, 1), solved in both packages:
    equal solved flags and iterations lane by lane, solutions within
    1e-6, and the general rows met at the 1e-4 contract."""
    tj, tt = (periodic_pendulum(pkg, JOPTS) for pkg in ("jax", "torch"))
    g0 = np.asarray(tj._guess)
    guess = g0[None] + 0.05 * np.random.default_rng(0).normal(size=(4, g0.size))
    rj = tj.batched().solve(guess=jnp.asarray(guess))
    rt = tt.batched().solve(guess=torch.tensor(guess))
    solved = np.asarray(rj.state.solved)
    assert solved.all() and rt.state.solved.tolist() == solved.tolist()
    assert rt.state.total_i.tolist() == np.asarray(rj.state.total_i).tolist()
    x = rt.state.p.x.numpy()
    _close(x, np.asarray(rj.state.p.x), atol=SOL_ATOL)
    np.testing.assert_allclose(x[:, 0:2], 0.0, atol=1e-4)
    np.testing.assert_allclose(x[:, -2:], np.tile([np.pi, 0.0], (4, 1)), atol=1e-4)
