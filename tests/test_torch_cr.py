"""The port's cr backend against the JAX package on the CPU in float64:
`ops/cyclic_reduction.py` against `calipso_tpu/ops/cyclic_reduction.py`
(its levels, solve, several right-hand sides and the per-lane inertia
signal) at odd, even and one-stage horizons; the cr branches of the KKT
layer at a random point of the rocket landing (the reference's cr
inertia reads, and the riccati step, on the same system); batched solves
of the pendulum flagship and of the periodic pendulum, whose general
rows ride the border, lane by lane against the reference; and the T=101
rocket on cr landing on its golden."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import calipso_tpu
from calipso_tpu.ops import cyclic_reduction as jcr
from calipso_tpu.solver import kkt as jkkt
from calipso_tpu_torch.ops import cuda_riccati
from calipso_tpu_torch.ops import cyclic_reduction as tcr
from calipso_tpu_torch.solver import kkt as tkkt
from calipso_tpu_torch.utils.convert import options_from_jax
from tests.test_riccati import make_block_tridiag
from tests.test_torch_border import periodic_pendulum
from tests.test_torch_riccati import (  # noqa: F401 (point: a fixture)
    B, INDEFINITE, STEP_ATOL, _jax_blocks, _kkt_args, _residual, _rocket_pair, _t, _torch_blocks,
    _tridiag_batch, point,
)
from tests.test_torch_slice import SOL_ATOL
from tests.torch_parity import pendulum_solver

ATOL = 1e-9


def _batch(T, d, seed, lanes=3):
    rng = np.random.default_rng(seed)
    D = np.zeros((lanes, T, d, d))
    O = np.zeros((lanes, T - 1, d, d))
    for i in range(lanes):
        D[i], O[i], _ = make_block_tridiag(T, d, rng)
    return D, O, rng.normal(size=(lanes, T, d, 3))


@pytest.mark.parametrize("T", [1, 2, 3, 8, 13, 31])
def test_cr_matches_jax(T):
    """Every level's factors, the final factor, one and three right-hand
    sides, and factors_finite, lane by lane against the reference."""
    D, O, b = _batch(T, 4, T)
    fact = tcr.factor(torch.tensor(D), torch.tensor(O))
    levels, L_final = fact
    assert len(levels) == tcr.num_levels(T) == jcr.num_levels(T)
    X = tcr.solve_multi(fact, torch.tensor(b)).numpy()
    x = tcr.solve(fact, torch.tensor(b[..., 0])).numpy()
    assert tcr.factors_finite(fact).tolist() == [True] * D.shape[0]

    @jax.jit
    def reference(D, O, b):
        jf = jax.vmap(jcr.factor)(D, O)
        return jf, jax.vmap(jcr.solve_multi)(jf, b), jax.vmap(jcr.solve)(jf, b[..., 0])

    jf, Xj, xj = reference(jnp.asarray(D), jnp.asarray(O), jnp.asarray(b))
    for got, want in zip(levels, jf[0]):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    np.testing.assert_allclose(L_final.numpy(), np.asarray(jf[1]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(X, np.asarray(Xj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(x, np.asarray(xj), atol=ATOL, rtol=0)


def test_cr_flags_the_lane_that_is_not_positive_definite():
    """Lane 1's stage 2 block is negated (tests/test_cyclic_reduction.py's
    case): factors_finite is False for that lane only, and its solution is
    not finite, while the other lanes solve exactly."""
    D, O, b = _batch(5, 3, 0)
    D[1, 2] = -np.eye(3)
    fact = tcr.factor(torch.tensor(D), torch.tensor(O))
    assert tcr.factors_finite(fact).tolist() == [True, False, True]
    assert not bool(jcr.factors_finite(jcr.factor(jnp.asarray(D[1]), jnp.asarray(O[1]))))
    x = tcr.solve(fact, torch.tensor(b[..., 0])).numpy()
    assert not np.isfinite(x[1]).all()
    good = cuda_riccati.solve_batched_plain(*(torch.tensor(a) for a in (D, O, b[..., 0]))).numpy()
    np.testing.assert_allclose(x[[0, 2]], good[[0, 2]], atol=ATOL, rtol=0)


def test_cr_kkt_matches_jax_and_the_riccati_step(point):
    """At the rocket point (lane 1 made indefinite): the cr inertia reads
    equal the reference's, and the cr step the riccati one where the
    factor is finite, with one and with four right-hand sides."""
    p = point
    ts, js = p["ts"], p["js"]
    tst, jst = ts.fns.stage_structure, js.fns.stage_structure
    n, me, mc = p["n"], p["me"], p["mc"]
    Dt, Ot, _ = _torch_blocks(p)
    Dt[INDEFINITE] -= 1e3 * torch.eye(Dt.shape[-1], dtype=Dt.dtype)
    Ht = tkkt.BandHessian(Dt, Ot, None, tst)
    args_t = _kkt_args(p, ts.fns, _t)
    fc = tkkt.factorize(ts.layout, Ht, *args_t, method="cr", structure=tst)
    fr = tkkt.factorize(ts.layout, Ht, *args_t, method="riccati", structure=tst)
    ok = tkkt.inertia_ok(fc, tst)
    assert ok.tolist() == tkkt.inertia_ok(fr, tst).tolist() == [i != INDEFINITE for i in range(B)]
    Hj = jax.vmap(lambda D, O: jkkt.BandHessian(D, O, None, jst))(jnp.asarray(Dt.numpy()), jnp.asarray(Ot.numpy()))

    @jax.jit
    def reads(H, *a):
        fj = jax.vmap(lambda H, *a: jkkt.factorize(js.layout, H, *a, method="cr", structure=jst))(H, *a)
        ok_j = jax.vmap(lambda f: jkkt.inertia_ok(f, n, me, mc, "cr", jst))(fj)
        return ok_j, jax.vmap(lambda f: jkkt.num_zero_eigs(f, "cr", jst))(fj)

    ok_j, z_j = reads(Hj, *_kkt_args(p, js.fns, jnp.asarray))
    assert ok.tolist() == np.asarray(ok_j).tolist()
    assert tkkt.num_zero_eigs(fc, "cr", tst).tolist() == np.asarray(z_j).tolist()

    res = _residual(p, np.random.default_rng(5))
    step_c = tkkt.solve_with(ts.layout, fc, res, n, me, mc, "cr", tst)
    step_r = tkkt.solve_with(ts.layout, fr, res, n, me, mc, "riccati", tst)
    for a, b in zip(step_c, step_r):
        np.testing.assert_allclose(a[ok].numpy(), b[ok].numpy(), atol=STEP_ATOL, rtol=0)
    rhs = torch.tensor(np.random.default_rng(6).normal(size=(B, n + me + mc, 4)))
    got = tkkt.solve_sym(ts.layout, fc, rhs, n, me, mc, "cr", tst)
    want = tkkt.solve_sym(ts.layout, fr, rhs, n, me, mc, "riccati", tst)
    np.testing.assert_allclose(got[ok].numpy(), want[ok].numpy(), atol=STEP_ATOL, rtol=0)


def test_cr_num_zero_eigs_excludes_padded_pivots(point):
    """The rocket's ragged stages (the last has 6 of 9 slots real), the
    blocks of tests/test_torch_riccati.py: lane 1 has one collapsed pivot,
    lane 2 is scaled by 1e-26, so its real pivots would all count as tiny
    beside the padded unit pivots of every level, were those not
    excluded. Port and reference count alike."""
    p = point
    tst, jst = p["ts"].fns.stage_structure, p["js"].fns.stage_structure
    T, dmax = tst.horizon, tst.dmax
    D, O, _ = _tridiag_batch(np.random.default_rng(13), B, T, dmax)
    pad = tst.blk_idx == tst.num_variables
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
    fact = tkkt.Factorization(*([None] * 9), cr=tcr.factor(torch.tensor(D), torch.tensor(O)))
    got = tkkt.num_zero_eigs(fact, "cr", tst).tolist()
    want = [
        int(jkkt.num_zero_eigs(
            jkkt.Factorization(*([None] * 10), jcr.factor(jnp.asarray(D[i]), jnp.asarray(O[i]))), "cr", jst
        ))
        for i in range(B)
    ]
    assert got == want and got[0] == 0 and got[1] == 1 and got[2] == 0


def _same_solves(rj, rt, counters=("outer_i", "num_ladder", "num_refine", "num_ls_chunks")):
    solved = np.asarray(rj.state.solved)
    assert solved.all() and rt.state.solved.tolist() == solved.tolist()
    assert rt.state.total_i.tolist() == np.asarray(rj.state.total_i).tolist()
    np.testing.assert_allclose(rt.state.p.x.numpy(), np.asarray(rj.state.p.x), atol=SOL_ATOL, rtol=0)
    for name in counters:
        assert getattr(rt.state, name).tolist() == np.asarray(getattr(rj.state, name)).tolist(), name


JOPTS = calipso_tpu.Options(linear_solver="cr", line_search_mode="serial")


def test_cr_pendulum_batch_matches_jax():
    """The flagship's pendulum (T=11) on cr, B=4, in both packages."""
    x0s = 0.2 * np.random.default_rng(3).normal(size=(4, 2))
    tt = pendulum_solver("torch", 11, options_from_jax(JOPTS))
    assert tt.solver.options.linear_solver == "cr"
    rj = pendulum_solver("jax", 11, JOPTS).batched().solve(parameters=jnp.asarray(x0s))
    rt = tt.batched().solve(parameters=torch.tensor(x0s))
    _same_solves(rj, rt)


def test_cr_border_batch_matches_jax():
    """The periodic pendulum of tests/test_torch_border.py (x_1 and x_T
    pinned by general rows: the border over two stages) on cr, four
    perturbed guesses, in both packages."""
    tj, tt = (periodic_pendulum(pkg, JOPTS) for pkg in ("jax", "torch"))
    g0 = np.asarray(tj._guess)
    guess = g0[None] + 0.05 * np.random.default_rng(0).normal(size=(4, g0.size))
    rj = tj.batched().solve(guess=jnp.asarray(guess))
    rt = tt.batched().solve(guess=torch.tensor(guess))
    _same_solves(rj, rt)
    np.testing.assert_allclose(rt.state.p.x.numpy()[:, -2:], np.tile([np.pi, 0.0], (4, 1)), atol=1e-4)


def test_golden_rocket101_cr():
    """bench.py's rocket101 (examples/rocket_landing.py) on cr, solved
    through the port's example (calipso_tpu_torch/examples/rocket_landing,
    whose options are Options(linear_solver="cr")'s on the CPU): the T=101
    single solve lands on tests/golden/rocket101.npz, states within 1e-3,
    iterations within 2, and the example's own assertions hold."""
    from calipso_tpu_torch.examples import rocket_landing

    gold = np.load(os.path.join(os.path.dirname(__file__), "golden", "rocket101.npz"))
    out = rocket_landing.main("cpu")
    ts, r = out["solver"], out["result"]
    assert ts.solver.options.linear_solver == "cr"
    assert bool(r.solved)
    z, zg = r.variables.numpy(), gold["variables"]
    for idx in ts._state_indices:
        np.testing.assert_allclose(z[idx], zg[idx], atol=1e-3)
    assert abs(int(r.iterations) - int(gold["iterations"])) <= 2
