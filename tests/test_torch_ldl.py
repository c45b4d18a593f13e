"""The port's ldl and lu backends and the refinement fallback against the
JAX package on the CPU in float64: `ops/ldl.py` against
`calipso_tpu/ops/ldl.py` (factor, solve with one and several right-hand
sides, the inertia read, on quasidefinite and indefinite matrices); the
dense cone blocks, the condensed and the full 6-block KKT matrices, the
ldl factorization and step and the full-system LU step at one batched
iterate (that of tests/test_torch_kkt.py); and the problems of
tests/test_backends.py solved on ldl and lu, and with
`refinement_fallback=True`, in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import calipso_tpu
import calipso_tpu_torch
from calipso_tpu.ops import cones as jcones
from calipso_tpu.ops import ldl as jldl
from calipso_tpu.solver import kkt as jkkt
from calipso_tpu_torch.ops import cones as tcones
from calipso_tpu_torch.ops import ldl as tldl
from calipso_tpu_torch.solver import kkt as tkkt
from calipso_tpu_torch.utils.convert import blocks_from_numpy, options_from_jax
from tests.test_ldl import quasidefinite
from tests.test_torch_kkt import BAD, MC, ME, N, B, _t, iterate  # noqa: F401 (iterate: a fixture)

ATOL = 1e-9


def test_ldl_matches_jax():
    """Two quasidefinite lanes (12 + 7) and one indefinite symmetric lane:
    L and d, the solves and the inertia counts lane by lane."""
    rng = np.random.default_rng(0)
    K = np.stack([quasidefinite(12, 7, rng), quasidefinite(12, 7, rng), rng.normal(size=(19, 19))])
    K[2] = 0.5 * (K[2] + K[2].T)
    b = rng.normal(size=(3, 19, 4))
    L, d = tldl.ldl_factor(torch.tensor(K))
    x = tldl.ldl_solve(L, d, torch.tensor(b[..., 0]))
    X = tldl.ldl_solve(L, d, torch.tensor(b))
    counts = [c.tolist() for c in tldl.inertia_counts(d)]

    @jax.jit
    def reference(K, b):
        L, d = jax.vmap(jldl.ldl_factor)(K)
        solve = jax.vmap(jldl.ldl_solve)
        return L, d, solve(L, d, b[..., 0]), solve(L, d, b), jax.vmap(jldl.inertia_counts)(d)

    Lj, dj, xj, Xj, cj = reference(jnp.asarray(K), jnp.asarray(b))
    for got, want in ((L, Lj), (d, dj), (x, xj), (X, Xj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert counts == [np.asarray(c).tolist() for c in cj]
    evals = np.linalg.eigvalsh(K)  # Sylvester: the counts are the lanes' inertia
    assert counts == [(evals > 0).sum(1).tolist(), (evals < 0).sum(1).tolist(), [0, 0, 0]]
    assert counts[:2] == [[12, 12, 10], [7, 7, 9]]
    np.testing.assert_allclose((L @ torch.diag_embed(d) @ L.mT).numpy(), K, atol=1e-9)


def test_inertia_threshold_is_per_lane():
    """A pivot of 1e-12 is a zero eigenvalue beside a 1e6 pivot of its own
    lane, and positive in a lane whose largest pivot is 1: one lane's scale
    never sets another lane's threshold. Non-finite pivots count as zero."""
    d = torch.tensor([[1e6, 1e-12, -1.0], [1.0, 1e-12, -1.0], [float("nan"), 1.0, -1.0]], dtype=torch.float64)
    pos, neg, zero = tldl.inertia_counts(d)
    assert (pos.tolist(), neg.tolist(), zero.tolist()) == ([1, 2, 1], [1, 1, 1], [1, 0, 1])
    for i in range(3):
        assert [int(c) for c in jldl.inertia_counts(jnp.asarray(d[i].numpy()))] == [
            pos[i].item(), neg[i].item(), zero[i].item()
        ]


def _args(it, to):
    return tuple(to(a) for a in (it["H"], it["gx"], it["hx"], it["point"].s, it["point"].t, it["rho"], it["eps_p"], it["eps_d"]))


def test_cone_matrices_match_jax(iterate):
    it = iterate
    jl, tl = it["jl"], it["tl"]
    s, t = it["point"].s, it["point"].t
    got = (
        tcones.arrow_matrices(tl, _t(s)),
        tcones.dense_arrow(tl, _t(t)),
        tcones.condensed_block(tl, _t(s), _t(t), _t(it["eps_p"]), _t(it["eps_d"])),
    )
    want = (
        jax.vmap(lambda u: jcones.arrow_matrices(jl, u))(s),
        jax.vmap(lambda u: jcones.dense_arrow(jl, u))(t),
        jax.vmap(lambda *a: jcones.condensed_block(jl, *a, jnp.float64))(s, t, it["eps_p"], it["eps_d"]),
    )
    # the padded slots of arrow_matrices carry values the scatter drops
    real = jl.idx < jl.num_cone
    mask = real[:, :, None] & real[:, None, :]
    np.testing.assert_allclose(got[0].numpy()[:, mask], np.asarray(want[0])[:, mask], atol=ATOL, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_dense_kkt_matches_jax(iterate):
    """The condensed and the full 6-block matrices, the ldl factorization,
    its inertia reads (lane BAD has an indefinite Hessian) and step, and
    the full-system LU step."""
    it = iterate
    jl, tl = it["jl"], it["tl"]
    args_t = _args(it, _t)
    res_t = blocks_from_numpy(it["res"])

    @jax.jit
    def reference(*args):
        one = lambda f: jax.vmap(f)(*args)
        fact = one(lambda *a: jkkt.factorize(jl, *a, method="ldl"))
        ok = jax.vmap(lambda f: jkkt.inertia_ok(f, N, ME, MC, "ldl"))(fact)
        zero = jax.vmap(lambda f: jkkt.num_zero_eigs(f, "ldl"))(fact)
        step = jax.vmap(lambda f, r: jkkt.solve_with(jl, f, r, N, ME, MC, "ldl"))(fact, it["res"])
        lu = jax.vmap(lambda r, *a: jkkt.lu_solve_full(jl, *a, r))(it["res"], *args)
        return (
            one(lambda *a: jkkt.condensed_matrix(jl, *a)), one(lambda *a: jkkt.full_matrix(jl, *a)),
            fact.L, fact.d, ok, zero, step, lu,
        )

    Kj, Jj, Lj, dj, ok_j, zero_j, step_j, lu_j = reference(*_args(it, jnp.asarray))
    np.testing.assert_allclose(tkkt.condensed_matrix(tl, *args_t).numpy(), np.asarray(Kj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tkkt.full_matrix(tl, *args_t).numpy(), np.asarray(Jj), atol=ATOL, rtol=0)
    fact = tkkt.factorize(tl, *args_t, method="ldl")
    ok = tkkt.inertia_ok(fact)
    assert ok.tolist() == np.asarray(ok_j).tolist() == [i != BAD for i in range(B)]
    assert tkkt.num_zero_eigs(fact, "ldl").tolist() == np.asarray(zero_j).tolist()
    np.testing.assert_allclose(fact.L.numpy(), np.asarray(Lj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(fact.d.numpy(), np.asarray(dj), atol=ATOL, rtol=0)
    step = tkkt.solve_with(tl, fact, res_t, N, ME, MC, "ldl")
    lu = tkkt.lu_solve_full(tl, *args_t, res_t)
    for got, want in zip(tuple(step) + tuple(lu), tuple(step_j) + tuple(lu_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-8, rtol=0)


def _wachter(pkg, options):
    if pkg == "jax":
        eq = lambda x: jnp.array([x[0] ** 2 - x[1] - 1.0, x[0] - x[2] - 0.5])
        s = calipso_tpu.Solver(lambda x: x[0], eq, lambda x: x[1:3], 3, options=options)
        return s.solve(jnp.array([-2.0, 3.0, 1.0]))
    eq = lambda x: torch.stack([x[0] ** 2 - x[1] - 1.0, x[0] - x[2] - 0.5])
    s = calipso_tpu_torch.Solver(lambda x: x[0], eq, lambda x: x[1:3], 3, options=options, device="cpu")
    return s.solve(torch.tensor([-2.0, 3.0, 1.0], dtype=torch.float64))


def _soc(pkg, options):
    kw = dict(num_parameters=4, nonnegative_indices=[], second_order_indices=[[0, 1, 2]], options=options)
    x0, th = [0.3, -0.5, 0.2], [0.0, 1.0, 1.0, 0.5]
    if pkg == "jax":
        s = calipso_tpu.Solver(lambda x, th: th[:3] @ x, lambda x, th: jnp.array([x[0] - th[3]]), lambda x, th: x, 3, **kw)
        return s.solve(jnp.array(x0), parameters=jnp.array(th))
    s = calipso_tpu_torch.Solver(
        lambda x, th: th[:3] @ x, lambda x, th: x[:1] - th[3:], lambda x, th: x, 3, device="cpu", **kw
    )
    return s.solve(torch.tensor(x0, dtype=torch.float64), parameters=torch.tensor(th, dtype=torch.float64))


def _same_solve(rj, rt):
    assert bool(rj.solved) and bool(rt.solved)
    assert int(rt.iterations) == int(rj.iterations)
    for name in ("num_fallbacks", "num_ladder", "num_refine"):
        assert int(getattr(rt.state, name)) == int(getattr(rj.state, name)), name
    np.testing.assert_allclose(rt.variables.numpy(), np.asarray(rj.variables), atol=1e-6, rtol=0)


@pytest.mark.parametrize("method", ["ldl", "lu"])
@pytest.mark.parametrize("problem", [_wachter, _soc], ids=["wachter", "soc"])
def test_backends_match_jax(problem, method):
    """tests/test_backends.py's Wachter problem (x* = [1, 0, 0.5]) and its
    second-order-cone problem on ldl and on lu."""
    jopts = calipso_tpu.Options(linear_solver=method, line_search_mode="serial")
    rj = problem("jax", jopts)
    rt = problem("torch", options_from_jax(jopts))
    _same_solve(rj, rt)
    if problem is _wachter:
        np.testing.assert_allclose(rt.variables.numpy(), [1.0, 0.0, 0.5], atol=1e-3)


@pytest.mark.parametrize("factor", ["healthy", "broken"])
def test_refinement_fallback_matches_jax(monkeypatch, factor):
    """The Wachter problem with refinement_fallback=True on schur. Healthy,
    the escalation never fires; with every Cholesky factor scaled by 1e4
    in both packages (tests/test_inertia.py's broken factorization), the
    refined step has no usable digits and every step escalates to the
    full-system LU step: the same steps and fallback counts in both."""
    if factor == "broken":
        for mod in (jkkt, tkkt):
            orig = mod.factorize
            monkeypatch.setattr(mod, "factorize", lambda *a, _f=orig, **k: (lambda f: f._replace(L=f.L * 1.0e4))(_f(*a, **k)))
    jopts = calipso_tpu.Options(linear_solver="schur", line_search_mode="serial", refinement_fallback=True)
    rj = _wachter("jax", jopts)
    rt = _wachter("torch", options_from_jax(jopts))
    _same_solve(rj, rt)
    fired = int(rt.state.num_fallbacks)
    assert (fired > 0) if factor == "broken" else (fired == 0)
