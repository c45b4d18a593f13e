"""The port's main paths end to end against the JAX package on the CPU in
float64: batched trajopt solves through `TrajOptSolver(...).batched()
.solve(...)` in both packages, on the benchmark flagship's pendulum (T=11,
B=8, schur), the `__graft_entry__.py` cartpole (T=21, B=4, n=104: schur
pinned, and riccati through "auto") and the bench's batched rocket landing
(T=31, B=4, n=276, riccati through "auto"); plus the rocket T=101 single
solve against its stored golden. The line-search mode is pinned to
"serial" in both packages.

Each lane must reach the same solved flag in the same number of
iterations, with solutions within 1e-6 (none of these is a contact
problem, so iteration counts must agree exactly, not within a band)."""

import os

import numpy as np
import pytest
import torch

import calipso_tpu
import calipso_tpu_torch
from calipso_tpu_torch.utils.convert import blocks_from_numpy, options_from_jax, state_from_numpy
from tests.torch_parity import cartpole_solver, pendulum_solver

SOL_ATOL = 1e-6


def _pinned(**kw):
    return calipso_tpu.Options(line_search_mode="serial", linear_solver="schur", **kw)


def _solve_both(build, horizon, x0s, jopts):
    import jax.numpy as jnp

    rj = build("jax", horizon, jopts).batched().solve(parameters=jnp.asarray(x0s))
    tts = build("torch", horizon, options_from_jax(jopts))
    rt = tts.batched().solve(parameters=torch.tensor(x0s))
    return rj, rt


def _assert_same_solves(rj, rt):
    solved_j = np.asarray(rj.state.solved)
    assert rt.state.solved.tolist() == solved_j.tolist()
    assert solved_j.all()
    assert rt.state.total_i.tolist() == np.asarray(rj.state.total_i).tolist()
    np.testing.assert_allclose(
        rt.state.p.x.numpy(), np.asarray(rj.state.p.x), atol=SOL_ATOL, rtol=0
    )


@pytest.fixture(scope="module")
def pendulum_pair():
    x0s = 0.2 * np.random.default_rng(0).normal(size=(8, 2))
    return x0s, _solve_both(pendulum_solver, 11, x0s, _pinned())


def test_pendulum_batch_matches_jax(pendulum_pair):
    _, (rj, rt) = pendulum_pair
    _assert_same_solves(rj, rt)
    # the cost counters agree lane by lane too
    for name in ("outer_i", "num_ladder", "num_refine", "num_ls_chunks"):
        assert getattr(rt.state, name).tolist() == np.asarray(getattr(rj.state, name)).tolist(), name


def test_state_carried_from_jax(pendulum_pair):
    """convert.state_from_numpy carries a reference State into the port's
    types, and a warm start from the reference's solution, carried by
    convert.blocks_from_numpy, takes the same steps in both packages."""
    x0s, (rj, rt) = pendulum_pair
    st = state_from_numpy(rj.state)
    assert st.total_i.dtype == torch.int32 and st.solved.dtype == torch.bool
    assert st.total_i.tolist() == rt.state.total_i.tolist()
    np.testing.assert_allclose(st.p.x.numpy(), rt.state.p.x.numpy(), atol=SOL_ATOL)

    import jax.numpy as jnp

    jopts = _pinned(warmstart=True)
    wj = pendulum_solver("jax", 11, jopts).batched().solve(
        parameters=jnp.asarray(x0s), warm=rj.state.p
    )
    ts = pendulum_solver("torch", 11, options_from_jax(jopts))
    wt = ts.batched().solve(parameters=torch.tensor(x0s), warm=blocks_from_numpy(rj.state.p))
    _assert_same_solves(wj, wt)


@pytest.fixture(scope="module")
def cone_pair():
    x0s = 0.2 * np.random.default_rng(2).normal(size=(4, 2))
    return x0s, _solve_both(
        lambda pkg, h, o: pendulum_solver(pkg, h, o, cones=True), 11, x0s, _pinned()
    )


@pytest.mark.parametrize("mode", ["serial", "parallel"])
def test_pendulum_with_cones_matches_jax(cone_pair, mode):
    """Action bounds (orthant) and velocity bounds (second-order cones),
    active at the solution: the cone fraction-to-the-boundary searches,
    barrier terms and the cone blocks of the KKT system all run. The
    port's parallel line search must take the reference's serial steps."""
    x0s, (rj, rt) = cone_pair
    if mode == "parallel":
        ts = pendulum_solver("torch", 11, options_from_jax(_pinned()).replace(
            line_search_mode="parallel"), cones=True)
        rt = ts.batched().solve(parameters=torch.tensor(x0s))
    _assert_same_solves(rj, rt)
    assert float(rt.state.p.x[:, 2::3].abs().max()) > 16.99  # the bounds bind


def test_cartpole_batch_matches_jax():
    x0s = 0.1 * np.random.default_rng(1).normal(size=(4, 4))
    rj, rt = _solve_both(cartpole_solver, 21, x0s, _pinned())
    _assert_same_solves(rj, rt)


def test_cartpole_auto_riccati_matches_jax():
    """n=104 > 96: "auto" resolves to riccati in both packages."""
    x0s = 0.1 * np.random.default_rng(1).normal(size=(4, 4))
    jopts = calipso_tpu.Options(line_search_mode="serial")
    assert cartpole_solver("torch", 21, options_from_jax(jopts)).solver.options.linear_solver == "riccati"
    rj, rt = _solve_both(cartpole_solver, 21, x0s, jopts)
    _assert_same_solves(rj, rt)


def _rocket(pkg, horizon, options, **kw):
    """`bench.py`'s rocket landing as a TrajOptSolver of package `pkg`."""
    if pkg == "jax":
        from calipso_tpu.models import rocket

        TS = calipso_tpu.TrajOptSolver
    else:
        from calipso_tpu_torch.models import rocket

        TS = calipso_tpu_torch.TrajOptSolver
        options, kw = options_from_jax(options), dict(kw, device="cpu")
    prob = rocket.landing_problem(horizon=horizon)
    args = {k: v for k, v in prob.items() if k not in ("state_guess", "state_initial", "state_goal")}
    ts = TS(options=options, **args, **kw)
    ts.initialize_states([np.asarray(s) for s in prob["state_guess"]])
    return ts, prob


def test_rocket_batch_matches_jax():
    """The bench's batched rocket landing (T=31, 30 three-dimensional
    second-order cones) through "auto" -> riccati, B=4 scenarios given
    as guesses perturbed by 0.01 N(0, 1) (`bench.py`)."""
    import jax.numpy as jnp

    jopts = calipso_tpu.Options(line_search_mode="serial", max_iterative_refinement=2)
    tj, _ = _rocket("jax", 31, jopts)
    tt, _ = _rocket("torch", 31, jopts)
    assert tt.solver.options.linear_solver == "riccati" and tt.num_variables == 276
    g0 = np.asarray(tj._guess)
    guess = g0[None] + 0.01 * np.random.default_rng(0).normal(size=(4, g0.size))
    rj = tj.batched().solve(guess=jnp.asarray(guess))
    rt = tt.batched().solve(guess=torch.tensor(guess))
    _assert_same_solves(rj, rt)
    for name in ("outer_i", "num_ladder", "num_refine", "num_ls_chunks"):
        assert getattr(rt.state, name).tolist() == np.asarray(getattr(rj.state, name)).tolist(), name


def test_single_general_stage_riccati_matches_jax():
    """equality_general rows touching one stage need no border: the
    block-diagonal Gram fold and the band part of their (here nonzero)
    Hessian carry them on the riccati backend (the reference's
    tests/test_riccati_backend.py:test_general_equality_single_stage_fold,
    with one general row made nonlinear)."""
    import jax.numpy as jnp
    from calipso_tpu.models import pendulum as jpend
    from calipso_tpu_torch.models import pendulum as tpend

    T = 5
    jopts = calipso_tpu.Options(linear_solver="riccati", line_search_mode="serial")
    goal = lambda z: (z[-2] - np.pi, z[-1] + 0.1 * z[-2] ** 2 - 0.1 * np.pi**2)
    results = []
    for pkg, m, stack, kw in (
        (calipso_tpu, jpend, jnp.stack, {}),
        (calipso_tpu_torch, tpend, torch.stack, dict(device="cpu")),
    ):
        opts = jopts if pkg is calipso_tpu else options_from_jax(jopts)
        ts = pkg.TrajOptSolver(
            [lambda x, u, w: 0.01 * u @ u] * (T - 1) + [lambda x, u, w: 0.0 * x[0]],
            [m.discrete] * (T - 1), [2] * T, [1] * (T - 1),
            equality_general=lambda z, th, stack=stack: stack(goal(z)),
            equality=[lambda x, u, w: x] + [None] * (T - 1),
            options=opts, **kw,
        )
        assert ts.solver.fns.stage_structure.general_stages == (T - 1,)
        ts.initialize_states(m.swingup_problem(T)["state_guess"])
        ts.initialize_actions([np.zeros(1)] * (T - 1))
        results.append(ts.solve())
    rj, rt = results
    assert bool(rj.solved) and bool(rt.solved)
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(rt.variables.numpy(), np.asarray(rj.variables), atol=SOL_ATOL, rtol=0)


def test_golden_rocket101():
    """The port's version of tests/test_golden.py:test_golden_rocket101:
    the T=101 single solve (riccati through "auto") lands on the stored
    golden states within 1e-3, in 16 +- 2 iterations."""
    gold = np.load(os.path.join(os.path.dirname(__file__), "golden", "rocket101.npz"))
    ts, prob = _rocket("torch", 101, calipso_tpu.Options())
    assert ts.solver.options.linear_solver == "riccati"
    guess = np.zeros(ts.num_variables)
    for t, idx in enumerate(ts._state_indices):
        guess[idx] = np.asarray(prob["state_guess"][t])
    rng = np.random.default_rng(0)
    for t, idx in enumerate(ts._action_indices):
        guess[idx] = 1e-3 * rng.normal(size=3)
    ts.solver.initialize(torch.tensor(guess))
    r = ts.solver.solve()
    assert bool(r.solved)
    z, zg = r.variables.numpy(), gold["variables"]
    for idx in ts._state_indices:
        np.testing.assert_allclose(z[idx], zg[idx], atol=1e-3)
    assert abs(int(r.iterations) - int(gold["iterations"])) <= 2


@pytest.mark.parametrize("variant", ["flat", "parallel_line_search"])
def test_port_variants_match_default(pendulum_pair, variant):
    """structured=False (autodiff of the flat transcription) and the
    chunked parallel line search take the same steps as the default
    structured, serial solve."""
    x0s, (_, rt) = pendulum_pair
    opts = options_from_jax(_pinned())
    if variant == "flat":
        from calipso_tpu_torch.models import pendulum

        prob = pendulum.swingup_problem(11, parametric_initial_state=True)
        ts = calipso_tpu_torch.TrajOptSolver(
            prob["objective"], prob["dynamics"], prob["num_states"], prob["num_actions"],
            equality=prob["equality"], parameters=prob["parameters"], options=opts,
            structured=False, device="cpu",
        )
        ts.initialize_states(prob["state_guess"])
    else:
        ts = pendulum_solver("torch", 11, opts.replace(line_search_mode="parallel"))
    rv = ts.batched().solve(parameters=torch.tensor(x0s))
    assert rv.state.solved.tolist() == rt.state.solved.tolist()
    assert rv.state.total_i.tolist() == rt.state.total_i.tolist()
    np.testing.assert_allclose(rv.state.p.x.numpy(), rt.state.p.x.numpy(), atol=1e-9, rtol=0)


def test_batched_nlp_matches_jax():
    """The general-NLP BatchedSolver on the friction-cone family of
    `tests/test_batch.py` (a 3-dimensional second-order cone, one equality
    row), B=8, in both packages."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    B = 8
    th = np.zeros((B, 4))
    th[:, 1:3] = rng.uniform(0.1, 10.0, size=(B, 2))
    th[:, 3] = rng.uniform(0.1, 1.0, size=B)
    x0 = rng.normal(size=(B, 3))
    common = dict(num_parameters=4, nonnegative_indices=[], second_order_indices=[[0, 1, 2]])
    tcommon = dict(common, device="cpu")
    jopts = _pinned()
    rj = calipso_tpu.BatchedSolver(
        lambda x, th: th[:3] @ x, lambda x, th: jnp.array([x[0] - th[3]]), lambda x, th: x, 3,
        options=jopts, **common,
    ).solve(jnp.asarray(x0), jnp.asarray(th))
    bt = calipso_tpu_torch.BatchedSolver(
        lambda x, th: th[:3] @ x, lambda x, th: x[:1] - th[3:], lambda x, th: x, 3,
        options=options_from_jax(jopts), **tcommon,
    )
    rt = bt.solve(torch.tensor(x0), torch.tensor(th))
    _assert_same_solves(rj, rt)
    assert bt.stats["host_syncs"] > 0


def test_solve_runs_backward_on_the_calling_thread():
    """The solve runs its oracles' backward passes on the calling thread
    (autograd's multithreading off inside the solve, restored after): with
    the device's worker thread beside it, the order in which a backward's
    nodes ran depended on what the process had run before, and so did the
    bits of a card batch's first Jacobian. The equality callable records
    the setting at every call, its derivatives' included."""
    seen = []

    def equality(x, th):
        seen.append(torch.autograd.is_multithreading_enabled())
        return x[:1] - th[3:]

    rng = np.random.default_rng(4)
    th = np.concatenate([np.zeros((2, 1)), rng.uniform(0.1, 10.0, (2, 2)), rng.uniform(0.1, 1.0, (2, 1))], axis=1)
    bt = calipso_tpu_torch.BatchedSolver(
        lambda x, th: th[:3] @ x, equality, lambda x, th: x, 3, num_parameters=4,
        nonnegative_indices=[], second_order_indices=[[0, 1, 2]],
        options=options_from_jax(_pinned()), device="cpu",
    )
    seen.clear()  # the calls that sized the problem
    res = bt.solve(torch.tensor(rng.normal(size=(2, 3))), torch.tensor(th))
    assert bool(res.state.solved.all()) and len(seen) > 10
    assert not any(seen)
    assert torch.autograd.is_multithreading_enabled()


def test_public_names_match_jax():
    assert sorted(calipso_tpu_torch.__all__) == sorted(calipso_tpu.__all__)


def test_single_solve_is_a_batch_of_one(pendulum_pair):
    x0s, (_, rt) = pendulum_pair
    ts = pendulum_solver("torch", 11, options_from_jax(_pinned()))
    ts.initialize_actions([np.zeros(1)] * 10)  # the guess's actions are already 0
    one = ts.solve(parameters=torch.tensor(x0s[3]))
    assert one.variables.shape == (ts.num_variables,)
    assert bool(one.solved) and int(one.iterations) == int(rt.state.total_i[3])
    np.testing.assert_allclose(one.variables.numpy(), rt.state.p.x[3].numpy(), atol=1e-9)
    states, actions = ts.get_trajectory(one)
    assert len(states) == 11 and len(actions) == 10
    np.testing.assert_allclose(states[0], x0s[3], atol=1e-4)  # the 1e-4 contract
    np.testing.assert_allclose(states[-1], [np.pi, 0.0], atol=1e-4)


def test_unported_paths_raise(monkeypatch, tmp_path):
    opts = calipso_tpu_torch.Options
    # spike is ported (tests/test_torch_spike.py, which also refuses a
    # horizon that does not split over the ranks): without a mesh it names
    # spike_mesh, and a spike_mesh that is not a parallel.mesh.Mesh is
    # refused
    with pytest.raises(ValueError, match="spike_mesh"):
        pendulum_solver("torch", 5, opts(linear_solver="spike"))
    with pytest.raises(TypeError, match="Mesh"):
        pendulum_solver("torch", 5, opts(spike_mesh=object()))
    # (the cr, ldl and lu backends, refinement_fallback and implicit
    # differentiation are ported: tests/test_torch_cr.py,
    # tests/test_torch_ldl.py and tests/test_torch_differentiate.py; so
    # are several right-hand sides on every backend, schur included)
    for ported in ("cr", "ldl", "lu"):
        assert pendulum_solver("torch", 5, opts(linear_solver=ported)).solver.options.linear_solver == ported
    pendulum_solver("torch", 5, opts(refinement_fallback=True))
    assert pendulum_solver("torch", 5, opts(differentiate=True)).solver.options.differentiate
    from calipso_tpu_torch.models import pendulum
    from calipso_tpu_torch.solver import kkt

    L = torch.eye(3, dtype=torch.float64).expand(2, 3, 3)
    fact = kkt.Factorization(L, None, torch.zeros(2, 0, 3), torch.zeros(2, 0, 3), None, None,
                             torch.ones(2), torch.zeros(2), torch.zeros(2))
    rhs = torch.arange(24, dtype=torch.float64).reshape(2, 3, 4)
    assert torch.equal(kkt.solve_sym(None, fact, rhs, 3, 0, 0, "schur"), rhs)

    prob = pendulum.swingup_problem(33)
    bts = pendulum_solver("torch", 5, opts()).batched()
    bs = calipso_tpu_torch.BatchedSolver(lambda x: x @ x, None, None, 2, device="cpu")
    # mesh= is ported (tests/test_torch_parallel.py); what is not a
    # parallel.mesh.Mesh is refused
    for call in (lambda: bts.solve(parameters=torch.zeros(2, 2), mesh=object()),
                 lambda: bs.solve(torch.zeros(2, 2), mesh=object())):
        with pytest.raises(TypeError, match="Mesh"):
            call()
    # aot_save / aot_load are ported (utils/aot.py: a manifest of the
    # kernel libraries; tests/test_torch_utils.py)
    for solver in (bts, bs):
        path = str(tmp_path / f"{type(solver).__name__}.json")
        assert solver.aot_save(path, 2) == path and solver.aot_load(path) is solver
    # without device=, every entry point solves on the card, and a
    # machine without one refuses rather than falling back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (
        lambda: calipso_tpu_torch.Solver(lambda x: x @ x, None, None, 2),
        lambda: calipso_tpu_torch.BatchedSolver(lambda x: x @ x, None, None, 2),
        lambda: calipso_tpu_torch.TrajOptSolver(
            prob["objective"], prob["dynamics"], prob["num_states"], prob["num_actions"]
        ),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
