"""The port's main path end to end against the JAX package on the CPU in
float64: batched trajopt solves through `TrajOptSolver(...).batched()
.solve(parameters=x0s)` in both packages, on the benchmark flagship's
pendulum (T=11, B=8) and the `__graft_entry__.py` cartpole (T=21, B=4,
n=104, so `linear_solver="schur"` is pinned: "auto" would pick riccati).
The line-search mode is pinned to "serial" in both packages.

Each lane must reach the same solved flag in the same number of
iterations, with solutions within 1e-6 (the pendulum is not a contact
problem, so iteration counts must agree exactly, not within a band)."""

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
            structured=False,
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
    jopts = _pinned()
    rj = calipso_tpu.BatchedSolver(
        lambda x, th: th[:3] @ x, lambda x, th: jnp.array([x[0] - th[3]]), lambda x, th: x, 3,
        options=jopts, **common,
    ).solve(jnp.asarray(x0), jnp.asarray(th))
    bt = calipso_tpu_torch.BatchedSolver(
        lambda x, th: th[:3] @ x, lambda x, th: x[:1] - th[3:], lambda x, th: x, 3,
        options=options_from_jax(jopts), **common,
    )
    rt = bt.solve(torch.tensor(x0), torch.tensor(th))
    _assert_same_solves(rj, rt)
    assert bt.stats["host_syncs"] > 0


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


def test_unported_paths_raise():
    opts = calipso_tpu_torch.Options
    for bad in (
        opts(differentiate=True),
        opts(refinement_fallback=True),
        opts(linear_solver="riccati"),
        opts(linear_solver="ldl"),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pendulum_solver("torch", 5, bad)
    # "auto" on a trajopt problem with n > 96 resolves to riccati
    with pytest.raises(NotImplementedError, match="riccati"):
        cartpole_solver("torch", 21, opts())
    bts = pendulum_solver("torch", 5, opts()).batched()
    bs = calipso_tpu_torch.BatchedSolver(lambda x: x @ x, None, None, 2)
    for call in (lambda: bts.aot_save("x", 2), lambda: bts.aot_load("x"),
                 lambda: bts.solve(parameters=torch.zeros(2, 2), mesh=object()),
                 lambda: bs.aot_save("x", 2), lambda: bs.solve(torch.zeros(2, 2), mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
