"""The port's horizon-sharded block-tridiagonal solve (`ops/spike.py`) and
the "spike" KKT backend against the JAX package's, on the CPU in float64,
over P = 4 ranks.

One module-scoped launch of 4 CPU ranks (`parallel/mesh.launch`, gloo)
computes every case (`tests/torch_ranks.spike_cases`); each test below
asserts one of them. The JAX side runs on a 4-device sub-mesh of the 8
virtual CPU devices (`tests/conftest.py`), so that both packages split
the horizon the same way. The cases are those of `tests/test_spike.py`:
- `solve_sharded` at (T, d) = (16, 3), (32, 5), (64, 4) against the JAX
  package's `spike.solve_sharded` and a dense solve, to ATOL;
- against the port's own `rc.factor` / `rc.solve`;
- a horizon that does not split into 4 chunks of >= 2 stages (T = 10,
  and T = 4: chunks of one stage) is refused, by `solve_sharded` and
  when a solver is built;
- `factor_sharded` + `solve_fact` with one and with K = 4 right-hand
  sides;
- the collectives each of those calls takes on every rank;
- batch-first: B = 3 lanes, one of them not positive definite, whose
  `factors_finite` is False on every rank while the others solve;
- the full solves: the pendulum at horizon 16 on spike and on riccati in
  both packages, and with `equality_general` (the low-rank border): the
  same solved flags and iterations in all four, variables within
  FULL_ATOL (BORDER_ATOL on the border);
- `Options(differentiate=True)` on spike: the sensitivity of a 2-lane
  batch equals riccati's within SENS_ATOL.
Every rank returns the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from calipso_tpu.ops import spike as jspike
from calipso_tpu_torch import Options
from calipso_tpu_torch.ops import riccati as trc
from calipso_tpu_torch.parallel.mesh import launch
from tests import torch_ranks as tr
from tests.torch_parity import pendulum_solver

torch.set_num_threads(1)

ATOL = 1e-10
FULL_ATOL = 1e-8
BORDER_ATOL = 1e-7
SENS_ATOL = 1e-9
LAUNCH_S = 300.0


@pytest.fixture(scope="module")
def cases():
    return tr.spike_inputs()


@pytest.fixture(scope="module")
def ranks(cases):
    """Every rank's results of `tr.spike_cases`."""
    return launch(tr.spike_cases, tr.P, cases, axis="horizon", device="cpu", timeout=LAUNCH_S)


def _jax_mesh(axis):
    return Mesh(np.array(jax.devices()[: tr.P]), axis_names=(axis,))


def _tensors(v):
    if isinstance(v, dict):
        return list(v.values())
    return list(v) if isinstance(v, tuple) else [v]


def _same_on_every_rank(ranks, key):
    """The value of `key` (a tensor, or a tuple or dict of tensors), the
    same bits on every rank (NaN where rank 0 has NaN)."""
    first = ranks[0][key]
    for r in ranks[1:]:
        for a, b in zip(_tensors(first), _tensors(r[key]), strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=f"{key}: the ranks disagree")
    return first


def _dense_solve(S, b):
    return np.linalg.solve(S, b.reshape(S.shape[0], -1)).reshape(b.shape)


@pytest.mark.parametrize("T,d", tr.SPIKE_CASES)
def test_spike_matches_jax_and_dense(ranks, cases, T, d):
    D, O, S, b = cases[("dense", T, d)]
    x = _same_on_every_rank(ranks, ("dense", T, d)).numpy()
    mesh = _jax_mesh("stage")
    x_jax = jax.jit(lambda D, O, b: jspike.solve_sharded(D, O, b, mesh, "stage"))(D, O, b)
    assert np.abs(x - _dense_solve(S, b)).max() < ATOL
    assert np.abs(x - np.asarray(x_jax)).max() < ATOL


def test_spike_matches_riccati_sweep(ranks, cases):
    D, O, _, b = cases["sweep"]
    x = _same_on_every_rank(ranks, "sweep").numpy()
    L, M = trc.factor(torch.tensor(D)[None], torch.tensor(O)[None])
    x_rc = trc.solve(L, M, torch.tensor(b)[None])[0].numpy()
    assert np.abs(x - x_rc).max() < ATOL


@pytest.mark.parametrize("T", tr.BAD_SPLITS)
def test_spike_rejects_bad_split(ranks, T):
    """By `solve_sharded`, and by a solver built on spike at that horizon."""
    for r in ranks:
        assert "chunks" in r[("refused", T)]
        assert "chunks" in r[("refused_solver", T)]


def test_spike_factor_apply_multi_rhs(ranks, cases):
    D, O, S, b, bk = cases["multi"]
    ok, x, X = _same_on_every_rank(ranks, "multi")
    assert ok.tolist() == [True]
    mesh = _jax_mesh("stage")
    fact = jax.jit(lambda D, O: jspike.factor_sharded(D, O, mesh, "stage"))(D, O)
    solve = jax.jit(lambda f, b: jspike.solve_fact(f, b, mesh, "stage"))
    for got, rhs in ((x, b), (X, bk)):
        assert np.abs(got.numpy() - _dense_solve(S, rhs)).max() < ATOL
        assert np.abs(got.numpy() - np.asarray(solve(fact, jnp.asarray(rhs)))).max() < ATOL


def test_spike_collectives(ranks):
    """The collectives each call takes on every rank, each one staged
    through host memory: the factorization gathers its Schur pieces, the
    inertia test reduces its flags, and a solve gathers the separators'
    right-hand sides and then the chunks of x, one or K columns alike."""
    want = {"factor_sharded": 1, "factors_finite": 1, "solve_fact": 2, "solve_fact K": 2}
    assert [r["collectives"] for r in ranks] == [want] * tr.P


def test_spike_factors_finite_per_lane(ranks, cases):
    """Lane BAD_LANE's stage 9 (in rank 2's chunk) is not positive definite:
    every rank reads False for it alone, and the other lanes solve."""
    D, O, S, b = cases["batch"]
    ok, x = _same_on_every_rank(ranks, "batch")
    assert ok.tolist() == [lane != tr.BAD_LANE for lane in range(tr.LANES)]
    for lane in range(tr.LANES):
        if lane != tr.BAD_LANE:
            assert np.abs(x[lane].numpy() - _dense_solve(S[lane], b[lane])).max() < ATOL


def _jax_full_solve(horizon, opts, general):
    """tests/test_spike.py's full solves (`build`), in the JAX package."""
    from calipso_tpu import TrajOptSolver
    from calipso_tpu.models import pendulum

    goal = lambda x: x - jnp.array([np.pi, 0.0])
    kw = (
        dict(equality_general=lambda z, th: jnp.concatenate([z[0:2], goal(z[-2:])]))
        if general
        else dict(equality=[lambda x, u, w: x] + [None] * (horizon - 2) + [lambda x, u, w: goal(x)])
    )
    ts = TrajOptSolver(
        [lambda x, u, w: 0.01 * u @ u + 0.1 * (x[1] ** 2)] * (horizon - 1) + [lambda x, u, w: 0.1 * (x[1] ** 2)],
        [pendulum.discrete] * (horizon - 1),
        [2] * horizon,
        [1] * (horizon - 1),
        options=opts,
        **kw,
    )
    ts.initialize_states(pendulum.swingup_problem(horizon)["state_guess"])
    ts.initialize_actions([np.zeros(1)] * (horizon - 1))
    return ts.solve()


@pytest.mark.parametrize("general", [False, True], ids=["stage_equality", "equality_general"])
def test_spike_backend_full_solve(ranks, general):
    """The same iterate sequence in both packages on both backends."""
    from calipso_tpu import Options as JOptions

    horizon = tr.HORIZON_FULL
    sp = _same_on_every_rank(ranks, ("full", general))
    rc_t = tr.full_solver(horizon, Options(linear_solver="riccati"), general).solve()
    sp_j = _jax_full_solve(horizon, JOptions(linear_solver="spike", spike_mesh=_jax_mesh("horizon")), general)
    rc_j = _jax_full_solve(horizon, JOptions(linear_solver="riccati"), general)
    for r in (sp, rc_t, sp_j, rc_j):
        assert bool(r["solved"] if isinstance(r, dict) else r.solved)
    iterations = {int(sp["iterations"]), int(rc_t.iterations), int(sp_j.iterations), int(rc_j.iterations)}
    assert len(iterations) == 1, iterations
    atol = BORDER_ATOL if general else FULL_ATOL
    x = sp["variables"].numpy()
    for other in (rc_t.variables.numpy(), np.asarray(sp_j.variables), np.asarray(rc_j.variables)):
        np.testing.assert_allclose(x, other, atol=atol)


def test_spike_sensitivity_matches_riccati(ranks):
    solved, iterations, sens = _same_on_every_rank(ranks, "diff")
    ref = pendulum_solver("torch", tr.HORIZON_FULL, Options(linear_solver="riccati", differentiate=True)).batched().solve(
        parameters=torch.tensor(tr.diff_scenarios())
    )
    assert bool(solved.all()) and torch.equal(solved, ref.solved)
    assert torch.equal(iterations, ref.iterations)
    assert sens.shape == ref.sensitivity.shape
    assert (sens - ref.sensitivity).abs().max() < SENS_ATOL
