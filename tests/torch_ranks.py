"""What the port's multi-rank tests run on each rank (`parallel/mesh.launch`
pickles these functions by name, so they live in a module that imports
torch and never JAX: a spawned rank imports this module and nothing of
the test file), and the problems both the ranks and the test processes
build. Every input comes from a numpy seed, the same on every rank."""

import math

import numpy as np
import torch

from calipso_tpu_torch import BatchedSolver, Options, TrajOptSolver
from calipso_tpu_torch.models import pendulum
from calipso_tpu_torch.ops import spike
from calipso_tpu_torch.parallel import dryrun
from tests.torch_parity import pendulum_solver

torch.set_num_threads(1)

P = 4  # ranks of the module-scoped launches
SPIKE_CASES = ((16, 3), (32, 5), (64, 4))  # tests/test_spike.py:39-47
SWEEP_CASE = (24, 4, 3)  # T, d, seed (tests/test_spike.py:50-58)
MULTI_CASE = (16, 3, 4, 11)  # T, d, K, seed (tests/test_spike.py:69-86)
BAD_SPLITS = (10, 4)  # horizons that do not split into 4 chunks of >= 2 stages
LANES, BAD_LANE = 3, 1  # the batch-first case: one lane not positive definite
HORIZON_FULL = 16  # the full solves (tests/test_spike.py:89-159)
DIFF_LANES = 2
# the spike calls whose collectives `spike_cases` counts, in its order
COLLECTIVES = ("factor_sharded", "factors_finite", "solve_fact", "solve_fact K")


def random_spd_tridiag(rng, T, d, shift=6.0):
    """tests/test_spike.py's `_random_spd_tridiag` in numpy: (D (T, d, d),
    O (T-1, d, d), the dense S)."""
    O = rng.normal(size=(T - 1, d, d))
    D = np.stack([(lambda A: A @ A.T + shift * np.eye(d))(rng.normal(size=(d, d))) for _ in range(T)])
    n = T * d
    S = np.zeros((n, n))
    for t in range(T):
        S[t * d : (t + 1) * d, t * d : (t + 1) * d] = D[t]
    for t in range(T - 1):
        S[(t + 1) * d : (t + 2) * d, t * d : (t + 1) * d] = O[t]
        S[t * d : (t + 1) * d, (t + 1) * d : (t + 2) * d] = O[t].T
    w = np.linalg.eigvalsh(S).min()
    if w < 0.5:
        S += (0.5 - w) * np.eye(n)
        D = D + (0.5 - w) * np.eye(d)[None]
    return D, O, S


def spike_inputs():
    """Every block-tridiagonal case of tests/test_torch_spike.py, in numpy."""
    cases = {}
    for T, d in SPIKE_CASES:
        rng = np.random.default_rng(T + d)
        D, O, S = random_spd_tridiag(rng, T, d)
        cases[("dense", T, d)] = (D, O, S, rng.normal(size=(T, d)))
    T, d, seed = SWEEP_CASE
    rng = np.random.default_rng(seed)
    D, O, S = random_spd_tridiag(rng, T, d)
    cases["sweep"] = (D, O, S, rng.normal(size=(T, d)))
    T, d, K, seed = MULTI_CASE
    rng = np.random.default_rng(seed)
    D, O, S = random_spd_tridiag(rng, T, d)
    cases["multi"] = (D, O, S, rng.normal(size=(T, d)), rng.normal(size=(T, d, K)))
    rng = np.random.default_rng(5)
    lanes = [random_spd_tridiag(rng, 16, 3) for _ in range(LANES)]
    D = np.stack([c[0] for c in lanes])
    D[BAD_LANE, 9] = -D[BAD_LANE, 9]  # a stage of rank 2's chunk
    cases["batch"] = (D, np.stack([c[1] for c in lanes]), np.stack([c[2] for c in lanes]), rng.normal(size=(LANES, 16, 3)))
    return cases


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def full_solver(horizon, options, general=False):
    """tests/test_spike.py's pendulum swing-up at `horizon` in the port (on
    the CPU): its boundary conditions as stage equalities, or with
    `general` as one `equality_general`."""
    goal = lambda x: torch.stack([x[0] - math.pi, x[1]])
    kw = (
        dict(equality_general=lambda z, th: torch.cat([z[0:2], goal(z[-2:])]))
        if general
        else dict(equality=[lambda x, u, w: x] + [None] * (horizon - 2) + [lambda x, u, w: goal(x)])
    )
    ts = TrajOptSolver(
        [lambda x, u, w: 0.01 * u @ u + 0.1 * (x[1] ** 2)] * (horizon - 1) + [lambda x, u, w: 0.1 * (x[1] ** 2)],
        [pendulum.discrete] * (horizon - 1),
        [2] * horizon,
        [1] * (horizon - 1),
        options=options,
        device="cpu",
        **kw,
    )
    ts.initialize_states(pendulum.swingup_problem(horizon)["state_guess"])
    ts.initialize_actions([np.zeros(1)] * (horizon - 1))
    return ts


def diff_scenarios():
    """The initial states of the differentiated spike batch."""
    return 0.2 * np.random.default_rng(7).normal(size=(DIFF_LANES, 2))


def solve_summary(r):
    return {"solved": r.solved, "iterations": r.iterations, "variables": r.variables}


def spike_cases(mesh, cases):
    """Every spike case of tests/test_torch_spike.py on this rank."""
    out = {}
    for key, (D, O, _, b) in ((k, v) for k, v in cases.items() if isinstance(k, tuple)):
        out[key] = spike.solve_sharded(_t(D)[None], _t(O)[None], _t(b)[None], mesh)[0]
    D, O, _, b = cases["sweep"]
    out["sweep"] = spike.solve_sharded(_t(D)[None], _t(O)[None], _t(b)[None], mesh)[0]
    for T in BAD_SPLITS:
        D, O, _, b = cases[("dense", 16, 3)]
        try:
            spike.solve_sharded(_t(D[:T])[None], _t(O[: T - 1])[None], _t(b[:T])[None], mesh)
        except ValueError as e:
            out[("refused", T)] = str(e)
        try:
            pendulum_solver("torch", T, Options(linear_solver="spike", spike_mesh=mesh, spike_axis=mesh.axis))
        except ValueError as e:
            out[("refused_solver", T)] = str(e)
    D, O, _, b, bk = cases["multi"]
    counts = [mesh.collectives]
    fact = spike.factor_sharded(_t(D)[None], _t(O)[None], mesh)
    counts.append(mesh.collectives)
    multi = [spike.factors_finite(fact)]
    counts.append(mesh.collectives)
    for rhs in (_t(b)[None], _t(bk)[None]):
        multi.append(spike.solve_fact(fact, rhs)[0])
        counts.append(mesh.collectives)
    out["multi"] = tuple(multi)
    out["collectives"] = dict(zip(COLLECTIVES, np.diff(counts).tolist(), strict=True))
    D, O, _, b = cases["batch"]
    fact = spike.factor_sharded(_t(D), _t(O), mesh)
    out["batch"] = (spike.factors_finite(fact), spike.solve_fact(fact, _t(b)))

    spike_opts = dict(linear_solver="spike", spike_mesh=mesh, spike_axis=mesh.axis)
    for general in (False, True):
        out[("full", general)] = solve_summary(full_solver(HORIZON_FULL, Options(**spike_opts), general).solve())
    res = pendulum_solver("torch", HORIZON_FULL, Options(differentiate=True, **spike_opts)).batched().solve(
        parameters=_t(diff_scenarios())
    )
    out["diff"] = (res.solved, res.iterations, res.sensitivity)
    return out


def friction_batched():
    """tests/test_batch.py's friction-cone family in the port (on the CPU)."""
    return BatchedSolver(
        lambda x, th: th[:3] @ x,
        lambda x, th: (x[0] - th[3]).reshape(1),
        lambda x, th: x,
        3,
        num_parameters=4,
        nonnegative_indices=[],
        second_order_indices=[[0, 1, 2]],
        device="cpu",
    )


def friction_scenarios(B, seed):
    rng = np.random.default_rng(seed)
    thetas = np.zeros((B, 4))
    thetas[:, 1] = rng.uniform(0.1, 10.0, B)
    thetas[:, 2] = rng.uniform(0.1, 10.0, B)
    thetas[:, 3] = rng.uniform(0.1, 1.0, B)
    return rng.normal(size=(B, 3)), thetas


def swingup_batched(**opt_kw):
    """tests/test_batch.py's `_swingup_trajopt` in the port (riccati pinned;
    on the CPU), batched."""
    prob = pendulum.swingup_problem(horizon=11, parametric_initial_state=True)
    kw = {k: v for k, v in prob.items() if k not in ("state_guess", "state_initial", "state_goal")}
    ts = TrajOptSolver(options=Options(linear_solver="riccati", **opt_kw), device="cpu", **kw)
    xg = np.array([np.pi, 0.0])
    ts.initialize_states([xg * t / 10 for t in range(11)])
    return ts.batched()


def swingup_scenarios(B, seed):
    return 0.2 * np.random.default_rng(seed).normal(size=(B, 2))


def batch_cases(mesh):
    """The sharded batches of tests/test_torch_parallel.py on this rank,
    and the dry run."""
    before = mesh.collectives
    out = {"trajopt": swingup_batched().solve(parameters=_t(swingup_scenarios(16, 0)), mesh=mesh)}
    out["trajopt_collectives"] = mesh.collectives - before
    x0, th = friction_scenarios(16, 1)
    out["friction"] = friction_batched().solve(_t(x0), _t(th), mesh=mesh, axis=mesh.axis)
    warm = swingup_batched(warmstart=True)
    x0s = _t(swingup_scenarios(8, 2))
    res = warm.solve(parameters=x0s, mesh=mesh)
    out["warm"] = (res, warm.solve(parameters=x0s, guess=res.state.p.x, warm=res.state.p, mesh=mesh))
    for key, call in (
        ("uneven", lambda: swingup_batched().solve(parameters=_t(swingup_scenarios(6, 0)), mesh=mesh)),
        ("other_axis", lambda: friction_batched().solve(_t(x0), _t(th), mesh=mesh, axis="horizon")),
    ):
        try:
            call()
        except ValueError as e:
            out[key] = str(e)
    out["dryrun"] = dryrun.dryrun(mesh)
    return out


def raise_on_rank_one(mesh):
    """Rank 1 raises; the others wait in a collective it never joins."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return mesh.all_gather(torch.zeros(1))
