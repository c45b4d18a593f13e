"""The port's batch sharding (`BatchedTrajOptSolver.solve` and
`BatchedSolver.solve` with `mesh=`), its launcher (`parallel/mesh.py`)
and its multi-rank dry run (`parallel/dryrun.py`) against the JAX
package, on the CPU in float64.

One module-scoped launch of 4 CPU ranks (`tests/torch_ranks.batch_cases`)
computes, on every rank:
- the twins of `tests/test_batch.py`'s sharded batches: the riccati
  pendulum at B = 16 and the friction-cone scenarios at B = 16, each
  gathered result equal to the port's unsharded solve and to the JAX
  package's within ATOL, the same bits on every rank, the trajopt batch
  gathering its result in one all_gather a dtype;
- a sharded warm carry (the twin of `test_batched_trajopt_warm_carry`);
- the refusals that need a mesh: a batch that does not split into 4, and
  an `axis=` that is not the mesh's;
- the dry run (`dryrun.dryrun`), whose loss and gradient equal the JAX
  package's unsharded (vmapped) computation of the same 8 scenarios
  within DRYRUN_RTOL, whose spike solve takes the JAX package's riccati
  iterations, and whose 4 contact lanes all solve.
Outside the launch: a `mesh=` that is not a `Mesh` is refused, and a rank
that raises makes `launch` fail well inside its deadline. Marked `slow`,
as the reference marks its own: the dry run at 8 ranks, and the
two-process twin of `tests/test_multihost.py` (two `python` processes with
torchrun's environment, `tests/torch_multihost_worker.py`).
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from calipso_tpu_torch.parallel import dryrun
from calipso_tpu_torch.parallel.mesh import launch
from tests import torch_ranks as tr

torch.set_num_threads(1)

ATOL = 1e-10
WARM_ATOL = 1e-3  # tests/test_batch.py:test_batched_trajopt_warm_carry
DRYRUN_RTOL = 1e-9
LAUNCH_S = 300.0
RAISE_DEADLINE_S = 60.0  # the deadline of the launch whose rank raises
RAISE_WITHIN_S = 30.0  # how soon that launch must fail
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_multihost_worker.py")


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results of `tr.batch_cases`."""
    return launch(tr.batch_cases, tr.P, axis="batch", device="cpu", timeout=LAUNCH_S)


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _same_on_every_rank(ranks, key):
    """The value of `key` (a result tree), the same bits on every rank."""
    for r in ranks[1:]:
        for a, b in zip(_tensors(ranks[0][key]), _tensors(r[key]), strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=f"{key}: the ranks disagree")
    return ranks[0][key]


def _jax_swingup(**opt_kw):
    from tests.test_batch import _swingup_trajopt

    return _swingup_trajopt(**opt_kw).batched()


def test_sharded_trajopt_riccati(ranks):
    res = _same_on_every_rank(ranks, "trajopt")
    x0s = tr.swingup_scenarios(16, 0)
    ref = tr.swingup_batched().solve(parameters=torch.tensor(x0s))
    ref_j = _jax_swingup().solve(parameters=jnp.asarray(x0s))
    assert bool(res.state.solved.all())
    assert torch.equal(res.state.total_i, ref.state.total_i)
    np.testing.assert_array_equal(res.state.total_i.numpy(), np.asarray(ref_j.state.total_i))
    for other in (ref.state.p.x.numpy(), np.asarray(ref_j.state.p.x)):
        np.testing.assert_allclose(res.state.p.x.numpy(), other, rtol=0, atol=ATOL)


def test_sharded_batch_gathers_once_a_dtype(ranks):
    """The sharded solve meets the other ranks only to gather its result:
    one all_gather for each dtype of the SolveResult."""
    dtypes = {t.dtype for t in _tensors(ranks[0]["trajopt"])}
    assert [r["trajopt_collectives"] for r in ranks] == [len(dtypes)] * tr.P


def test_sharded_batch(ranks):
    from tests.test_batch import _make_batched, _scenarios

    res = _same_on_every_rank(ranks, "friction")
    x0, th = tr.friction_scenarios(16, 1)
    ref = tr.friction_batched().solve(torch.tensor(x0), torch.tensor(th))
    x0_j, th_j = _scenarios(16, np.random.default_rng(1))
    np.testing.assert_array_equal(np.asarray(x0_j), x0)
    ref_j = _make_batched().solve(x0_j, th_j)
    assert bool(res.state.solved.all())
    assert torch.equal(res.state.total_i, ref.state.total_i)
    for other in (ref.state.p.x.numpy(), np.asarray(ref_j.state.p.x)):
        np.testing.assert_allclose(res.state.p.x.numpy(), other, rtol=0, atol=ATOL)


def test_sharded_warm_carry(ranks):
    """A sharded MPC-style warm carry: the second sharded solve starts from
    the first's per-lane solutions and duals and reconverges to them, as
    the unsharded carry does."""
    res, res2 = _same_on_every_rank(ranks, "warm")
    x0s = torch.tensor(tr.swingup_scenarios(8, 2))
    warm = tr.swingup_batched(warmstart=True)
    ref = warm.solve(parameters=x0s)
    ref2 = warm.solve(parameters=x0s, guess=ref.state.p.x, warm=ref.state.p)
    for got, want in ((res, ref), (res2, ref2)):
        assert bool(got.state.solved.all())
        assert torch.equal(got.state.total_i, want.state.total_i)
        np.testing.assert_allclose(got.state.p.x.numpy(), want.state.p.x.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(res2.state.p.x.numpy(), res.state.p.x.numpy(), atol=WARM_ATOL)


def test_mesh_refusals(ranks):
    for r in ranks:
        assert "does not split evenly" in r["uneven"]
        assert "not the axis of the mesh" in r["other_axis"]
    bts = tr.swingup_batched()
    bs = tr.friction_batched()
    x0, th = tr.friction_scenarios(4, 0)
    for call in (
        lambda: bts.solve(parameters=torch.zeros(4, 2, dtype=torch.float64), mesh=object()),
        lambda: bs.solve(torch.tensor(x0), torch.tensor(th), mesh=[torch.device("cpu")] * 2),
    ):
        with pytest.raises(TypeError, match="Mesh"):
            call()


def _jax_pendulum(horizon, equality, options, parameters=None):
    """__graft_entry__.dryrun_multichip's pendulum problems, in the JAX
    package."""
    from calipso_tpu import TrajOptSolver

    def pend_d(y, x, u):
        m = 0.5 * (x + y)
        f = jnp.array([m[1], u[0] / 0.25 - 9.81 * jnp.sin(m[0]) / 0.5 - 0.1 * m[1] / 0.25])
        return y - (x + 0.05 * f)

    return TrajOptSolver(
        [lambda x, u, w: 0.1 * x @ x + 0.1 * u @ u] * (horizon - 1) + [lambda x, u, w: 10.0 * x @ x],
        [pend_d] * (horizon - 1),
        [dryrun.NX] * horizon,
        [1] * (horizon - 1),
        equality=[equality] + [None] * (horizon - 1),
        parameters=parameters,
        options=options,
    )


def _jax_dryrun_batch(B):
    """The dry run's part 1, unsharded: the loss and gradient of the B
    scenarios of `dryrun.batch_scenarios`, vmapped."""
    from calipso_tpu import Options
    from calipso_tpu.solver.api import solve_fn

    H = dryrun.HORIZON_BATCH
    ts = _jax_pendulum(
        H, lambda x, u, w: x - w, Options(differentiate=True),
        parameters=[np.zeros(dryrun.NX)] + [np.zeros(0)] * (H - 1),
    )
    run = solve_fn(ts.solver.fns, ts.solver.layout, ts.solver.options)
    nvar = ts.num_variables
    guess = jnp.zeros((nvar,))
    res = jax.jit(jax.vmap(lambda th: run(guess, th)))(jnp.asarray(dryrun.batch_scenarios(B)))
    xs = res.state.p.x
    loss = float(jnp.sum(xs**2) / B)
    grad = np.asarray(jnp.einsum("bi,bip->p", 2.0 * xs, res.sensitivity[:, :nvar, :]) / B)
    return loss, grad, int(jnp.sum(res.state.solved))


def _jax_riccati_iterations(horizon):
    """The dry run's part 2 on riccati, in the JAX package."""
    from calipso_tpu import Options

    ts = _jax_pendulum(horizon, lambda x, u, w: x - jnp.array([0.3, 0.0]), Options(linear_solver="riccati"))
    ts.initialize_states([np.zeros(dryrun.NX)] * horizon)
    return int(ts.solve().iterations)


def _check_dryrun(results, n):
    out = results[0]
    for r in results[1:]:
        assert torch.equal(r["loss"], out["loss"]) and torch.equal(r["grad"], out["grad"])
        assert r["spike_iters"] == out["spike_iters"] and r["contact_iters"] == out["contact_iters"]
    loss, grad, solved = _jax_dryrun_batch(2 * n)
    np.testing.assert_allclose(float(out["loss"]), loss, rtol=DRYRUN_RTOL, atol=0)
    np.testing.assert_allclose(out["grad"].numpy(), grad, rtol=DRYRUN_RTOL, atol=0)
    assert out["batch_solved"] == solved == out["batch"] == 2 * n
    assert out["spike_solved"] and out["spike_iters"] == out["riccati_iters"] == _jax_riccati_iterations(2 * n)
    assert out["contact_solved"] == out["contact_lanes"] == n
    print(dryrun.summary(n, out))


def test_dryrun_four_ranks(ranks):
    _check_dryrun([r["dryrun"] for r in ranks], tr.P)


@pytest.mark.slow
def test_dryrun_eight_ranks():
    _check_dryrun(launch(dryrun.dryrun, 8, axis="batch", device="cpu", timeout=LAUNCH_S), 8)


def test_a_rank_that_raises_fails_the_launch():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch(tr.raise_on_rank_one, 2, device="cpu", timeout=RAISE_DEADLINE_S)
    assert time.monotonic() - t0 < RAISE_WITHIN_S


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_psum_batch_axis():
    """Two processes with torchrun's environment, one mesh across them: the
    same loss bits on both, and 16/16 solved."""
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE="2")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(env, RANK=str(rank)),
        )
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=LAUNCH_S)
            outs.append(out)
            assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for out in outs:
        lines = [l for l in out.splitlines() if l.startswith("MULTIHOST_RESULT ")]
        assert lines, f"no result line in:\n{out[-3000:]}"
        results.append(json.loads(lines[-1].split(" ", 1)[1]))
    r0, r1 = sorted(results, key=lambda r: r["pid"])
    assert r0["n_processes"] == r1["n_processes"] == 2
    assert r0["solved"] == r0["batch"] == r1["solved"] == 16
    assert r0["loss"] == r1["loss"] and r0["grad_norm"] == r1["grad_norm"]
    assert np.isfinite(r0["loss"]) and np.isfinite(r0["grad_norm"])
