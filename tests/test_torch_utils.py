"""The port's utilities (`calipso_tpu_torch/utils/`) against the JAX
package's on the CPU in float64.

- `tests/test_utils.py`'s two tests in both packages: the checkpoint
  round trip and its warm start, and `iteration_stats` / `batch_stats`,
  each stat the reference's (counts and flags equal, violations and step
  sizes within STAT_RTOL).
- A point saved by either package's `save_point` loads in the other and
  warm-starts its solve in the iterations the saving package's own warm
  solve takes, to the same solution (SOLUTION_ATOL).
- `profiling.trace` writes a Chrome trace file on the CPU.
- The batched solvers' `aot_save` / `aot_load`: the manifest round-trips
  and the loaded solver solves as before; a manifest whose source hash or
  dtype differs, or whose library is missing, is refused, naming the
  field; the routes it records follow the backends. `cached_batched`
  (`tests/test_aot.py`'s keyed cache) hits and misses by its key, the
  environment included.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import calipso_tpu
import calipso_tpu_torch
from calipso_tpu.utils import checkpoint as jcheckpoint
from calipso_tpu.utils import profiling as jprofiling
from calipso_tpu_torch.utils import aot, checkpoint, profiling
from tests.torch_parity import pendulum_solver

torch.set_num_threads(1)

STAT_RTOL = 1e-8  # the same float64 arithmetic, up to summation order
SOLUTION_ATOL = 1e-8


def _qp(pkg, **opts):
    """tests/test_utils.py:test_checkpoint_warmstart's problem."""
    if pkg == "jax":
        return calipso_tpu.Solver(
            lambda x: (x[0] - 1.0) ** 2 + x[1] ** 2,
            lambda x: jnp.array([x[0] + x[1] - 1.0]),
            lambda x: x,
            2,
            options=calipso_tpu.Options(**opts),
        )
    return calipso_tpu_torch.Solver(
        lambda x: (x[0] - 1.0) ** 2 + x[1] ** 2,
        lambda x: torch.stack([x[0] + x[1] - 1.0]),
        lambda x: x,
        2,
        options=calipso_tpu_torch.Options(**opts),
        device="cpu",
    )


X0 = np.array([0.5, 0.5])


def _same_stats(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, float):
            assert got[k] == pytest.approx(w, rel=STAT_RTOL, abs=1e-15), k
        else:
            assert got[k] == w, k


def test_checkpoint_warmstart_matches_jax(tmp_path):
    """tests/test_utils.py:test_checkpoint_warmstart in both packages."""
    out = {}
    for pkg, ckpt, prof in (("jax", jcheckpoint, jprofiling), ("torch", checkpoint, profiling)):
        solver = _qp(pkg, warmstart=True)
        x0 = jnp.asarray(X0) if pkg == "jax" else torch.tensor(X0)
        res = solver.solve(x0)
        assert bool(res.solved)
        path = os.path.join(tmp_path, f"point-{pkg}.npz")
        ckpt.save_point(path, res.state.p)
        point = ckpt.load_point(path) if pkg == "jax" else ckpt.load_point(path, device="cpu")
        np.testing.assert_allclose(np.asarray(point.x), np.asarray(res.state.p.x))
        res2 = solver.solve(x0, warm=point)
        assert bool(res2.solved)
        assert int(res2.iterations) <= int(res.iterations)
        stats = prof.iteration_stats(res2.state)
        assert stats["solved"] and stats["residual_violation"] < 1e-4
        assert stats["lu_fallbacks"] == 0
        out[pkg] = (int(res.iterations), stats, np.asarray(res2.variables))
    assert out["torch"][0] == out["jax"][0]
    _same_stats(out["torch"][1], out["jax"][1])
    np.testing.assert_allclose(out["torch"][2], out["jax"][2], rtol=0, atol=SOLUTION_ATOL)


def test_batch_stats_match_jax():
    """tests/test_utils.py:test_batch_stats in both packages."""
    rng = np.random.default_rng(0)
    B = 8
    x0, th = rng.uniform(0.2, 0.8, size=(B, 2)), rng.uniform(0.5, 2.0, size=(B, 1))
    jbs = calipso_tpu.BatchedSolver(
        lambda x, th: (x[0] - th[0]) ** 2 + x[1] ** 2,
        lambda x, th: jnp.array([x[0] + x[1] - 1.0]),
        lambda x, th: x,
        2,
        num_parameters=1,
    )
    tbs = calipso_tpu_torch.BatchedSolver(
        lambda x, th: (x[0] - th[0]) ** 2 + x[1] ** 2,
        lambda x, th: torch.stack([x[0] + x[1] - 1.0]),
        lambda x, th: x,
        2,
        num_parameters=1,
        device="cpu",
    )
    want = jprofiling.batch_stats(jbs.solve(jnp.asarray(x0), jnp.asarray(th)).state)
    res = tbs.solve(torch.tensor(x0), torch.tensor(th))
    stats = profiling.batch_stats(res.state)
    assert stats["solved"] == B and stats["failed"] == 0
    assert stats["iterations_max"] >= stats["iterations_mean"] > 0
    assert 0.0 <= stats["lockstep_waste"] < 1.0
    _same_stats(stats, want)
    # one lane's iteration stats are the lane's own
    lane = profiling.iteration_stats(res.state, lane=3)
    assert lane["total_iterations"] == int(res.state.total_i[3]) and lane["solved"]


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_checkpoint_crosses_packages(tmp_path, saver):
    """A point saved by one package warm-starts the other's solve in the
    saving package's own warm-solve iterations, to the same solution."""
    path = os.path.join(tmp_path, "point.npz")
    solvers = {pkg: _qp(pkg, warmstart=True) for pkg in ("jax", "torch")}
    x0 = {"jax": jnp.asarray(X0), "torch": torch.tensor(X0)}
    first = solvers[saver].solve(x0[saver])
    (jcheckpoint if saver == "jax" else checkpoint).save_point(path, first.state.p)
    warm = {
        "jax": solvers["jax"].solve(x0["jax"], warm=jcheckpoint.load_point(path)),
        "torch": solvers["torch"].solve(x0["torch"], warm=checkpoint.load_point(path, device="cpu")),
    }
    assert bool(warm["jax"].solved) and bool(warm["torch"].solved)
    assert int(warm["torch"].iterations) == int(warm["jax"].iterations)
    np.testing.assert_allclose(
        warm["torch"].variables.numpy(), np.asarray(warm["jax"].variables), rtol=0, atol=SOLUTION_ATOL
    )
    loaded = checkpoint.load_point(path, device="cpu", dtype=torch.float32)
    assert loaded.x.dtype == torch.float32 and loaded.x.shape == (2,)


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = os.path.join(tmp_path, "trace")
    solver = _qp("torch")
    with profiling.trace(log_dir) as prof:
        assert bool(solver.solve(torch.tensor(X0)).solved)
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert len(prof.key_averages()) > 0


def test_host_callbacks_supported():
    from calipso_tpu_torch.utils import host_callbacks_supported

    assert host_callbacks_supported() is True


def test_aot_manifest_round_trips(tmp_path):
    """tests/test_aot.py's round trip: the loaded solver gives the same
    solves (the same eager program); the manifest names its routes."""
    ts = pendulum_solver("torch", 5, calipso_tpu_torch.Options())
    bts = ts.batched()
    B = 4
    th = torch.tensor(0.2 * np.random.default_rng(0).normal(size=(B, 2)))
    ref = bts.solve(parameters=th)
    path = str(tmp_path / "pendulum.json")
    assert bts.aot_save(path, B) == path
    with open(path) as f:
        m = json.load(f)
    assert m["shapes"]["batch"] == B and m["dtype"] == "float64" and m["device"] == "cpu"
    assert m["routes"] == {"linear_solver": "schur", "t1": "kernel", "kernel_sources": ["riccati_t1"]}
    assert m["libraries"] == {}  # the CPU runs the plain versions: nothing built
    assert m["sources"] == aot.source_hash()
    bts2 = pendulum_solver("torch", 5, calipso_tpu_torch.Options()).batched()
    assert bts2.aot_load(path) is bts2
    got = bts2.solve(parameters=th)
    assert bool(got.state.solved.all())
    assert torch.equal(got.state.p.x, ref.state.p.x) and torch.equal(got.state.total_i, ref.state.total_i)


@pytest.mark.parametrize(
    "field,edit",
    [
        ("sources", lambda m: m.update(sources="0" * 64)),
        ("dtype", lambda m: m.update(dtype="float32")),
        ("options", lambda m: m["options"].update(linear_solver="'riccati'")),
        ("environment", lambda m: m["environment"].update(CALIPSO_ROUTE="stream")),
        ("libraries", lambda m: m.update(libraries={"riccati_t1": "0123456789abcdef/libriccati_t1.so"})),
    ],
)
def test_aot_load_refuses_a_stale_manifest(tmp_path, field, edit):
    bts = pendulum_solver("torch", 5, calipso_tpu_torch.Options()).batched()
    path = str(tmp_path / "pendulum.json")
    bts.aot_save(path, 4)
    with open(path) as f:
        m = json.load(f)
    edit(m)
    with open(path, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match=f": {field} differs"):
        bts.aot_load(path)


def test_aot_load_refuses_another_dtype_or_a_missing_library(tmp_path, monkeypatch):
    bts = pendulum_solver("torch", 5, calipso_tpu_torch.Options()).batched()
    path = str(tmp_path / "pendulum.json")
    bts.aot_save(path, 4)
    with pytest.raises(ValueError, match=": dtype differs"):
        bts.aot_load(path, dtype=torch.float32)
    # a card's manifest whose library is not in the build cache
    from calipso_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    m = aot.manifest(bts, 4, None, torch.float64)
    m["libraries"] = {"riccati_t1": "0123456789abcdef/libriccati_t1.so"}
    monkeypatch.setattr(aot, "manifest", lambda *a: dict(m))
    with open(path, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="library riccati_t1 missing"):
        bts.aot_load(path)


def test_cached_batched_key_changes_with_fingerprint(tmp_path, monkeypatch):
    """tests/test_aot.py's test of the keyed cache in the port: the first
    call misses and writes the manifest, the second hits, another
    fingerprint misses; a changed CALIPSO_* variable misses too (the
    port's key holds the environment); CALIPSO_AOT_CACHE=0 gives the
    solver's solve uncached and writes nothing; the callables solve
    alike."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.delenv("CALIPSO_AOT_CACHE", raising=False)
    monkeypatch.delenv("CALIPSO_TEST_TOGGLE", raising=False)
    bts = pendulum_solver("torch", 5, calipso_tpu_torch.Options()).batched()
    B = 4
    cache = tmp_path / "calipso_tpu_torch" / "aot"
    fn1, cached1 = aot.cached_batched(bts, "t", "fp-a", B)
    assert not cached1 and len(list(cache.iterdir())) == 1
    fn2, cached2 = aot.cached_batched(bts, "t", "fp-a", B)
    assert cached2
    fn3, cached3 = aot.cached_batched(bts, "t", "fp-b", B)
    assert not cached3 and len(list(cache.iterdir())) == 2
    monkeypatch.setenv("CALIPSO_TEST_TOGGLE", "1")
    assert aot.cached_batched(bts, "t", "fp-a", B)[1] is False
    assert aot.cached_batched(bts, "t", "fp-a", B)[1] is True
    assert len(list(cache.iterdir())) == 3
    monkeypatch.setenv("CALIPSO_AOT_CACHE", "0")
    fn0, cached0 = aot.cached_batched(bts, "t", "fp-c", B)
    assert fn0 == bts.solve and not cached0 and len(list(cache.iterdir())) == 3
    th = torch.tensor(0.2 * np.random.default_rng(1).normal(size=(B, 2)))
    r1, r2 = fn1(parameters=th), fn2(parameters=th)
    assert bool(r1.state.solved.all())
    assert torch.equal(r1.state.p.x, r2.state.p.x)


def test_aot_routes_follow_the_backends():
    """The routes (and kernel sources) the manifest records, per backend:
    riccati at the rocket's d=9 (lanes), with a differentiated border
    problem's K columns on the stream sweeps; cr and ldl no kernel; schur
    at n=131 the T=1 kernels, past n=192 in float64 the library route."""
    from calipso_tpu_torch.solver.solve import resolve_options

    def routes(ts, dtype=torch.float64, **kw):
        fns = ts.solver.fns
        return aot.routes(fns, resolve_options(ts.solver.options.replace(**kw), fns), fns.dims.parameters, dtype)

    ts = pendulum_solver("torch", 11, calipso_tpu_torch.Options(linear_solver="riccati"))
    assert routes(ts) == {"linear_solver": "riccati", "block": "lanes", "kernel_sources": ["riccati_lanes"]}
    assert routes(ts, differentiate=True) == {
        "linear_solver": "riccati", "block": "lanes", "multi": "stream",
        "kernel_sources": ["riccati_lanes", "riccati_stream"],
    }
    assert routes(ts, linear_solver="cr") == {"linear_solver": "cr", "kernel_sources": []}
    assert routes(ts, linear_solver="ldl") == {"linear_solver": "ldl", "kernel_sources": []}
    wide = pendulum_solver("torch", 44, calipso_tpu_torch.Options(linear_solver="schur"))
    assert routes(wide) == {"linear_solver": "schur", "t1": "kernel", "kernel_sources": ["riccati_t1"]}
    wider = pendulum_solver("torch", 65, calipso_tpu_torch.Options(linear_solver="schur"))
    assert wider.num_variables == 194
    assert routes(wider) == {"linear_solver": "schur", "t1": "library", "kernel_sources": []}
    assert routes(wider, torch.float32) == {"linear_solver": "schur", "t1": "kernel", "kernel_sources": ["riccati_t1"]}


def test_batched_solver_aot_round_trip(tmp_path):
    """tests/test_aot.py:test_batched_solver_aot_round_trip in the port."""

    def build():
        return calipso_tpu_torch.BatchedSolver(
            lambda x, th: (x - th) @ (x - th),
            lambda x, th: x[:1] - 0.5,
            None,
            3,
            num_parameters=3,
            device="cpu",
        )

    bs = build()
    B = 4
    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.normal(size=(B, 3)))
    th = torch.tensor(0.1 * rng.normal(size=(B, 3)))
    ref = bs.solve(x0, th)
    path = str(tmp_path / "nlp.json")
    bs.aot_save(path, B, dtype=x0.dtype)
    bs2 = build().aot_load(path)
    got = bs2.solve(x0, th)
    np.testing.assert_allclose(got.state.p.x.numpy(), ref.state.p.x.numpy(), rtol=1e-6, atol=1e-8)
