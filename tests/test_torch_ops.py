"""The port's ops against the JAX package on the CPU in float64: the T=1
Cholesky factor and substitution (plain versions of the CUDA kernels)
against the interpret-mode Pallas kernels they replace, the cone algebra,
the norms, and the rule that the port imports no JAX."""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calipso_tpu.ops import cones as jcones
from calipso_tpu.ops import pallas_riccati as pr
from calipso_tpu.utils import norms as jnorms
from calipso_tpu_torch.ops import cones as tcones
from calipso_tpu_torch.ops import cuda_riccati, riccati
from calipso_tpu_torch.utils import norms as tnorms
from tests.torch_parity import nan_lanes, spd_batch

ATOL = 1e-10  # float64 results of the same algorithm up to summation order
PORT = pathlib.Path(__file__).resolve().parents[1] / "calipso_tpu_torch"


@pytest.mark.parametrize("n", [5, 16, 32])
def test_factor_and_solve_plain_match_pallas_interpret(n):
    """n=5 runs the Pallas pivot-by-pivot path, 16 and 32 its blocked
    width-8 panels (the flagship's n=32). Lanes 1 and 4 are not positive
    definite: both versions must put NaN in exactly those lanes."""
    rng = np.random.default_rng(n)
    B = 6
    S = spd_batch(rng, B, n, non_pd=(1, 4))
    b = rng.normal(size=(B, n))
    Lj, _ = pr.factor_lanes(
        jnp.asarray(S)[:, None], jnp.zeros((B, 0, n, n)), interpret=True
    )
    Lj = np.asarray(Lj[:, 0])
    Lt = cuda_riccati.factor_t1_plain(torch.tensor(S)).numpy()
    assert nan_lanes(Lt).tolist() == nan_lanes(Lj).tolist() == [i in (1, 4) for i in range(B)]
    ok = ~nan_lanes(Lt)
    np.testing.assert_allclose(Lt[ok], Lj[ok], atol=ATOL, rtol=0)
    # the failed lanes carry NaN over the whole lower triangle, 0 above
    low = np.tril(np.ones((n, n), bool))
    assert np.isnan(Lt[~ok][:, low]).all() and (Lt[~ok][:, ~low] == 0).all()

    xj = pr.solve_lanes(
        jnp.asarray(Lj[ok])[:, None], jnp.zeros((int(ok.sum()), 0, n, n)),
        jnp.asarray(b[ok])[:, None], interpret=True,
    )
    xj = np.asarray(xj[:, 0])
    xt = cuda_riccati.solve_t1_plain(torch.tensor(Lt[ok]), torch.tensor(b[ok])).numpy()
    np.testing.assert_allclose(xt, xj, atol=ATOL, rtol=0)


def test_riccati_dispatches_cpu_tensors_to_plain():
    """A CPU tensor takes the plain version and never counts a launch."""
    rng = np.random.default_rng(3)
    S = torch.tensor(spd_batch(rng, 3, 7))
    b = torch.tensor(rng.normal(size=(3, 7)))
    before = dict(cuda_riccati.LAUNCHES)
    L = riccati.chol(S)
    x = riccati.chol_solve(L, b)
    assert cuda_riccati.LAUNCHES == before
    assert torch.equal(L, cuda_riccati.factor_t1_plain(S))
    np.testing.assert_allclose((S @ x[..., None])[..., 0].numpy(), b.numpy(), atol=1e-10)


def _layout_pair():
    """A cone product with 3 orthant entries and SOCs of dims 3 and 4,
    interleaved in the flat index space."""
    nn = [0, 4, 9]
    socs = [[1, 2, 3], [5, 6, 7, 8]]
    return jcones.ConeLayout(10, nn, socs), tcones.ConeLayout(10, nn, socs), socs


def _interior(rng, B, socs, mc):
    v = rng.uniform(0.5, 1.5, size=(B, mc))
    for idx in socs:
        v[:, idx[1:]] = 0.3 * rng.normal(size=(B, len(idx) - 1))
        v[:, idx[0]] = np.linalg.norm(v[:, idx[1:]], axis=1) + rng.uniform(0.2, 1.0, size=B)
    return v


def test_cone_algebra_matches_jax():
    rng = np.random.default_rng(7)
    jl, tl, socs = _layout_pair()
    B, mc, k = 4, 10, 3
    a, u = _interior(rng, B, socs, mc), _interior(rng, B, socs, mc)
    b = rng.normal(size=(B, mc))
    bk = rng.normal(size=(B, mc, k))
    eps_p, eps_d = rng.uniform(1e-8, 1e-2, size=B), rng.uniform(1e-8, 1e-2, size=B)
    tau = rng.uniform(0.9, 0.999, size=B)
    T = torch.tensor

    cases = [
        (jax.vmap(lambda a, b: jcones.product(jl, a, b))(a, b), tcones.product(tl, T(a), T(b))),
        (jax.vmap(lambda u, b: jcones.arrow_solve(jl, u, b))(u, b), tcones.arrow_solve(tl, T(u), T(b))),
        (jax.vmap(lambda a: jcones.barrier(jl, a))(a), tcones.barrier(tl, T(a))),
        (jax.vmap(lambda a: jcones.barrier_gradient(jl, a))(a), tcones.barrier_gradient(tl, T(a))),
        (
            jax.vmap(lambda s, t, ep, ed, b: jcones.c_block_solve(jl, s, t, ep, ed, b))(
                a, u, eps_p, eps_d, b
            ),
            tcones.c_block_solve(tl, T(a), T(u), T(eps_p), T(eps_d), T(b)),
        ),
        (
            jax.vmap(lambda s, t, ep, ed, b: jcones.c_block_solve(jl, s, t, ep, ed, b))(
                a, u, eps_p, eps_d, bk
            ),
            tcones.c_block_solve(tl, T(a), T(u), T(eps_p), T(eps_d), T(bk)),
        ),
    ]
    for want, got in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)

    # fraction to the boundary: a step that leaves one cone's interior in
    # some lanes and not in others
    step = np.zeros((B, mc))
    step[1, 4] = 5.0  # orthant entry pushed through zero
    step[2, 5] = 5.0  # SOC head pushed below the tail norm
    xhat = a - step
    want = jax.vmap(lambda xh, x, tau: jcones.violation(jl, xh, x, tau))(xhat, a, tau)
    got = tcones.violation(tl, T(xhat), T(a), T(tau)[:, None])
    assert got.tolist() == np.asarray(want).tolist() == [False, True, True, False]

    # target and interior initialization
    np.testing.assert_array_equal(tl.target(torch.float64, "cpu").numpy(), np.asarray(jl.target(jnp.float64)))
    np.testing.assert_array_equal(tl.initialize(torch.float64, "cpu").numpy(), np.asarray(jl.initialize(jnp.float64)))


def test_cone_layout_rejects_overlap():
    with pytest.raises(ValueError):
        tcones.ConeLayout(3, [0, 1], [[1, 2]])


@pytest.mark.parametrize("p", [1.0, 2.0, float("inf"), 3.0])
def test_norms_match_jax_per_lane(p):
    v = np.random.default_rng(1).normal(size=(5, 9))
    want = np.array([float(jnorms.norm_p(jnp.asarray(row), p)) for row in v])
    np.testing.assert_allclose(tnorms.norm_p(torch.tensor(v), p).numpy(), want, atol=ATOL)
    assert tnorms.norm_p(torch.zeros(5, 0), p).tolist() == [0.0] * 5


def test_port_imports_no_jax():
    """No module of the port imports jax, and importing the package
    loads none."""
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "calipso_tpu"), f"{path}: imports {name}"
    code = (
        "import sys, calipso_tpu_torch, calipso_tpu_torch.utils.convert, "
        "calipso_tpu_torch.models.pendulum; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'calipso_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=PORT.parent, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_stage_structure_matches_jax():
    """Block gathers, densify and the banded matvec of the stage
    structure (ragged stages: the last stage has no action) on a batch."""
    from calipso_tpu.trajopt.stage_structure import StageStructure as JS
    from calipso_tpu_torch.trajopt.stage_structure import StageStructure as TS

    starts, dims = [0, 3, 6, 9], [3, 3, 3, 2]
    js, ts = JS(starts, dims, [], [], False), TS(starts, dims, [], [], False)
    rng = np.random.default_rng(5)
    B, T, d, n = 3, 4, 3, 11
    D, O, v = rng.normal(size=(B, T, d, d)), rng.normal(size=(B, T - 1, d, d)), rng.normal(size=(B, n))
    D[:, -1, 2, :] = D[:, -1, :, 2] = 0.0  # the padded slot of the short stage
    O[:, -1, 2, :] = 0.0
    T_ = torch.tensor
    np.testing.assert_array_equal(ts.to_blocks(T_(v)).numpy(), np.asarray(jax.vmap(js.to_blocks)(v)))
    Vb = jax.vmap(js.to_blocks)(v)
    np.testing.assert_array_equal(ts.from_blocks(T_(np.asarray(Vb))).numpy(), v)
    np.testing.assert_array_equal(
        ts.densify(T_(D), T_(O)).numpy(), np.asarray(jax.vmap(js.densify)(D, O))
    )
    np.testing.assert_allclose(
        ts.band_matvec(T_(D), T_(O), T_(v)).numpy(),
        np.asarray(jax.vmap(js.band_matvec)(D, O, v)), atol=ATOL, rtol=0,
    )
