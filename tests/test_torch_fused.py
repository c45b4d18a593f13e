"""The port's fused batched block-tridiagonal solve `solve_batched` (the
counterpart of `calipso_tpu/ops/pallas_riccati.py:solve_batched`) on the
CPU in float64: its plain version against both Pallas kernels it
replaces, `solve_batched_pallas` (one grid program per scenario) and
`solve_batched_lanes` (the batch on the lane axis), in interpret mode,
and against the reference's own dispatch; the NaN rule of a lane that is
not positive definite; T=1; and the wrappers' refusals of what the CUDA
kernels do not take (on `meta` tensors, which carry shape and dtype but
no data). The kernels themselves are checked on the card in
`tests/test_torch_cuda_kernels.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calipso_tpu.ops import pallas_riccati as pr
from calipso_tpu_torch.ops import cuda_riccati
from tests.test_riccati import make_block_tridiag

ATOL = 1e-9  # that of tests/test_pallas_riccati.py

# the reference tests' shapes, T=1, and the batched rocket's stage blocks
SHAPES = [(3, 6, 4), (5, 6, 4), (2, 4, 3), (3, 1, 5), (3, 31, 9)]
BATCHED = ("solve_batched", "solve_batched_fused", "solve_batched_lanes")


def _inputs(B, T, d, seed, bad=None):
    rng = np.random.default_rng(seed)
    D = np.zeros((B, T, d, d))
    O = np.zeros((B, T - 1, d, d))
    for i in range(B):
        D[i], O[i], _ = make_block_tridiag(T, d, rng)
    if bad is not None:
        D[bad, T // 2] = -np.eye(d)
    return D, O, rng.normal(size=(B, T, d))


@pytest.mark.parametrize("B,T,d", SHAPES)
def test_plain_matches_pallas_interpret(B, T, d):
    """Lane 1 is not positive definite from its middle stage on: NaN over
    all of its x on both sides; every other lane within 1e-9."""
    D, O, b = _inputs(B, T, d, T * 100 + d, bad=1)
    x = cuda_riccati.solve_batched_plain(*(torch.tensor(a) for a in (D, O, b))).numpy()
    jD, jO, jb = jnp.asarray(D), jnp.asarray(O), jnp.asarray(b)
    refs = (
        pr.solve_batched_pallas(jD, jO, jb, interpret=True),
        pr.solve_batched_lanes(jD, jO, jb, interpret=True),
        pr.solve_batched(jD, jO, jb),  # the CPU branch: the scan under vmap
    )
    good = np.arange(B) != 1
    assert np.isnan(x[1]).all() and np.isfinite(x[good]).all()
    for ref in refs:
        ref = np.asarray(ref)
        assert np.isnan(ref[1]).all()
        np.testing.assert_allclose(x[good], ref[good], atol=ATOL, rtol=0)


def test_a_failed_lane_leaves_the_others_untouched():
    B, T, d = 4, 7, 3
    D, O, b = (torch.tensor(a) for a in _inputs(B, T, d, 5))
    x = cuda_riccati.solve_batched_plain(D, O, b)
    D_bad = D.clone()
    D_bad[2, 0] = -torch.eye(d, dtype=D.dtype)  # the first stage fails
    x_bad = cuda_riccati.solve_batched_plain(D_bad, O, b)
    assert torch.isnan(x_bad[2]).all()
    keep = torch.tensor([0, 1, 3])
    assert torch.equal(x_bad[keep], x[keep])


@pytest.mark.parametrize("name", BATCHED)
def test_cpu_tensors_take_the_plain_version(name):
    """Every entry point gives the plain version's x on CPU tensors and
    counts no launch."""
    D, O, b = (torch.tensor(a) for a in _inputs(3, 5, 4, 11, bad=0))
    before = dict(cuda_riccati.LAUNCHES)
    x = getattr(cuda_riccati, name)(D, O, b)
    assert cuda_riccati.LAUNCHES == before
    want = cuda_riccati.solve_batched_plain(D, O, b)
    assert torch.equal(torch.isnan(x), torch.isnan(want))
    assert torch.equal(x[1:], want[1:])


@pytest.mark.parametrize("name", BATCHED)
def test_wrappers_refuse_what_the_kernels_do_not_take(name):
    """Shape, dtype and d checks come before the kernel; a tensor that is
    on neither the CPU nor a card is refused, never computed."""
    fn = getattr(cuda_riccati, name)
    meta = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="shape"):
        fn(meta(3, 4, 5, 5), meta(3, 4, 5, 5), meta(3, 4, 5))  # O needs T-1 = 3 blocks
    with pytest.raises(ValueError, match="shape"):
        fn(meta(3, 4, 5, 5), meta(3, 3, 5, 5), meta(3, 4, 6))
    with pytest.raises(TypeError):
        fn(meta(3, 4, 5, 5), meta(3, 3, 5, 5), meta(3, 4, 5, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32 or float64"):
        h = torch.float16
        fn(meta(3, 4, 5, 5, dtype=h), meta(3, 3, 5, 5, dtype=h), meta(3, 4, 5, dtype=h))
    if name == "solve_batched":
        # past d = 64 it takes the stream kernels, then the scan: a tensor
        # off the card is refused there too, never computed
        for d in (65, 170):
            with pytest.raises(ValueError, match="CUDA tensor"):
                fn(meta(1, 2, d, d), meta(1, 1, d, d), meta(1, 2, d))
    else:
        with pytest.raises(ValueError, match="d <= 64"):
            fn(meta(1, 2, 65, 65), meta(1, 1, 65, 65), meta(1, 2, 65))
    with pytest.raises(ValueError, match="T >= 1"):
        fn(meta(1, 0, 4, 4), meta(1, 0, 4, 4), meta(1, 0, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(meta(3, 4, 5, 5), meta(3, 3, 5, 5), meta(3, 4, 5))
    # a CPU tensor beside a non-CPU one is not computed on the CPU
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(torch.zeros(3, 4, 5, 5), meta(3, 3, 5, 5), meta(3, 4, 5))
