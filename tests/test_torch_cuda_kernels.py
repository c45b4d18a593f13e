"""The port's CUDA kernels (the T=1 Cholesky factor and solve, the
block-tridiagonal factor and solve over T stages, one warp per lane,
their stream versions, one block per lane with K right-hand sides per
lane, the two fused block-tridiagonal solves and the transpose of the
second's layout moves) against their plain
PyTorch versions on the card. A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU and
skip without one. The card's machine has no JAX, so run them there
without the suite's conftest (which configures JAX):
`python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q`.
For the same reason this file imports nothing from the other tests."""

import numpy as np
import pytest
import torch

from calipso_tpu_torch.ops import cuda_riccati

pytestmark = pytest.mark.cuda

# relative to the largest entry of the plain result: float32 keeps about
# 7 digits, and the two versions sum the pivot updates in another order
RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}


def spd_batch(rng, B, n, non_pd=()):
    """(B, n, n) SPD matrices D D' + n I; the lanes in non_pd negated."""
    D = rng.normal(size=(B, n, n))
    S = D @ np.swapaxes(D, 1, 2) + n * np.eye(n)
    S[list(non_pd)] *= -1.0
    return S


def nan_lanes(L):
    return np.isnan(L).any(axis=(-2, -1))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel_err(got, want, ok):
    got, want = got[ok].double(), want[ok].double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 5, 32, 33, 64, 128])
def test_kernels_match_plain(cuda, n, dtype):
    """B=37 is not a multiple of any warps-per-block count (ragged batch
    edge); n=33 and above give lanes several rows; n=128 f64 needs the
    raised shared-memory limit. Lanes 3 and 20 are not positive definite."""
    rng = np.random.default_rng(n)
    B = 37
    S = torch.tensor(spd_batch(rng, B, n, non_pd=(3, 20)), dtype=dtype, device=cuda)
    b = torch.tensor(rng.normal(size=(B, n)), dtype=dtype, device=cuda)
    before = dict(cuda_riccati.LAUNCHES)
    L = cuda_riccati.factor_t1(S)
    x = cuda_riccati.solve_t1(L, b)
    torch.cuda.synchronize()
    assert cuda_riccati.LAUNCHES["factor_t1"] == before["factor_t1"] + 1
    assert cuda_riccati.LAUNCHES["solve_t1"] == before["solve_t1"] + 1

    Lp = cuda_riccati.factor_t1_plain(S)
    bad = nan_lanes(L.cpu().numpy())
    assert bad.tolist() == nan_lanes(Lp.cpu().numpy()).tolist() == [i in (3, 20) for i in range(B)]
    ok = torch.tensor(~bad, device=cuda)
    assert _rel_err(L, Lp, ok) <= RTOL[dtype]
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert _rel_err(x, cuda_riccati.solve_t1_plain(Lp, b), ok) <= RTOL[dtype]


def tridiag_batch(rng, B, T, d, non_pd=()):
    """Block-tridiagonal SPD batches: D (B, T, d, d) blocks A A' + d I,
    O (B, T-1, d, d) couplings 0.3 N(0, 1); for each (lane, stage) in
    non_pd that stage's block is negated (not positive definite)."""
    A = rng.normal(size=(B, T, d, d))
    D = A @ np.swapaxes(A, -1, -2) + d * np.eye(d)
    O = 0.3 * rng.normal(size=(B, T - 1, d, d))
    for lane, stage in non_pd:
        D[lane, stage] *= -1.0
    return D, O, rng.normal(size=(B, T, d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "B,T,d",
    [(37, 31, 9), (13, 8, 54), (9, 1, 5), (5, 3, 64), (33, 4, 1), (40, 2, 33),
     (1, 101, 9), (1030, 31, 9), (2, 500, 64)],
)
def test_lanes_kernels_match_plain(cuda, B, T, d, dtype):
    """The batched rocket's and the contact class's stage blocks (31 x 9,
    8 x 54), rocket101's (one lane, 101 x 9), a ragged edge past the
    rocket's B (1030), and the edges of what the kernels take (T=1, d=1,
    d=64, whose float64 working set needs the raised shared-memory limit,
    d=33 with two rows per thread, and a horizon whose u does not fit in
    shared memory in float64: 500 x 64). No B is a multiple of the lanes
    per block (ragged batch edge). Lanes 2 and B-1 (those of them that
    exist, with B > 1) are not positive definite from the middle stage on:
    NaN from that stage on, on both paths."""
    _check_lanes_kernels(cuda, B, T, d, T // 2, dtype, np.random.default_rng(T * 100 + d))


def _check_lanes_kernels(cuda, B, T, d, bad_stage, dtype, rng):
    """factor_lanes and solve_lanes against their plain versions, lanes 2
    and B-1 (those that exist, with B > 1) not positive definite from
    bad_stage on."""
    bad = sorted({lane for lane in (2, B - 1) if lane < B}) if B > 1 else []
    D, O, b = tridiag_batch(rng, B, T, d, non_pd=[(lane, bad_stage) for lane in bad])
    D, O, b = (torch.tensor(a, dtype=dtype, device=cuda) for a in (D, O, b))
    before = dict(cuda_riccati.LAUNCHES)
    L, M = cuda_riccati.factor_lanes(D, O)
    x = cuda_riccati.solve_lanes(L, M, b)
    torch.cuda.synchronize()
    assert cuda_riccati.LAUNCHES["factor_lanes"] == before["factor_lanes"] + 1
    assert cuda_riccati.LAUNCHES["solve_lanes"] == before["solve_lanes"] + 1

    Lp, Mp = cuda_riccati.factor_lanes_plain(D, O)
    stage_nan = lambda A: torch.isnan(A).flatten(2).any(-1).cpu().numpy()
    assert (stage_nan(L) == stage_nan(Lp)).all() and (stage_nan(M) == stage_nan(Mp)).all()
    want = np.zeros((B, T), bool)
    want[bad, bad_stage:] = True
    assert (stage_nan(L) == want).all()
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    ok = torch.tensor(~want, device=cuda)
    assert _rel_err(L, Lp, ok) <= RTOL[dtype]
    if T > 1:
        assert _rel_err(M, Mp, ok[:, :-1]) <= RTOL[dtype]
    lanes = torch.tensor(~want.any(axis=1), device=cuda)
    assert _rel_err(x, cuda_riccati.solve_lanes_plain(Lp, Mp, b), lanes) <= RTOL[dtype]
    assert bool(torch.isnan(x[~lanes]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "B,T,d,bad_stage",
    [(37, 5, 16, 2), (37, 5, 17, 2), (19, 4, 31, 1), (19, 4, 32, 1), (19, 4, 33, 1),
     (128, 31, 9, 15), (37, 31, 9, 0), (37, 31, 9, 30), (9, 3, 17, 0), (9, 3, 32, 2)],
)
def test_factor_lanes_register_path_edges(cuda, B, T, d, bad_stage, dtype):
    """factor_lanes' register kernel at the edges of its widths (16 and 17
    on either side of its two buckets, 31 and 32 where it ends, 33 on the
    shared-memory kernel past it), the bench's rocket batch (B=128, one
    warp a block), and lanes not positive definite from the first stage
    or only at the last one."""
    _check_lanes_kernels(cuda, B, T, d, bad_stage, dtype, np.random.default_rng(B + T * 100 + d + bad_stage))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,shift", [(37, 31, 0), (37, 32, 0), (37, 32, 1), (37, 33, 0), (8193, 32, 0), (8193, 31, 0)])
def test_solve_t1_register_path_edges(cuda, B, n, shift, dtype):
    """solve_t1's register kernel below and at the warp's width and the
    shared-memory kernel past it (n=33); past the flagship's batch (8193:
    each warp walks several systems, the last one ragged); L starting one
    element past a 16-byte boundary (shift=1: copied element by element).
    Lanes 3 and B-2 are not positive definite: NaN on both paths."""
    rng = np.random.default_rng(B + n + shift)
    S = torch.tensor(spd_batch(rng, B, n, non_pd=(3, B - 2)), dtype=dtype, device=cuda)
    b = torch.tensor(rng.normal(size=(B, n)), dtype=dtype, device=cuda)
    Lp = cuda_riccati.factor_t1_plain(S)
    buf = torch.empty(B * n * n + shift, dtype=dtype, device=cuda)
    L = buf[shift:].view(B, n, n)
    L.copy_(Lp)
    before = cuda_riccati.LAUNCHES["solve_t1"]
    x = cuda_riccati.solve_t1(L, b)
    torch.cuda.synchronize()
    assert cuda_riccati.LAUNCHES["solve_t1"] == before + 1
    ok = ~torch.isnan(Lp).flatten(1).any(-1)
    assert ok.sum().item() == B - 2
    assert _rel_err(x, cuda_riccati.solve_t1_plain(Lp, b), ok) <= RTOL[dtype]
    assert bool(torch.isnan(x[~ok]).all())
    warps, blocks = cuda_riccati.solve_t1_layout(dtype, n)
    assert warps >= 1 and blocks >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,shift", [(37, 31, 0), (37, 32, 0), (37, 32, 1), (37, 33, 0), (8193, 32, 0), (8193, 31, 1)])
def test_factor_t1_register_path_edges(cuda, B, n, shift, dtype):
    """factor_t1's register kernel below and at the warp's width and the
    shared-memory kernel past it (n=33); past the flagship's batch (8193:
    each warp walks several systems, the last one ragged); S starting one
    element past a 16-byte boundary (shift=1: copied and stored element by
    element). Lanes 3 and B-2 are not positive definite: NaN over their
    lower triangles on both paths, zeros above every diagonal."""
    rng = np.random.default_rng(B + n + shift + 1)
    S0 = torch.tensor(spd_batch(rng, B, n, non_pd=(3, B - 2)), dtype=dtype, device=cuda)
    buf = torch.empty(B * n * n + shift, dtype=dtype, device=cuda)
    S = buf[shift:].view(B, n, n)
    S.copy_(S0)
    before = cuda_riccati.LAUNCHES["factor_t1"]
    L = cuda_riccati.factor_t1(S)
    torch.cuda.synchronize()
    assert cuda_riccati.LAUNCHES["factor_t1"] == before + 1
    Lp = cuda_riccati.factor_t1_plain(S0)
    bad = nan_lanes(L.cpu().numpy())
    assert bad.tolist() == nan_lanes(Lp.cpu().numpy()).tolist() == [i in (3, B - 2) for i in range(B)]
    lower = torch.ones(n, n, dtype=torch.bool, device=cuda).tril()
    assert bool(torch.isnan(L[torch.tensor(bad, device=cuda)][:, lower]).all())
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert _rel_err(L, Lp, torch.tensor(~bad, device=cuda)) <= RTOL[dtype]
    warps, blocks = cuda_riccati.factor_t1_layout(dtype, n)
    assert warps >= 1 and blocks >= 1


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    S = torch.eye(4, device=cuda).expand(3, 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_riccati.factor_t1(S)
    with pytest.raises(ValueError, match="n <= 128"):
        cuda_riccati.factor_t1(torch.eye(129, device=cuda)[None].contiguous())
    with pytest.raises(TypeError):
        cuda_riccati.factor_t1(torch.eye(4, device=cuda, dtype=torch.float16)[None].contiguous())
    L = torch.eye(4, device=cuda)[None].repeat(3, 1, 1)
    with pytest.raises(TypeError):
        cuda_riccati.solve_t1(L, torch.ones(3, 4, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        cuda_riccati.solve_t1(L, torch.ones(3, 4))
    D = torch.eye(4, device=cuda).repeat(3, 2, 1, 1)
    with pytest.raises(ValueError, match="shape"):
        cuda_riccati.factor_lanes(D, torch.zeros(3, 2, 4, 4, device=cuda))
    with pytest.raises(ValueError, match="d <= 64"):
        cuda_riccati.factor_lanes(torch.eye(65, device=cuda).repeat(1, 2, 1, 1), torch.zeros(1, 1, 65, 65, device=cuda))
    L, M = cuda_riccati.factor_lanes(D, torch.zeros(3, 1, 4, 4, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        cuda_riccati.solve_lanes(L, M, torch.ones(3, 2, 5, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "B,T,d,K",
    [(128, 8, 54, 1), (128, 8, 54, 22), (13, 8, 54, 1), (9, 1, 5, 3), (5, 3, 64, 40),
     (33, 4, 1, 1), (6, 11, 33, 2), (7, 2, 13, 33),
     (17, 2, 8, 1), (17, 3, 9, 1), (9, 4, 16, 5), (11, 3, 55, 1), (11, 3, 56, 33), (5, 5, 64, 2)],
)
def test_stream_kernels_match_plain(cuda, B, T, d, K, dtype):
    """The batched quadruped's stage blocks (8 x 54) with one and with 22
    right-hand sides (the gait border's 2 x 11 columns), and the edges:
    T=1, d=1, d=64 (float64 needs the raised shared-memory limit), K over
    one 32-column chunk. The factor's 8-wide panels at their edges: one
    panel (d=8), a 1-wide last panel (d=9), a 7-wide one over ragged 4 x 4
    tiles (d=55), whole panels (16, 56, 64); the backward sweep's second
    row a thread (d > 32) and a one-column second chunk (K=33). Lanes 2 and B-1
    are not positive definite from the middle stage on: NaN from that
    stage on, on both paths."""
    rng = np.random.default_rng(T * 100 + d + K)
    bad_stage = T // 2
    D, O, _ = tridiag_batch(rng, B, T, d, non_pd=((2, bad_stage), (B - 1, bad_stage)))
    b = rng.normal(size=(B, T, d, K))
    D, O, b = (torch.tensor(a, dtype=dtype, device=cuda) for a in (D, O, b))
    before = dict(cuda_riccati.LAUNCHES)
    L, M = cuda_riccati.factor_stream(D, O)
    x = cuda_riccati.solve_stream(L, M, b)
    x1 = cuda_riccati.solve_stream(L, M, b[..., 0].contiguous())
    torch.cuda.synchronize()
    assert cuda_riccati.LAUNCHES["factor_stream"] == before["factor_stream"] + 1
    for sweep in ("solve_fwd_stream", "solve_bwd_stream"):
        assert cuda_riccati.LAUNCHES[sweep] == before[sweep] + 2

    Lp, Mp = cuda_riccati.factor_stream_plain(D, O)
    stage_nan = lambda A: torch.isnan(A).flatten(2).any(-1).cpu().numpy()
    assert (stage_nan(L) == stage_nan(Lp)).all() and (stage_nan(M) == stage_nan(Mp)).all()
    want = np.zeros((B, T), bool)
    want[[2, B - 1], bad_stage:] = True
    assert (stage_nan(L) == want).all()
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    ok = torch.tensor(~want, device=cuda)
    assert _rel_err(L, Lp, ok) <= RTOL[dtype]
    if T > 1:
        assert _rel_err(M, Mp, ok[:, :-1]) <= RTOL[dtype]
    lanes = torch.tensor(~want.any(axis=1), device=cuda)
    u = cuda_riccati.solve_fwd_stream_plain(Lp, Mp, b)
    xp = cuda_riccati.solve_bwd_stream_plain(Lp, Mp, u)
    assert _rel_err(x, xp, lanes) <= RTOL[dtype]
    assert _rel_err(x1, xp[..., 0], lanes) <= RTOL[dtype]
    assert bool(torch.isnan(x[~lanes]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["solve_batched_fused", "solve_batched_lanes"])
@pytest.mark.parametrize(
    "B,T,d", [(37, 31, 9), (13, 8, 54), (4, 12, 54), (9, 1, 5), (5, 3, 64), (33, 4, 1), (40, 2, 33)]
)
def test_batched_solve_kernels_match_plain(cuda, name, B, T, d, dtype):
    """The fused solves at the batched rocket's and the quadruped's stage
    blocks and the edges (T=1, d=1, d=64, d=33); the fused kernel keeps the
    horizon in shared memory except at (13, 8, 54) in float64 and (4, 12,
    54), where it takes the workspace. Lanes 2 and B-1 are not positive
    definite from the middle stage on: NaN over all of their x."""
    rng = np.random.default_rng(T * 100 + d + 7)
    bad_stage = T // 2
    D, O, b = tridiag_batch(rng, B, T, d, non_pd=((2, bad_stage), (B - 1, bad_stage)))
    D, O, b = (torch.tensor(a, dtype=dtype, device=cuda) for a in (D, O, b))
    before = dict(cuda_riccati.LAUNCHES)
    x = getattr(cuda_riccati, name)(D, O, b)
    torch.cuda.synchronize()
    assert cuda_riccati.LAUNCHES[name] == before[name] + 1
    xp = cuda_riccati.solve_batched_plain(D, O, b)
    lanes = torch.ones(B, dtype=torch.bool, device=cuda)
    lanes[[2, B - 1]] = False
    assert bool(torch.isnan(x[~lanes]).all()) and bool(torch.isnan(xp[~lanes]).all())
    assert bool(torch.isfinite(x[lanes]).all())
    assert _rel_err(x, xp, lanes) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["solve_batched_fused", "solve_batched_lanes"])
@pytest.mark.parametrize(
    "B,T,d,bad_stage",
    [(37, 31, 9, 0), (37, 31, 9, 30), (37, 5, 16, 0), (37, 5, 17, 4), (37, 5, 31, 2), (37, 5, 32, 4),
     (37, 1, 9, 0), (37, 1, 32, 0), (133, 31, 32, 30), (9, 200, 12, 199)],
)
def test_fused_register_path_edges(cuda, name, B, T, d, bad_stage, dtype):
    """The fused solves' register kernel (d <= 32), batch-first and
    batch-last, at the edges of its width buckets (16, 17) and of the warp
    (31, 32), T=1, and shapes where the horizon's factor leaves shared
    memory for the workspace (T=31 at d=32, T=200 at d=12, and the
    rocket's T=31, d=9 in float64); B=37 and 133 leave ragged blocks; lanes
    2 and B-1 are not positive definite from their first or only at their
    last stage: all of their x NaN, the other lanes untouched."""
    rng = np.random.default_rng(B + 10 * T + d + bad_stage)
    D, O, b = tridiag_batch(rng, B, T, d, non_pd=((2, bad_stage), (B - 1, bad_stage)))
    D, O, b = (torch.tensor(a, dtype=dtype, device=cuda) for a in (D, O, b))
    before = cuda_riccati.LAUNCHES[name]
    x = getattr(cuda_riccati, name)(D, O, b)
    torch.cuda.synchronize()
    assert cuda_riccati.LAUNCHES[name] == before + 1
    xp = cuda_riccati.solve_batched_plain(D, O, b)
    lanes = torch.ones(B, dtype=torch.bool, device=cuda)
    lanes[[2, B - 1]] = False
    assert bool(torch.isnan(x[~lanes]).all()) and bool(torch.isnan(xp[~lanes]).all())
    assert bool(torch.isfinite(x[lanes]).all())
    assert _rel_err(x, xp, lanes) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("T,d", [(31, 9), (8, 54)])
def test_batched_lanes_single_lane(cuda, T, d, dtype):
    """solve_batched_lanes at B=1, where a lane has no neighbour in its
    sectors (the batch-last stride is one word), on the register kernel
    and the wide one; then the same lane not positive definite at its
    last stage: all of its x NaN."""
    rng = np.random.default_rng(T + d)
    D, O, b = tridiag_batch(rng, 1, T, d)
    D, O, b = (torch.tensor(a, dtype=dtype, device=cuda) for a in (D, O, b))
    x = cuda_riccati.solve_batched_lanes(D, O, b)
    xp = cuda_riccati.solve_batched_plain(D, O, b)
    assert bool(torch.isfinite(x).all())
    assert _rel_err(x, xp, torch.ones(1, dtype=torch.bool, device=cuda)) <= RTOL[dtype]
    D[0, -1] *= -1.0
    assert bool(torch.isnan(cuda_riccati.solve_batched_lanes(D, O, b)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,T,d", [(37, 31, 9), (13, 8, 54), (1, 3, 64), (40, 1, 33), (1030, 2, 1)])
def test_transpose_matches_plain(cuda, B, T, d, dtype):
    """The transpose kernel of solve_batched_lanes' layout moves, bit for
    bit against torch's permute(...).contiguous(): ragged 32 x 32 tiles
    (B = 37, 13, 1030; T d^2 not a multiple of 32), one lane, T = 1 (an
    empty O) and d = 1; one launch each way."""
    rng = np.random.default_rng(B + T + d)
    D, O, b = (torch.tensor(a, dtype=dtype, device=cuda) for a in tridiag_batch(rng, B, T, d))
    before = cuda_riccati.LAUNCHES["transpose"]
    got = cuda_riccati.batch_last(D, O, b)
    back = cuda_riccati.batch_first(got[2])
    torch.cuda.synchronize()
    assert cuda_riccati.LAUNCHES["transpose"] == before + 2
    want = cuda_riccati.batch_last_plain(D, O, b)
    assert all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(back, b)


def test_batched_solve_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    D = torch.eye(4, device=cuda).repeat(3, 2, 1, 1)
    O = torch.zeros(3, 1, 4, 4, device=cuda)
    b = torch.ones(3, 2, 4, device=cuda)
    for fn in (cuda_riccati.solve_batched_fused, cuda_riccati.solve_batched_lanes):
        with pytest.raises(ValueError, match="contiguous"):
            fn(D.transpose(2, 3), O, b)
        with pytest.raises(ValueError, match="shape"):
            fn(D, O, torch.ones(3, 2, 5, device=cuda))
        with pytest.raises(TypeError):
            fn(D, O, b.double())
        with pytest.raises(ValueError):
            fn(D, O, b.cpu())
        x = fn(D, O, b)
        assert torch.allclose(x, b)  # S is the identity


def test_stream_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    D = torch.eye(4, device=cuda).repeat(3, 2, 1, 1)
    with pytest.raises(ValueError, match="shape"):
        cuda_riccati.factor_stream(D, torch.zeros(3, 2, 4, 4, device=cuda))
    with pytest.raises(ValueError, match="d <= 64"):
        cuda_riccati.factor_stream(
            torch.eye(65, device=cuda).repeat(1, 2, 1, 1), torch.zeros(1, 1, 65, 65, device=cuda)
        )
    with pytest.raises(TypeError):
        cuda_riccati.factor_stream(D.half(), torch.zeros(3, 1, 4, 4, device=cuda).half())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_riccati.factor_stream(D.transpose(2, 3), torch.zeros(3, 1, 4, 4, device=cuda))
    L, M = cuda_riccati.factor_stream(D, torch.zeros(3, 1, 4, 4, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        cuda_riccati.solve_stream(L, M, torch.ones(3, 2, 5, 2, device=cuda))
    with pytest.raises(TypeError):
        cuda_riccati.solve_stream(L, M, torch.ones(3, 2, 4, 2, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_riccati.solve_stream(L, M, torch.ones(3, 2, 2, 4, device=cuda).transpose(2, 3))
    with pytest.raises(ValueError):
        cuda_riccati.solve_stream(L, M, torch.ones(3, 2, 4, 2))
