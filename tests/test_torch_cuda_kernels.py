"""The port's CUDA kernels (the T=1 Cholesky factor and solve, a warp a
system up to n = 32 and a block a system in 32-wide panels past it, the
block-tridiagonal factor and solve over T stages, one warp per lane,
their stream versions, one block per lane with K right-hand sides per
lane, the two fused block-tridiagonal solves and the transpose of the
second's layout moves) against their plain PyTorch versions on the card,
and ops/riccati's library and scan routes past the kernels' widths
against the same calls on the CPU. A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU and
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
@pytest.mark.parametrize("n", [1, 5, 19, 32, 33, 63, 64, 65, 96, 97, 110, 127, 128])
def test_kernels_match_plain(cuda, n, dtype):
    """B=37 is not a multiple of any warps-per-block count (ragged batch
    edge); n=19 is the cart-pole tuning's and the MPC pendulum's width is
    32; n=33 and above take the panel kernels, at the panels' edges
    (63, 64, 65, 96, 97, 127, 128: a ragged or a full last panel); n=110
    is the bunny hop's; n=128 f64 needs the raised shared-memory limit.
    Lanes 3 and 20 are not positive definite."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [32, 110])
def test_kernels_match_plain_single_system(cuda, n, dtype):
    """One system, as an unbatched solve gives the T=1 kernels (the bunny
    hop's n=110 on the wide kernels, n=32 on the register ones): a
    positive definite one matches the plain version, a negated one is NaN
    on both paths."""
    rng = np.random.default_rng(n + 1)
    for non_pd in ((), (0,)):
        S = torch.tensor(spd_batch(rng, 1, n, non_pd=non_pd), dtype=dtype, device=cuda)
        b = torch.tensor(rng.normal(size=(1, n)), dtype=dtype, device=cuda)
        L, Lp = cuda_riccati.factor_t1(S), cuda_riccati.factor_t1_plain(S)
        x, xp = cuda_riccati.solve_t1(L, b), cuda_riccati.solve_t1_plain(Lp, b)
        torch.cuda.synchronize()
        if non_pd:
            assert bool(torch.isnan(L).any()) and bool(torch.isnan(Lp).any())
            assert bool(torch.isnan(x).all())
        else:
            ok = torch.ones(1, dtype=torch.bool, device=cuda)
            assert _rel_err(L, Lp, ok) <= RTOL[dtype]
            assert _rel_err(x, xp, ok) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [33, 65, 110, 128])
@pytest.mark.parametrize("B", [1, 37])
def test_panel_factor_fails_in_the_last_panel(cuda, B, n, dtype):
    """The last system's only bad pivot is its last one (S_nn made
    negative), in the last panel: NaN over its whole lower triangle on
    both paths, zeros above, and NaN over all of its x; the other systems
    match the plain version."""
    rng = np.random.default_rng(B * 1000 + n)
    S64 = spd_batch(rng, B, n)
    S64[B - 1, n - 1, n - 1] = -5.0
    S = torch.tensor(S64, dtype=dtype, device=cuda)
    b = torch.tensor(rng.normal(size=(B, n)), dtype=dtype, device=cuda)
    L = cuda_riccati.factor_t1(S)
    x = cuda_riccati.solve_t1(L, b)
    Lp = cuda_riccati.factor_t1_plain(S)
    torch.cuda.synchronize()
    bad = [i == B - 1 for i in range(B)]
    assert nan_lanes(L.cpu().numpy()).tolist() == nan_lanes(Lp.cpu().numpy()).tolist() == bad
    lower = torch.ones(n, n, dtype=torch.bool, device=cuda).tril()
    assert bool(torch.isnan(L[-1][lower]).all()) and torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert bool(torch.isnan(x[-1]).all())
    if B > 1:
        ok = torch.tensor([not f for f in bad], device=cuda)
        assert _rel_err(L, Lp, ok) <= RTOL[dtype]
        assert _rel_err(x, cuda_riccati.solve_t1_plain(Lp, b), ok) <= RTOL[dtype]


WIDE_T1 = [(n, torch.float32) for n in (129, 160, 192, 221, 256, 288)] + [
    (n, torch.float64) for n in (129, 160, 192)
]


@pytest.mark.parametrize("n,dtype", WIDE_T1)
def test_wide_panel_kernels_match_plain(cuda, n, dtype):
    """The wide panel kernels (n past 128, up to MAX_N: 288 in float32,
    192 in float64): n = 221 and 155 are the reference's widest resident
    T=1 tiles (B = 32 and 64), 160 and 192 full last panels, 129 a 1-wide
    one. Lanes 3 and 20 are not positive definite, and lane 36's only bad
    pivot is its last, in the last panel: NaN over the lower triangle of
    each, zeros above, NaN over its x, on both paths; the rest match the
    plain version. Then one system alone, as an unbatched solve gives it."""
    rng = np.random.default_rng(n)
    B = 37
    S64 = spd_batch(rng, B, n, non_pd=(3, 20))
    S64[B - 1, n - 1, n - 1] = -5.0
    S = torch.tensor(S64, dtype=dtype, device=cuda)
    b = torch.tensor(rng.normal(size=(B, n)), dtype=dtype, device=cuda)
    before = dict(cuda_riccati.LAUNCHES)
    L = cuda_riccati.factor_t1(S)
    x = cuda_riccati.solve_t1(L, b)
    torch.cuda.synchronize()
    assert cuda_riccati.LAUNCHES["factor_t1"] == before["factor_t1"] + 1
    assert cuda_riccati.LAUNCHES["solve_t1"] == before["solve_t1"] + 1
    Lp = cuda_riccati.factor_t1_plain(S)
    bad = [i in (3, 20, B - 1) for i in range(B)]
    assert nan_lanes(L.cpu().numpy()).tolist() == nan_lanes(Lp.cpu().numpy()).tolist() == bad
    lower = torch.ones(n, n, dtype=torch.bool, device=cuda).tril()
    assert bool(torch.isnan(L[-1][lower]).all()) and torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert bool(torch.isnan(x[-1]).all())
    ok = torch.tensor([not f for f in bad], device=cuda)
    assert _rel_err(L, Lp, ok) <= RTOL[dtype]
    assert _rel_err(x, cuda_riccati.solve_t1_plain(Lp, b), ok) <= RTOL[dtype]
    L1 = cuda_riccati.factor_t1(S[:1].contiguous())
    x1 = cuda_riccati.solve_t1(L1, b[:1].contiguous())
    one = torch.ones(1, dtype=torch.bool, device=cuda)
    assert _rel_err(L1, Lp[:1], one) <= RTOL[dtype]
    assert _rel_err(x1, cuda_riccati.solve_t1_plain(Lp[:1], b[:1]), one) <= RTOL[dtype]


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
     (1, 101, 9), (1030, 31, 9), (2, 500, 64), (1024, 21, 26), (37, 21, 12), (1, 21, 26), (1, 21, 12),
     (1024, 44, 3), (37, 51, 17), (1, 51, 17), (256, 10, 3), (256, 4, 3), (1, 1, 3), (1, 2, 3)],
)
def test_lanes_kernels_match_plain(cuda, B, T, d, dtype):
    """The batched rocket's and the contact class's stage blocks (31 x 9,
    8 x 54), the hopper batch's (21 x 26, in the register factor's width-32
    bucket) and ball-in-cup's (21 x 12), each also as the single solves
    give them (one lane), the differentiated pendulum batch at horizon 44
    (44 x 3) and the state-triggered rocket's (51 x 17, the first width of
    the register factor's width-32 bucket; one lane, as its single solve
    gives it), the spike backend's over 4 ranks at horizon 44 (a chunk's
    interior, 10 x 3, and the 4 separators, 4 x 3, B=256) and over 2 ranks
    at horizon 4 (a 2-stage chunk's interior, T=1 with an empty O, and the
    2 separators; one lane), rocket101's (one lane, 101 x 9), a ragged edge past the
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
     (128, 31, 9, 15), (37, 31, 9, 0), (37, 31, 9, 30), (9, 3, 17, 0), (9, 3, 32, 2),
     (37, 21, 26, 0), (37, 21, 26, 20)],
)
def test_factor_lanes_register_path_edges(cuda, B, T, d, bad_stage, dtype):
    """factor_lanes' register kernel at the edges of its widths (16 and 17
    on either side of its two buckets, 31 and 32 where it ends, 33 on the
    shared-memory kernel past it), the bench's rocket batch (B=128, one
    warp a block), and lanes not positive definite from the first stage
    or only at the last one (also at the hopper's 21 x 26, rows 26..31 of
    its bucket identity)."""
    _check_lanes_kernels(cuda, B, T, d, bad_stage, dtype, np.random.default_rng(B + T * 100 + d + bad_stage))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "B,n,shift",
    [(37, 31, 0), (37, 32, 0), (37, 32, 1), (37, 33, 0), (8193, 32, 0), (8193, 31, 0), (37, 110, 1), (37, 65, 1),
     (1024, 128, 0), (256, 19, 0)],
)
def test_solve_t1_register_path_edges(cuda, B, n, shift, dtype):
    """solve_t1's register kernel below and at the warp's width and the
    panel kernel past it (n=33); past the flagship's batch (8193: each
    warp walks several systems, the last one ragged); L starting one
    element past a 16-byte boundary (shift=1: copied element by element,
    or in 8-byte pieces at the panel kernel's even n in float32); the
    panel kernel's largest shared memory at B=1024 (n=128). Lanes 3 and
    B-2 are not positive definite: NaN on both paths."""
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
@pytest.mark.parametrize(
    "B,n,shift",
    [(37, 31, 0), (37, 32, 0), (37, 32, 1), (37, 33, 0), (8193, 32, 0), (8193, 31, 1), (37, 110, 1), (37, 65, 1),
     (1024, 128, 0), (256, 19, 0)],
)
def test_factor_t1_register_path_edges(cuda, B, n, shift, dtype):
    """factor_t1's register kernel below and at the warp's width and the
    panel kernel past it (n=33); past the flagship's batch (8193: each
    warp walks several systems, the last one ragged); S starting one
    element past a 16-byte boundary (shift=1: copied and stored element by
    element, or copied in 8-byte pieces at the panel kernel's even n in
    float32); the panel kernel's largest shared memory at B=1024 (n=128,
    float64: 85 KB a block). Lanes 3 and B-2 are not positive definite:
    NaN over their lower triangles on both paths, zeros above every
    diagonal."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,T,d,K", [(1024, 44, 3, 2), (37, 51, 17, 3), (256, 10, 3, 6), (1, 1, 3, 6)])
def test_stream_sweeps_on_the_lanes_factor(cuda, B, T, d, K, dtype):
    """Implicit differentiation's K-column solve on the riccati backend at
    a lanes-route width: factor_lanes' (L, M), then ops/riccati.solve_multi
    on the stream sweeps (the differentiated pendulum batch's 44 x 3 with
    its 2 parameter columns; 51 x 17 at K=3), and the spike backend's
    boundary eliminations, K = 2d columns, on a chunk's interior (10 x 3
    at B=256; a 2-stage chunk's T=1 interior, one lane, with an empty O
    and M). Lanes 2 and B-1 (with B > 1) are not positive definite from
    the middle stage on: NaN over all of their X."""
    from calipso_tpu_torch.ops import riccati

    rng = np.random.default_rng(B + T + d + K)
    bad = [2, B - 1] if B > 1 else []
    D, O, _ = tridiag_batch(rng, B, T, d, non_pd=[(lane, T // 2) for lane in bad])
    b = rng.normal(size=(B, T, d, K))
    D, O, b = (torch.tensor(a, dtype=dtype, device=cuda) for a in (D, O, b))
    assert riccati.route(d, dtype, T) == "lanes"
    before = dict(cuda_riccati.LAUNCHES)
    L, M = riccati.factor(D, O)
    X = riccati.solve_multi(L, M, b)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in cuda_riccati.LAUNCHES.items() if v != before[k]}
    assert moved == {"factor_lanes": 1, "solve_fwd_stream": 1, "solve_bwd_stream": 1}
    Lp, Mp = cuda_riccati.factor_lanes_plain(D, O)
    Xp = cuda_riccati.solve_bwd_stream_plain(Lp, Mp, cuda_riccati.solve_fwd_stream_plain(Lp, Mp, b))
    lanes = torch.tensor([i not in bad for i in range(B)], device=cuda)
    assert _rel_err(X, Xp, lanes) <= RTOL[dtype]
    assert bool(torch.isnan(X[~lanes]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,K", [(8192, 32, 2), (3, 131, 2)])
def test_schur_multi_column_solve_on_the_card(cuda, B, n, K, dtype):
    """The schur backend's K-column solve (implicit differentiation):
    ops/riccati.chol_solve_multi, two triangular solves with the factor at
    any width, counted as solve_t1_multi_library, matches the same call on
    the CPU; a lane not positive definite is NaN."""
    from calipso_tpu_torch.ops import riccati

    rng = np.random.default_rng(B + n)
    S = spd_batch(rng, B, n, non_pd=(1,))
    b = rng.normal(size=(B, n, K))
    out = {}
    before = dict(cuda_riccati.LAUNCHES)
    for where in ("cuda", "cpu"):
        t = lambda a: torch.tensor(a, dtype=dtype, device=where)
        L = riccati.chol(t(S))
        out[where] = riccati.chol_solve_multi(L, t(b))
    torch.cuda.synchronize()
    assert cuda_riccati.LAUNCHES["solve_t1_multi_library"] == before["solve_t1_multi_library"] + 1
    got, want = out["cuda"].cpu(), out["cpu"]
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and bool(torch.isnan(got[1]).all())
    ok = ~torch.isnan(want)
    assert float((got[ok] - want[ok]).abs().max() / want[ok].abs().max()) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_routes_past_the_kernels_widths_solve_on_the_card(cuda, dtype):
    """ops/riccati past the kernels' widths: chol and chol_solve one past
    MAX_N[dtype] (n = 289 in float32, 193 in float64) take the library
    route, factor, solve and solve_multi one past MAX_D[dtype] (d = 170,
    121) the scan, on the card, counted under their own keys with no
    kernel launched, and match the same calls on the CPU; a lane not
    positive definite is NaN on both."""
    from calipso_tpu_torch.ops import riccati

    n, d = cuda_riccati.MAX_N[dtype] + 1, cuda_riccati.MAX_D[dtype] + 1
    assert riccati.t1_route(n, dtype) == "library" and riccati.route(d, dtype, 4) == "scan"
    rng = np.random.default_rng(129)
    S = spd_batch(rng, 3, n, non_pd=(1,))
    b = rng.normal(size=(3, n))
    D, O, bt = tridiag_batch(rng, 3, 4, d, non_pd=((2, 2),))
    bk = rng.normal(size=(3, 4, d, 2))
    before = dict(cuda_riccati.LAUNCHES)
    out = {}
    for where in ("cuda", "cpu"):
        t = lambda a: torch.tensor(a, dtype=dtype, device=where)
        L = riccati.chol(t(S))
        Lb, M = riccati.factor(t(D), t(O))
        out[where] = (L, riccati.chol_solve(L, t(b)), Lb, M, riccati.solve(Lb, M, t(bt)), riccati.solve_multi(Lb, M, t(bk)))
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in cuda_riccati.LAUNCHES.items() if v != before[k]}
    assert moved == {"factor_t1_library": 1, "solve_t1_library": 1, "factor_scan": 1, "solve_scan": 2}
    for got, want in zip(out["cuda"], out["cpu"]):
        got = got.cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        assert float((got[ok] - want[ok]).abs().max() / want[ok].abs().max()) <= RTOL[dtype]
    assert bool(torch.isnan(out["cuda"][0][1]).any()) and bool(torch.isnan(out["cuda"][4][2]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_stage_past_max_d_on_the_t1_kernels(cuda, dtype):
    """ops/riccati at T = 1 one past MAX_D[dtype] (d = 170, 121): one dense
    system, on the T=1 kernels (`solve_multi` a launch a column), counted
    as theirs, with no scan; factor, solve and solve_multi (K=2) match
    their plain versions, and lane 1, not positive definite, is NaN over
    its lower triangle and its x."""
    from calipso_tpu_torch.ops import riccati

    d = cuda_riccati.MAX_D[dtype] + 1
    assert riccati.route(d, dtype, 1) == "t1"
    rng = np.random.default_rng(d)
    D, O, b = (torch.tensor(a, dtype=dtype, device=cuda) for a in tridiag_batch(rng, 3, 1, d, non_pd=((1, 0),)))
    bk = torch.tensor(rng.normal(size=(3, 1, d, 2)), dtype=dtype, device=cuda)
    before = dict(cuda_riccati.LAUNCHES)
    L, M = riccati.factor(D, O)
    x, X = riccati.solve(L, M, b), riccati.solve_multi(L, M, bk)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in cuda_riccati.LAUNCHES.items() if v != before[k]}
    assert moved == {"factor_t1": 1, "solve_t1": 3}
    Lp = cuda_riccati.factor_t1_plain(D[:, 0])
    ok = torch.tensor([True, False, True], device=cuda)
    assert nan_lanes(L[:, 0].cpu().numpy()).tolist() == [False, True, False]
    assert _rel_err(L[:, 0], Lp, ok) <= RTOL[dtype]
    assert _rel_err(x[:, 0], cuda_riccati.solve_t1_plain(Lp, b[:, 0]), ok) <= RTOL[dtype]
    for k in range(2):
        assert _rel_err(X[:, 0, :, k], cuda_riccati.solve_t1_plain(Lp, bk[:, 0, :, k]), ok) <= RTOL[dtype]
    assert bool(torch.isnan(x[1]).all()) and bool(torch.isnan(X[1]).all())


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    S = torch.eye(4, device=cuda).expand(3, 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_riccati.factor_t1(S)
    with pytest.raises(ValueError, match="n <= 288"):
        cuda_riccati.factor_t1(torch.eye(289, device=cuda)[None].contiguous())
    with pytest.raises(ValueError, match="n <= 192"):
        cuda_riccati.factor_t1(torch.eye(193, device=cuda, dtype=torch.float64)[None].contiguous())
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
     (17, 2, 8, 1), (17, 3, 9, 1), (9, 4, 16, 5), (11, 3, 55, 1), (11, 3, 56, 33), (5, 5, 64, 2),
     (1024, 21, 26, 4), (1024, 11, 33, 1), (1, 21, 26, 4), (1, 11, 33, 1), (1, 8, 54, 1)],
)
def test_stream_kernels_match_plain(cuda, B, T, d, K, dtype):
    """The batched quadruped's stage blocks (8 x 54) with one and with 22
    right-hand sides (the gait border's 2 x 11 columns), the hopper's
    (21 x 26) with its border's 4 columns, the box move's (11 x 33, the
    first width on the stream route: a 1-wide last factor panel), and the edges:
    T=1, d=1, d=64 (float64 needs the raised shared-memory limit), K over
    one 32-column chunk. The factor's 8-wide panels at their edges: one
    panel (d=8), a 1-wide last panel (d=9), a 7-wide one over ragged 4 x 4
    tiles (d=55), whole panels (16, 56, 64); the backward sweep's second
    row a thread (d > 32) and a one-column second chunk (K=33); the hopper's
    and the box's also as their single solves give them (one lane), and the
    dry run's quadruped drop lane (one lane, 8 x 54). Lanes 2
    and B-1 (those of them that exist, with B > 1) are not positive
    definite from the middle stage on: NaN from that stage on, on both
    paths."""
    _stream_matches_plain(cuda, B, T, d, K, dtype)


WIDE_STREAM = [
    (s, torch.float32)
    for s in ((128, 8, 82, 1), (64, 8, 116, 2), (32, 8, 165, 1), (32, 8, 165, 22), (7, 3, 65, 2), (5, 4, 128, 22),
              (9, 1, 120, 3), (4, 5, 121, 33), (3, 3, 168, 2), (3, 3, 169, 1), (1, 8, 65, 1), (4, 8, 65, 1),
              (1, 8, 165, 1), (4, 8, 165, 2), (4, 5, 82, 164), (3, 4, 165, 16), (3, 4, 165, 17), (1, 5, 169, 1))
] + [(s, torch.float64) for s in ((4, 5, 65, 2), (5, 4, 84, 1), (5, 4, 85, 22), (3, 3, 116, 2), (3, 3, 119, 1),
                                  (3, 3, 120, 1), (1, 8, 65, 1), (4, 8, 65, 1), (1, 5, 120, 1))]


@pytest.mark.parametrize("shape,dtype", WIDE_STREAM)
def test_wide_stream_kernels_match_plain(cuda, shape, dtype):
    """The stream trio past d = 64, up to MAX_D (169 in float32, 120 in
    float64): the reference's widest stream shapes in float32, (128, 8,
    82), (64, 8, 116) and (32, 8, 165) (B a multiple of 128, 64 and 32);
    the factor's 16-byte plan to its edge (float32 d = 168, float64 119)
    and the scalar one past it (169, 120); the sweeps' diagonal blocks a
    stage from 3 (d = 65) to 6 (d = 161..169), the last one ragged or
    whole (d = 128), their chunks of 2 NB columns a block whole or
    ragged (K = 2, 16, 17, 22, 33 and spike's K = 2d = 164 at d = 82), B =
    1 at each dtype's widest. Lanes not positive definite from the middle
    stage on, as test_stream_kernels_match_plain."""
    B, T, d, K = shape
    _stream_matches_plain(cuda, B, T, d, K, dtype)


@pytest.mark.parametrize("d,dtype", [(65, torch.float32), (165, torch.float32), (169, torch.float32),
                                     (65, torch.float64), (119, torch.float64), (120, torch.float64)])
def test_wide_stream_factor_fails_in_its_last_panel(cuda, d, dtype):
    """factor_stream past d = 64 with lane 1's middle stage not positive
    definite at its last pivot only (its last diagonal entry -1e6: the
    stage fails in its last panel, after every other pivot passed): NaN
    over the lower triangle of L from that stage on and over M from it on,
    as the plain version; the other lanes match it."""
    B, T = 3, 5
    rng = np.random.default_rng(d)
    D, O, _ = tridiag_batch(rng, B, T, d)
    D[1, T // 2, -1, -1] = -1e6
    D, O = (torch.tensor(a, dtype=dtype, device=cuda) for a in (D, O))
    L, M = cuda_riccati.factor_stream(D, O)
    torch.cuda.synchronize()
    Lp, Mp = cuda_riccati.factor_stream_plain(D, O)
    stage_nan = lambda A: torch.isnan(A).flatten(2).any(-1).cpu().numpy()
    want = np.zeros((B, T), bool)
    want[1, T // 2:] = True
    assert (stage_nan(L) == want).all() and (stage_nan(Lp) == want).all()
    assert (stage_nan(M) == want[:, :-1]).all()
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    ok = torch.tensor(~want, device=cuda)
    assert _rel_err(L, Lp, ok) <= RTOL[dtype] and _rel_err(M, Mp, ok[:, :-1]) <= RTOL[dtype]


def _stream_matches_plain(cuda, B, T, d, K, dtype):
    rng = np.random.default_rng(T * 100 + d + K)
    bad_stage = T // 2
    bad = sorted({lane for lane in (2, B - 1) if lane < B}) if B > 1 else []
    D, O, _ = tridiag_batch(rng, B, T, d, non_pd=[(lane, bad_stage) for lane in bad])
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
    want[bad, bad_stage:] = True
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


@pytest.mark.parametrize(
    "B,T,d,dtype",
    [(6, 5, 65, torch.float32), (6, 5, 128, torch.float32), (6, 5, 165, torch.float32), (6, 5, 65, torch.float64),
     (3, 4, 170, torch.float32), (3, 4, 128, torch.float64), (3, 4, 256, torch.float32), (3, 4, 192, torch.float64)],
)
def test_solve_batched_past_the_fused_width(cuda, B, T, d, dtype):
    """The public solve_batched past d = 64, where the reference's fused
    Pallas kernel still answers: the fused kernel at every width (between
    d = 64 and MAX_D the card measured it faster than factor_stream +
    solve_stream; past MAX_D its panel in the workspace from d = 170 / 120),
    counted under its own key and never the scan; x matches the plain
    version, and lane 2, not positive definite from stage 2 on, is NaN over
    all of its x on both paths."""
    rng = np.random.default_rng(B + T + d)
    D, O, b = (torch.tensor(a, dtype=dtype, device=cuda) for a in tridiag_batch(rng, B, T, d, non_pd=((2, 2),)))
    before = dict(cuda_riccati.LAUNCHES)
    x = cuda_riccati.solve_batched(D, O, b)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in cuda_riccati.LAUNCHES.items() if v != before[k]}
    assert moved == {"solve_batched_fused": 1}
    xp = cuda_riccati.solve_batched_plain(D, O, b)
    assert torch.equal(torch.isnan(x), torch.isnan(xp)) and bool(torch.isnan(x[2]).all())
    ok = torch.tensor([i != 2 for i in range(B)], device=cuda)
    assert _rel_err(x, xp, ok) <= RTOL[dtype]


@pytest.mark.parametrize(
    "B,T,d,dtype",
    [(1, 1, 65, torch.float32), (1, 1, 121, torch.float64), (3, 5, 65, torch.float64), (5, 3, 100, torch.float32),
     (4, 2, 170, torch.float32), (3, 3, 240, torch.float32), (2, 3, 169, torch.float64), (1, 2, 256, torch.float32),
     (1, 8, 65, torch.float32), (4, 8, 65, torch.float32), (1, 8, 165, torch.float32), (4, 8, 165, torch.float32),
     (4, 5, 121, torch.float64), (2, 3, 168, torch.float32), (2, 3, 119, torch.float64), (2, 3, 33, torch.float32)],
)
def test_fused_solves_past_d_64(cuda, B, T, d, dtype):
    """solve_batched_fused and solve_batched_lanes past d = 32 in each of
    the kernel's plans: the stacked panel in shared memory with 16-byte
    loads (to d = 167 in float32, 118 in float64), with scalar loads (168
    and 169, 119), in the workspace past them ((4, 2, 170), (1, 1, 121),
    (4, 5, 121), (2, 3, 169) in float64, (3, 3, 240), (1, 2, 256)); B = 1
    and 4 at d = 65 and 165, T = 1 (O empty) among them: x against the
    plain version, each wrapper's launches its own (the lanes wrapper's
    two transposes beside its kernel); then the last lane not positive
    definite at its last stage: all of its x NaN, the other lanes
    untouched; then, where B > 1, the first lane not positive definite at
    its middle stage's last pivot only (the stage fails in its last panel):
    its x NaN too."""
    rng = np.random.default_rng(B + T + d)
    D, O, b = (torch.tensor(a, dtype=dtype, device=cuda) for a in tridiag_batch(rng, B, T, d))
    lanes = torch.ones(B, dtype=torch.bool, device=cuda)
    for bad in (0, 1, 2):
        if bad == 2 and B == 1:
            break
        if bad == 1:
            D[-1, -1] *= -1.0
            lanes[-1] = False
        if bad == 2:
            D[0, T // 2, -1, -1] = -1e6
            lanes[0] = False
        xp = cuda_riccati.solve_batched_plain(D, O, b)
        for name, want in (("solve_batched_fused", {"solve_batched_fused": 1}),
                           ("solve_batched_lanes", {"transpose": 2, "solve_batched_lanes": 1})):
            before = dict(cuda_riccati.LAUNCHES)
            x = getattr(cuda_riccati, name)(D, O, b)
            torch.cuda.synchronize()
            assert {k: v - before[k] for k, v in cuda_riccati.LAUNCHES.items() if v != before[k]} == want
            assert torch.equal(torch.isnan(x), torch.isnan(xp)) and bool(torch.isnan(x[~lanes]).all())
            assert bool(torch.isfinite(x[lanes]).all())
            if bool(lanes.any()):
                assert _rel_err(x, xp, lanes) <= RTOL[dtype]


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
        x = fn(torch.eye(65, device=cuda).repeat(1, 2, 1, 1), torch.zeros(1, 1, 65, 65, device=cuda),
               torch.ones(1, 2, 65, device=cuda))  # any width: past d = 64 a block a lane
        assert torch.equal(x, torch.ones(1, 2, 65, device=cuda))
        with pytest.raises(ValueError, match="int indices"):  # T d (d + 1) past 2^31 - 1 (B = 0: no memory)
            fn(torch.empty(0, 1, 46341, 46341, device=cuda), torch.empty(0, 0, 46341, 46341, device=cuda),
               torch.empty(0, 1, 46341, device=cuda))


def test_stream_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    D = torch.eye(4, device=cuda).repeat(3, 2, 1, 1)
    with pytest.raises(ValueError, match="shape"):
        cuda_riccati.factor_stream(D, torch.zeros(3, 2, 4, 4, device=cuda))
    with pytest.raises(ValueError, match="d <= 169"):
        cuda_riccati.factor_stream(
            torch.eye(170, device=cuda).repeat(1, 2, 1, 1), torch.zeros(1, 1, 170, 170, device=cuda)
        )
    with pytest.raises(ValueError, match="d <= 120"):
        cuda_riccati.solve_stream(
            torch.eye(121, device=cuda, dtype=torch.float64).repeat(1, 2, 1, 1),
            torch.zeros(1, 1, 121, 121, device=cuda, dtype=torch.float64),
            torch.ones(1, 2, 121, device=cuda, dtype=torch.float64),
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
