"""Batched Riccati kernels: the dense T=1 Cholesky factor and L L^T solve
(schur backend), the block-tridiagonal factor and solve over T stages
(riccati backend), and the fused block-tridiagonal solve
`solve_batched`.

`factor_t1` replaces the TPU kernel
`calipso_tpu/ops/pallas_riccati.py:_factor_lanes_t1_kernel`, `solve_t1`
replaces `_solve_lanes_t1_kernel`, `factor_lanes` replaces
`_factor_lanes_kernel` and `solve_lanes` replaces `_solve_lanes_kernel`
(`csrc/riccati_t1.cu` and `csrc/riccati_lanes.cu`: one warp per lane,
staged in shared memory; the solve copies its stage blocks a few steps
ahead and keeps u on chip between its two sweeps). `factor_stream`
replaces `_factor_stream_kernel` and `solve_stream` replaces
`_solve_fwd_stream_kernel` and `_solve_bwd_stream_kernel`
(`csrc/riccati_stream.cu`: the factor a blocked factor of the stacked
panel [S_t ; O_t] by one thread block per lane, each sweep one warp per
right-hand-side column; the next stage's blocks copied into shared
memory while the current one computes). `solve_batched_fused`
replaces `_riccati_kernel` and `solve_batched_lanes` replaces
`_riccati_lanes_kernel`
(`csrc/riccati_fused.cu`: factor and both sweeps in one kernel, one
thread block per lane with the horizon's factor in shared memory where
it fits, or one thread per lane on (T, d, d, B) arrays); `solve_batched`,
the public entry point, takes the first on CUDA tensors, as the
reference does off the CPU, and no solver path calls it. All are
hand-written CUDA for Hopper, built by `ops/_build.py`. The stream
kernels are the wide-stage route (d >= 32, `ops/riccati.route`), and
their solve takes K right-hand sides per lane.

What bounds them on an H100: each reads its inputs once and writes its
outputs once, and does few flops per byte (the T=1 factor at n=32: 2.7
flops per float32 byte; the block-tridiagonal factor at d=9: 1.9), far
below the card's balance point, so memory traffic bounds them in
principle; the chain of dependent pivot steps makes them latency-bound in
practice. The designs keep each lane's working set in shared memory so
device memory is touched once on the way in and once on the way out.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes
the plain PyTorch version, a CUDA tensor launches the kernel (or raises
on a dtype, shape or layout the kernel does not take). `LAUNCHES` counts
kernel launches, one per wrapper call that launched.

A matrix that is not positive definite comes out with NaN over its whole
lower triangle on both paths: that is the inertia signal the solver's
inertia ladder reads, never an exception. In the block-tridiagonal
factor, a stage t whose Schur block is not positive definite puts NaN
over the lower triangle of L_t and of every later L, and over every M
from M_t on (what the reference scan gives by propagation); the fused
solve puts NaN over all of that lane's x.
"""

from __future__ import annotations

import torch

LAUNCHES = {
    "factor_t1": 0, "solve_t1": 0, "factor_lanes": 0, "solve_lanes": 0,
    "factor_stream": 0, "solve_fwd_stream": 0, "solve_bwd_stream": 0,
    "solve_batched_fused": 0, "solve_batched_lanes": 0,
}
MAX_N = 128  # T=1 kernels
MAX_D = 64  # block-tridiagonal kernels (lanes and stream)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _lower(n, like):
    return torch.ones((n, n), dtype=torch.bool, device=like.device).tril()


def _nan(like):
    return torch.full((), float("nan"), dtype=like.dtype, device=like.device)


def factor_t1_plain(S):
    """Lower Cholesky factors of a (B, n, n) batch; NaN over the lower
    triangle of every lane that is not positive definite."""
    L, info = torch.linalg.cholesky_ex(S)
    bad = (info > 0) | ~torch.isfinite(L).all(dim=-1).all(dim=-1)
    lower = _lower(S.shape[-1], S)
    L = torch.where(lower, L, torch.zeros((), dtype=S.dtype, device=S.device))
    return torch.where(bad[:, None, None] & lower, _nan(S), L)


def solve_t1_plain(L, b):
    """x with L L^T x = b, for L (B, n, n) lower and b (B, n)."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def factor_lanes_plain(D, O):
    """Block-tridiagonal Cholesky of D (B, T, d, d) diagonal and O
    (B, T-1, d, d) sub-diagonal blocks: L (B, T, d, d) lower and M
    (B, T-1, d, d) with M_t = L_t^{-1} O_t^T, by a loop over the stages
    (S_t = D_t - M_{t-1}^T M_{t-1}, L_t = chol(S_t)). NaN from the first
    stage that is not positive definite on (see module doc)."""
    T, d = D.shape[1], D.shape[-1]
    lower = _lower(d, D)
    zero = torch.zeros((), dtype=D.dtype, device=D.device)
    L, M = torch.empty_like(D), torch.empty_like(O)
    bad = torch.zeros(D.shape[0], dtype=torch.bool, device=D.device)
    M_prev = None
    for t in range(T):
        S = D[:, t] if M_prev is None else D[:, t] - M_prev.mT @ M_prev
        L_t, info = torch.linalg.cholesky_ex(S)
        bad = bad | (info > 0) | ~torch.isfinite(L_t).flatten(1).all(dim=1)
        L_t = torch.where(lower, L_t, zero)
        L[:, t] = torch.where(bad[:, None, None] & lower, _nan(D), L_t)
        if t < T - 1:
            M_prev = torch.linalg.solve_triangular(L_t, O[:, t].mT, upper=False)
            M[:, t] = torch.where(bad[:, None, None], _nan(D), M_prev)
    return L, M


def solve_lanes_plain(L, M, b):
    """x (B, T, d) with S x = b for the factor (L, M) of
    `factor_lanes_plain`: the two sweeps of the stream versions below,
    on one column."""
    return solve_bwd_stream_plain(L, M, solve_fwd_stream_plain(L, M, b[..., None]))[..., 0]


# the stream factor computes what the lanes factor computes; only the
# kernels differ (one thread block per lane instead of one warp)
factor_stream_plain = factor_lanes_plain


def solve_fwd_stream_plain(L, M, b):
    """The forward sweep u_t = L_t^{-1}(b_t - M_{t-1}^T u_{t-1}) for b
    (B, T, d, K): K right-hand sides per lane, one factor for all."""
    T = L.shape[1]
    u, prev = [], None
    for t in range(T):
        r = b[:, t] if prev is None else b[:, t] - M[:, t - 1].mT @ prev
        prev = torch.linalg.solve_triangular(L[:, t], r, upper=False)
        u.append(prev)
    return torch.stack(u, dim=1)


def solve_bwd_stream_plain(L, M, u):
    """The backward sweep x_t = L_t^{-T}(u_t - M_t x_{t+1}) for u
    (B, T, d, K) from `solve_fwd_stream_plain`."""
    T = L.shape[1]
    x, nxt = [None] * T, None
    for t in reversed(range(T)):
        r = u[:, t] if nxt is None else u[:, t] - M[:, t] @ nxt
        nxt = torch.linalg.solve_triangular(L[:, t].mT, r, upper=True)
        x[t] = nxt
    return torch.stack(x, dim=1)


def _check_type(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_device(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(name, t, dtype, shape):
    _check_type(name, t, dtype, shape)
    _check_device(name, t)


def _dtype_ok(t, kernels):
    if t.dtype not in _SUFFIX:
        raise TypeError(f"the {kernels} kernels take float32 or float64, got {t.dtype}")


def _dims(S):
    if S.dim() != 3 or S.shape[1] != S.shape[2]:
        raise ValueError(f"expected a (B, n, n) batch, got {tuple(S.shape)}")
    B, n = S.shape[0], S.shape[1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the T=1 kernels take 1 <= n <= {MAX_N}, got n={n}")
    _dtype_ok(S, "T=1")
    return B, n


def _lanes_dims(L):
    if L.dim() != 4 or L.shape[2] != L.shape[3] or L.shape[1] < 1:
        raise ValueError(f"expected a (B, T, d, d) batch with T >= 1, got {tuple(L.shape)}")
    B, T, d = L.shape[0], L.shape[1], L.shape[2]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the block-tridiagonal kernels take 1 <= d <= {MAX_D}, got d={d}")
    _dtype_ok(L, "block-tridiagonal")
    return B, T, d


def _launch(name, stem, dtype, device, *args):
    """Launch C entry point `calipso_<name>_<dtype>` of csrc/<stem>.cu on
    the current stream; raise if the launch failed."""
    from calipso_tpu_torch.ops import _build

    fn = getattr(_build.load(stem), f"calipso_{name}_{_SUFFIX[dtype]}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def factor_t1(S):
    """Batched lower Cholesky of S (B, n, n) (see module doc)."""
    if S.device.type == "cpu":
        return factor_t1_plain(S)
    B, n = _dims(S)
    _check("S", S, S.dtype, (B, n, n))
    L = torch.empty_like(S)
    if B > 0:
        _launch("factor_t1", "riccati_t1", S.dtype, S.device, S.data_ptr(), L.data_ptr(), B, n)
    return L


def solve_t1(L, b):
    """x with L L^T x = b for L (B, n, n) lower, b (B, n)."""
    if L.device.type == "cpu" and b.device.type == "cpu":
        return solve_t1_plain(L, b)
    B, n = _dims(L)
    _check("L", L, L.dtype, (B, n, n))
    _check("b", b, L.dtype, (B, n))
    if L.device != b.device:
        raise ValueError(f"L and b on different devices: {L.device}, {b.device}")
    x = torch.empty_like(b)
    if B > 0:
        _launch(
            "solve_t1", "riccati_t1", L.dtype, L.device,
            L.data_ptr(), b.data_ptr(), x.data_ptr(), B, n,
        )
    return x


def _tridiag_factor(name, stem, plain, D, O):
    """Launch a block-tridiagonal factor kernel (CPU tensors: `plain`)."""
    if D.device.type == "cpu" and O.device.type == "cpu":
        return plain(D, O)
    B, T, d = _lanes_dims(D)
    _check("D", D, D.dtype, (B, T, d, d))
    _check("O", O, D.dtype, (B, T - 1, d, d))
    if D.device != O.device:
        raise ValueError(f"D and O on different devices: {D.device}, {O.device}")
    L, M = torch.empty_like(D), torch.empty_like(O)
    if B > 0:
        _launch(name, stem, D.dtype, D.device, D.data_ptr(), O.data_ptr(), L.data_ptr(), M.data_ptr(), B, T, d)
    return L, M


def factor_lanes(D, O):
    """Block-tridiagonal Cholesky of D (B, T, d, d), O (B, T-1, d, d) ->
    (L, M), one warp per lane (see `factor_lanes_plain` and the module
    doc)."""
    return _tridiag_factor("factor_lanes", "riccati_lanes", factor_lanes_plain, D, O)


def solve_lanes(L, M, b):
    """x (B, T, d) with S x = b for the factor (L, M) of `factor_lanes`
    and b (B, T, d)."""
    if L.device.type == "cpu" and M.device.type == "cpu" and b.device.type == "cpu":
        return solve_lanes_plain(L, M, b)
    B, T, d = _lanes_dims(L)
    _check("L", L, L.dtype, (B, T, d, d))
    _check("M", M, L.dtype, (B, T - 1, d, d))
    _check("b", b, L.dtype, (B, T, d))
    if not L.device == M.device == b.device:
        raise ValueError(f"L, M and b on different devices: {L.device}, {M.device}, {b.device}")
    x = torch.empty_like(b)
    if B > 0:
        _launch(
            "solve_lanes", "riccati_lanes", L.dtype, L.device,
            L.data_ptr(), M.data_ptr(), b.data_ptr(), x.data_ptr(), B, T, d,
        )
    return x


def factor_stream(D, O):
    """Block-tridiagonal Cholesky of D (B, T, d, d), O (B, T-1, d, d) ->
    (L, M), one thread block per lane (same contract as `factor_lanes`)."""
    return _tridiag_factor("factor_stream", "riccati_stream", factor_stream_plain, D, O)


def _sweep(name, plain, L, M, b):
    """Launch one of the stream solve sweeps on b (B, T, d, K) (CPU
    tensors: `plain`)."""
    if L.device.type == "cpu" and M.device.type == "cpu" and b.device.type == "cpu":
        return plain(L, M, b)
    B, T, d = _lanes_dims(L)
    if b.dim() != 4:
        raise ValueError(f"the right-hand sides must be (B, T, d, K), got {tuple(b.shape)}")
    K = b.shape[-1]
    _check("L", L, L.dtype, (B, T, d, d))
    _check("M", M, L.dtype, (B, T - 1, d, d))
    _check("b", b, L.dtype, (B, T, d, K))
    if not L.device == M.device == b.device:
        raise ValueError(f"L, M and b on different devices: {L.device}, {M.device}, {b.device}")
    out = torch.empty_like(b)
    if B > 0 and K > 0:
        _launch(
            name, "riccati_stream", L.dtype, L.device,
            L.data_ptr(), M.data_ptr(), b.data_ptr(), out.data_ptr(), B, T, d, K,
        )
    return out


def solve_fwd_stream(L, M, b):
    """The forward sweep u of `solve_fwd_stream_plain` for b (B, T, d, K)."""
    return _sweep("solve_fwd_stream", solve_fwd_stream_plain, L, M, b)


def solve_bwd_stream(L, M, u):
    """The backward sweep x of `solve_bwd_stream_plain` from u (B, T, d, K)."""
    return _sweep("solve_bwd_stream", solve_bwd_stream_plain, L, M, u)


def solve_stream(L, M, b):
    """x with S x = b for the factor (L, M) of `factor_stream` (or
    `factor_lanes`): b (B, T, d), or (B, T, d, K) for K right-hand sides
    per lane. Two kernels: the forward sweep into u, the backward sweep
    from it."""
    vec = b.dim() == 3
    bk = b[..., None] if vec else b
    x = solve_bwd_stream(L, M, solve_fwd_stream(L, M, bk))
    return x[..., 0] if vec else x


def solve_batched_plain(D, O, b):
    """x (B, T, d) with S x = b for the block-tridiagonal S of D (B, T, d,
    d) and O (B, T-1, d, d): `factor_lanes_plain` then `solve_lanes_plain`
    (the reference's CPU branch of `solve_batched`, its scan factor and
    solve under `vmap`). A lane that is not positive definite comes out
    with NaN over all of its x: the NaN of the failed stage runs through
    both sweeps."""
    L, M = factor_lanes_plain(D, O)
    return solve_lanes_plain(L, M, b)


def _batched_args(D, O, b):
    B, T, d = _lanes_dims(D)
    args = (("D", D, (B, T, d, d)), ("O", O, (B, T - 1, d, d)), ("b", b, (B, T, d)))
    for name, t, shape in args:
        _check_type(name, t, D.dtype, shape)
    for name, t, _ in args:
        _check_device(name, t)
    if not D.device == O.device == b.device:
        raise ValueError(f"D, O and b on different devices: {D.device}, {O.device}, {b.device}")
    return B, T, d


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


def solve_batched_fused(D, O, b):
    """x (B, T, d) of `solve_batched_plain` in one kernel, one thread block
    per lane; L and M stay in shared memory where the horizon fits, else
    in a workspace this wrapper allocates (the kernel says which)."""
    if _on_cpu(D, O, b):
        return solve_batched_plain(D, O, b)
    from calipso_tpu_torch.ops import _build

    B, T, d = _batched_args(D, O, b)
    x = torch.empty_like(b)
    if B > 0:
        query = getattr(_build.load("riccati_fused"), f"calipso_solve_batched_fused_workspace_{_SUFFIX[D.dtype]}")
        with torch.cuda.device(D.device):
            words = query(T, d)
        if words < 0:
            raise RuntimeError(f"solve_batched_fused workspace query failed: CUDA error {-words}")
        work = torch.empty(B * words, dtype=D.dtype, device=D.device) if words else None
        _launch(
            "solve_batched_fused", "riccati_fused", D.dtype, D.device,
            D.data_ptr(), O.data_ptr(), b.data_ptr(), x.data_ptr(),
            None if work is None else work.data_ptr(), B, T, d,
        )
    return x


def solve_batched_lanes(D, O, b):
    """x (B, T, d) of `solve_batched_plain` in one kernel, one thread per
    lane on (T, d, d, B) copies made here (the transposed O as (T-1, d, d,
    B)), which the kernel factors in place; x comes back as (B, T, d)."""
    if _on_cpu(D, O, b):
        return solve_batched_plain(D, O, b)
    B, T, d = _batched_args(D, O, b)
    Dl = D.permute(1, 2, 3, 0).contiguous()
    OTl = O.permute(1, 3, 2, 0).contiguous()
    bl = b.permute(1, 2, 0).contiguous()
    xl = torch.empty_like(bl)
    if B > 0:
        _launch(
            "solve_batched_lanes", "riccati_fused", D.dtype, D.device,
            Dl.data_ptr(), OTl.data_ptr(), bl.data_ptr(), xl.data_ptr(), B, T, d,
        )
    return xl.permute(2, 0, 1).contiguous()


def solve_batched(D, O, b):
    """Batched block-tridiagonal solve, D (B, T, d, d), O (B, T-1, d, d),
    b (B, T, d) -> x (B, T, d): the plain version for CPU tensors, the
    fused kernel for CUDA tensors (the reference's choice off the CPU)."""
    return solve_batched_fused(D, O, b)
