"""Batched Riccati kernels: the dense T=1 Cholesky factor and L L^T solve
(schur backend), the block-tridiagonal factor and solve over T stages
(riccati backend), and the fused block-tridiagonal solve
`solve_batched`.

`factor_t1` replaces the TPU kernel
`calipso_tpu/ops/pallas_riccati.py:_factor_lanes_t1_kernel` (`:633`; its
`pallas_call` at `:704`), `solve_t1` replaces `_solve_lanes_t1_kernel`
(`:661`; `:764`) (`csrc/riccati_t1.cu`: up to n = 32 a warp a system,
thread i holding row i in registers, on a grid of resident warps that
walk the batch with the next system's lower triangle copied ahead, the
factor by a shuffle a pivot and a shuffle an l_jk, the solve's two sweeps
by shuffles; for n in 33..128 a thread block a system, the lower 32 x 32
blocks in shared memory, the factor right-looking in 32-wide panels --
each warp factors the diagonal block and its own strip below it by
shuffles, then the block's threads share the trailing update in 4 x 4
register tiles, two barriers a panel -- and the solve a blocked
substitution, each diagonal block solved by one warp by shuffles and the
rest of the right-hand side updated by all threads). `factor_lanes`
replaces `_factor_lanes_kernel` and `solve_lanes` replaces
`_solve_lanes_kernel` (`csrc/riccati_lanes.cu`: one warp per lane; up to
d = 32 thread i holds row i in registers and `factor_lanes` factors the
stacked panel [S_t ; O_t] into L_t and M_t' at once, past that the stage
is staged in shared memory; the lanes kernels copy their stage blocks a
few stages ahead, and the solve keeps u on chip between its two sweeps).
`factor_stream` replaces `_factor_stream_kernel` and `solve_stream`
replaces `_solve_fwd_stream_kernel` and `_solve_bwd_stream_kernel`
(`csrc/riccati_stream.cu`: the factor a blocked factor of the stacked
panel [S_t ; O_t] by one thread block per lane, each sweep one warp per
right-hand-side column; the next stage's blocks copied into shared
memory while the current one computes). `solve_batched_fused` replaces
`_riccati_kernel` and `solve_batched_lanes` replaces
`_riccati_lanes_kernel` (`csrc/riccati_fused.cu`: factor and both sweeps
in one kernel template that takes the batch-first (B, T, d, d) arrays of
the first or the batch-last (T, d, d, B) copies the second makes -- up to
d = 32 a warp a lane, `factor_lanes`' register stage with the forward
sweep folded in and L_t, M_t and u_t kept for the backward sweep, past
that a thread block a lane at any width, each stage the Cholesky of the
stacked panel [S_t ; O_t ; r_t'] that also gives the forward sweep as its
last row (`csrc/riccati_wide.cuh`, the stage `factor_stream` runs past d
= 64), the panel in shared memory where it fits, else in the
device-memory workspace that keeps L_t and M_t' for the backward sweep;
the batch-last copies
and x's way back are `batch_last` and `batch_first`, one launch each of a
tiled transpose kernel, the layout moves the reference leaves to XLA);
`solve_batched`, the public entry point, takes the first on CUDA tensors,
as the reference does off the CPU, at every width; no solver path calls
it.
All are hand-written CUDA for Hopper, built by `ops/_build.py`. The
register kernels share their device code (`csrc/riccati_reg.cuh`). The
stream kernels are the wide-stage route (d >= 33, `ops/riccati.route`),
and their solve takes K right-hand sides per lane. The T=1 kernels take n
<= `MAX_N[dtype]` (288 in float32, 192 in float64: past n = 128 a wide
instance of the panel kernels, 8 warps a block), the stream kernels d <=
`MAX_D[dtype]` (169 and 120: past d = 64 wide instances, the factor the
stage of `csrc/riccati_wide.cuh` with its stacked panel alone in shared
memory, the sweeps blocked substitutions over ceil(d/32) diagonal
blocks of 32 rows, L_t and M read from device memory), the lanes kernels d <=
`LANES_MAX_D` = 64; wider systems take the library and scan routes of
`ops/riccati`, chosen there from the shape and dtype. The fused solves
take any d whose T d (d + 1) fits their int indices (`FUSED_MAX_INDEX`).

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
kernel launches, one per wrapper call that launched, and, under the
`*_library` and `*_scan` keys, the calls of `ops/riccati`'s routes past
the kernels' widths on CUDA tensors (and `solve_t1_multi_library`, its
K-column schur solve).

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
    "solve_batched_fused": 0, "solve_batched_lanes": 0, "transpose": 0,
    # the library and scan routes of ops/riccati, past MAX_N and MAX_D
    "factor_t1_library": 0, "solve_t1_library": 0, "factor_scan": 0, "solve_scan": 0,
    # the schur backend's K-column solve (two triangular solves, any n)
    "solve_t1_multi_library": 0,
}
# The widest systems the kernels take, per dtype, set by shared memory
# alone (a block's 227 KB on an H100):
# - T=1 (csrc/riccati_t1.cu, wide_panels): the lower 32 x 32 blocks of P
#   panels at a row stride of 32 words + 16 B, and the solve's u, P(P+1)/2
#   32 (32 + 16/w) w + 32 P w bytes for a word of w bytes: float32 P = 9,
#   n <= 288 (208,512 B; P = 10 takes 254,720 B), float64 P = 6, n <= 192
#   (184,320 B; P = 7 takes 245,504 B).
# - block-tridiagonal, the stream kernels (csrc/riccati_stream.cu,
#   wide_max_d): the factor's stacked panel [S_t ; O_t], 2d rows of d | 1
#   words and a 16-byte flag: float32 d <= 169 (228,504 B), float64 d <=
#   120 (232,336 B). The lanes
#   kernels take d <= LANES_MAX_D.
# The fused solves (csrc/riccati_fused.cu) have no width limit: past d =
# 32 the stacked panel moves from shared memory to the device-memory
# workspace past d = 169 in float32, 119 in float64. Their int indices
# bound T d (d + 1) (shape_ok there).
MAX_N = {torch.float32: 288, torch.float64: 192}
MAX_D = {torch.float32: 169, torch.float64: 120}
LANES_MAX_D = 64  # factor_lanes, solve_lanes (csrc/riccati_lanes.cu)
FUSED_MAX_INDEX = 2**31 - 1  # T d (d + 1) of the fused solves and their transposes
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


def _dtype_ok(dtype, kernels):
    if dtype not in _SUFFIX:
        raise TypeError(f"the {kernels} kernels take float32 or float64, got {dtype}")


def _n_ok(n, dtype):
    _dtype_ok(dtype, "T=1")
    if not 1 <= n <= MAX_N[dtype]:
        raise ValueError(f"the T=1 kernels take 1 <= n <= {MAX_N[dtype]} in {dtype}, got n={n}")


def _dims(S):
    if S.dim() != 3 or S.shape[1] != S.shape[2]:
        raise ValueError(f"expected a (B, n, n) batch, got {tuple(S.shape)}")
    B, n = S.shape[0], S.shape[1]
    _n_ok(n, S.dtype)
    return B, n


def _fused_fits(T, d):
    if d < 1 or T * d * (d + 1) > FUSED_MAX_INDEX:
        raise ValueError(
            f"the fused solves take d >= 1 and T d (d + 1) <= {FUSED_MAX_INDEX} (their int indices), got T={T}, d={d}"
        )


def _lanes_dims(L, kernels="lanes"):
    """(B, T, d) of a (B, T, d, d) batch that the `kernels` ("lanes",
    "stream", or "fused": the fused solves) take."""
    if L.dim() != 4 or L.shape[2] != L.shape[3] or L.shape[1] < 1:
        raise ValueError(f"expected a (B, T, d, d) batch with T >= 1, got {tuple(L.shape)}")
    B, T, d = L.shape[0], L.shape[1], L.shape[2]
    _dtype_ok(L.dtype, "block-tridiagonal")
    if kernels == "fused":
        _fused_fits(T, d)
        return B, T, d
    widest = {"lanes": LANES_MAX_D, "stream": MAX_D[L.dtype]}[kernels]
    if not 1 <= d <= widest:
        raise ValueError(f"the {kernels} kernels take 1 <= d <= {widest} in {L.dtype}, got d={d}")
    return B, T, d


def _launch(name, stem, dtype, device, *args, entry=None):
    """Launch C entry point `calipso_<entry>_<dtype>` (entry: `name`) of
    csrc/<stem>.cu on the current stream, counted under `name`; raise if
    the launch failed."""
    from calipso_tpu_torch.ops import _build

    fn = getattr(_build.load(stem), f"calipso_{entry or name}_{_SUFFIX[dtype]}")
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


def _t1_layout(name, dtype, n):
    import ctypes

    from calipso_tpu_torch.ops import _build

    _n_ok(n, dtype)
    fn = getattr(_build.load("riccati_t1"), f"calipso_{name}_layout_{_SUFFIX[dtype]}")
    warps, blocks = ctypes.c_int(), ctypes.c_int()
    err = fn(n, ctypes.byref(warps), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{name} layout query failed: CUDA error {err}")
    return warps.value, blocks.value


def factor_t1_layout(dtype, n):
    """(warps a block, resident blocks an SM) of the `factor_t1` kernel
    at width n on the current CUDA device."""
    return _t1_layout("factor_t1", dtype, n)


def solve_t1_layout(dtype, n):
    """(warps a block, resident blocks an SM) of the `solve_t1` kernel
    at width n on the current CUDA device."""
    return _t1_layout("solve_t1", dtype, n)


def _tridiag_factor(name, stem, plain, D, O):
    """Launch a block-tridiagonal factor kernel (CPU tensors: `plain`)."""
    if D.device.type == "cpu" and O.device.type == "cpu":
        return plain(D, O)
    B, T, d = _lanes_dims(D, "stream" if stem == "riccati_stream" else "lanes")
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
    B, T, d = _lanes_dims(L, "stream")
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


def _batched_args(D, O, b, kernels="fused"):
    B, T, d = _lanes_dims(D, kernels)
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


def _solve_fused(name, D, O, b, x, B, T, d, entry=None, extra=()):
    """Launch the fused solve `name` (C entry point `entry`, default
    `name`; `extra` pointers before the stream) on D, O and b into x (in
    the layout of its entry point), with the workspace the kernel asks
    for, if any."""
    from calipso_tpu_torch.ops import _build

    query = getattr(_build.load("riccati_fused"), f"calipso_solve_batched_fused_workspace_{_SUFFIX[D.dtype]}")
    with torch.cuda.device(D.device):
        words = query(T, d)
    if words < 0:
        raise RuntimeError(f"{name} workspace query failed: CUDA error {-words}")
    work = torch.empty(B * words, dtype=D.dtype, device=D.device) if words else None
    _launch(
        name, "riccati_fused", D.dtype, D.device,
        D.data_ptr(), O.data_ptr(), b.data_ptr(), x.data_ptr(),
        None if work is None else work.data_ptr(), B, T, d, *extra, entry=entry,
    )


def solve_batched_fused(D, O, b):
    """x (B, T, d) of `solve_batched_plain` in one kernel at any width,
    one warp per lane up to d = 32 and one thread block per lane past it;
    L and M stay in shared memory where the horizon fits (d <= 32), else in
    a workspace this wrapper allocates, the size the kernel asks for (past
    d = 32 also the stage's panel where it does not fit in shared
    memory)."""
    if _on_cpu(D, O, b):
        return solve_batched_plain(D, O, b)
    B, T, d = _batched_args(D, O, b)
    x = torch.empty_like(b)
    if B > 0:
        _solve_fused("solve_batched_fused", D, O, b, x, B, T, d)
    return x


def batch_last_plain(D, O, b):
    """The reference's batch-last layout of D (B, T, d, d), O (B, T-1, d,
    d) and b (B, T, d): contiguous D (T, d, d, B), O' (T-1, d, d, B) with
    O'_t = O_t', and b (T, d, B)."""
    return D.permute(1, 2, 3, 0).contiguous(), O.permute(1, 3, 2, 0).contiguous(), b.permute(1, 2, 0).contiguous()


def batch_first_plain(x):
    """x (B, T, d) of the batch-last x (T, d, B)."""
    return x.permute(2, 0, 1).contiguous()


def batch_last(D, O, b):
    """`batch_last_plain` of CUDA tensors by the transpose kernel, one
    launch for the three (CPU tensors: the plain version)."""
    if _on_cpu(D, O, b):
        return batch_last_plain(D, O, b)
    B, T, d = _batched_args(D, O, b)
    return _batch_last(D, O, b, B, T, d)


def _batch_last(D, O, b, B, T, d):
    out = (D.new_empty(T, d, d, B), O.new_empty(T - 1, d, d, B), b.new_empty(T, d, B))
    if B > 0:
        _launch(
            "transpose", "riccati_fused", D.dtype, D.device,
            D.data_ptr(), O.data_ptr(), b.data_ptr(), *(a.data_ptr() for a in out), B, T, d, entry="batch_last",
        )
    return out


def batch_first(x):
    """`batch_first_plain` of a CUDA tensor by the transpose kernel (a CPU
    tensor: the plain version)."""
    if x.device.type == "cpu":
        return batch_first_plain(x)
    if x.dim() != 3 or x.shape[0] < 1:
        raise ValueError(f"expected a batch-last (T, d, B) x with T >= 1, got {tuple(x.shape)}")
    _fused_fits(x.shape[0], x.shape[1])
    _dtype_ok(x.dtype, "block-tridiagonal")
    _check_device("x", x)
    T, d, B = x.shape
    return _batch_first(x, B, T, d)


def _batch_first(x, B, T, d):
    out = x.new_empty(B, T, d)
    if B > 0:
        _launch("transpose", "riccati_fused", x.dtype, x.device, x.data_ptr(), out.data_ptr(), B, T, d, entry="batch_first")
    return out


def solve_batched_lanes(D, O, b):
    """x (B, T, d) of `solve_batched_plain` by the kernel of
    `solve_batched_fused` on the reference's batch-last layout: the copies
    of `batch_last` made here, x (T, d, B) back by `batch_first`."""
    if _on_cpu(D, O, b):
        return solve_batched_plain(D, O, b)
    B, T, d = _batched_args(D, O, b)
    if B == 0:
        return torch.empty_like(b)
    Dl, OTl, bl = _batch_last(D, O, b, B, T, d)
    xl = torch.empty_like(bl)
    _solve_fused("solve_batched_lanes", Dl, OTl, bl, xl, B, T, d)
    return _batch_first(xl, B, T, d)


# The parts of the wide stage's clock (csrc/riccati_wide.cuh, wide::Stamps)
WIDE_PARTS = (
    "Schur update", "panels (diagonal blocks, strips)", "trailing updates", "stores",
    "backward coupling", "backward substitution",
)


def wide_parts(name, D, O, b=None):
    """The split of one launch of `factor_stream` past d = 64 (`name`
    "factor_stream") or of `solve_batched_fused` past d = 32
    ("solve_batched_fused", right-hand side b) on CUDA tensors: the kernel
    launched once with its clock stamps on (each part the block's cycles
    between two of its barriers, summed over the stages), counted under
    `name`. Returns {part: cycles a lane} (the first four parts for the
    factor, all six for the fused solve). chip_smoke.py prints it; no path
    calls it."""
    fused = name == "solve_batched_fused"
    B, T, d = _batched_args(D, O, b) if fused else _lanes_dims(D, "stream")
    if d <= (32 if fused else 64):
        raise ValueError(f"{name} has its parts' clock past d = {32 if fused else 64}, got d={d}")
    parts = torch.zeros(len(WIDE_PARTS), dtype=torch.int64, device=D.device)
    if fused:
        x = torch.empty_like(b)
        _solve_fused(name, D, O, b, x, B, T, d, entry="solve_batched_fused_parts", extra=(parts.data_ptr(),))
    else:
        _check("D", D, D.dtype, (B, T, d, d))
        _check("O", O, D.dtype, (B, T - 1, d, d))
        L, M = torch.empty_like(D), torch.empty_like(O)
        _launch(name, "riccati_stream", D.dtype, D.device, D.data_ptr(), O.data_ptr(), L.data_ptr(), M.data_ptr(),
                B, T, d, parts.data_ptr(), entry="factor_stream_parts")
    cycles = parts.cpu().tolist()[: 6 if fused else 4]
    return {k: v / max(B, 1) for k, v in zip(WIDE_PARTS, cycles)}


def solve_batched(D, O, b):
    """Batched block-tridiagonal solve, D (B, T, d, d), O (B, T-1, d, d),
    b (B, T, d) -> x (B, T, d): the plain version for CPU tensors, the
    fused kernel for CUDA tensors at every width (the reference's choice
    off the CPU, whose fused Pallas kernel takes any width). Between d = 64
    and MAX_D, where factor_stream + solve_stream also take the system, the
    fused kernel was measured faster on an NVIDIA H100 80GB HBM3 at 700 W
    (an A/B of the two replayed from a CUDA graph, float32): (128, 8, 82)
    0.3696 against 0.4458 ms, (64, 8, 116) 0.6170 against 0.7383, (32, 8,
    165) 1.1725 against 2.0504, (4, 5, 65) 0.1601 against 0.2371 (float64
    0.2132 against 0.2778). No width takes the scan."""
    return solve_batched_fused(D, O, b)
