"""Batched Riccati kernels: the dense T=1 Cholesky factor and L L^T solve
(schur backend), and the block-tridiagonal factor and solve over T
stages (riccati backend).

`factor_t1` replaces the TPU kernel
`calipso_tpu/ops/pallas_riccati.py:_factor_lanes_t1_kernel`, `solve_t1`
replaces `_solve_lanes_t1_kernel`, `factor_lanes` replaces
`_factor_lanes_kernel` and `solve_lanes` replaces `_solve_lanes_kernel`.
All four are hand-written CUDA for Hopper (`csrc/riccati_t1.cu` and
`csrc/riccati_lanes.cu`: one warp per lane, staged in shared memory;
built by `ops/_build.py`).

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
from M_t on (what the reference scan gives by propagation).
"""

from __future__ import annotations

import torch

LAUNCHES = {"factor_t1": 0, "solve_t1": 0, "factor_lanes": 0, "solve_lanes": 0}
MAX_N = 128  # T=1 kernels
MAX_D = 64  # block-tridiagonal kernels
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
    `factor_lanes_plain`: the forward sweep u_t = L_t^{-1}(b_t -
    M_{t-1}^T u_{t-1}), then the backward sweep x_t = L_t^{-T}(u_t - M_t
    x_{t+1})."""
    T = L.shape[1]
    mv = lambda A, v: (A @ v[..., None])[..., 0]
    u, prev = [], None
    for t in range(T):
        r = b[:, t] if prev is None else b[:, t] - mv(M[:, t - 1].mT, prev)
        prev = torch.linalg.solve_triangular(L[:, t], r[..., None], upper=False)[..., 0]
        u.append(prev)
    x, nxt = [None] * T, None
    for t in reversed(range(T)):
        r = u[t] if nxt is None else u[t] - mv(M[:, t], nxt)
        nxt = torch.linalg.solve_triangular(L[:, t].mT, r[..., None], upper=True)[..., 0]
        x[t] = nxt
    return torch.stack(x, dim=1)


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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


def factor_lanes(D, O):
    """Block-tridiagonal Cholesky of D (B, T, d, d), O (B, T-1, d, d) ->
    (L, M) (see `factor_lanes_plain` and the module doc)."""
    if D.device.type == "cpu" and O.device.type == "cpu":
        return factor_lanes_plain(D, O)
    B, T, d = _lanes_dims(D)
    _check("D", D, D.dtype, (B, T, d, d))
    _check("O", O, D.dtype, (B, T - 1, d, d))
    if D.device != O.device:
        raise ValueError(f"D and O on different devices: {D.device}, {O.device}")
    L, M = torch.empty_like(D), torch.empty_like(O)
    if B > 0:
        _launch(
            "factor_lanes", "riccati_lanes", D.dtype, D.device,
            D.data_ptr(), O.data_ptr(), L.data_ptr(), M.data_ptr(), B, T, d,
        )
    return L, M


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
