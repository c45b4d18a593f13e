"""Batched T=1 Riccati kernels: dense Cholesky factor and L L^T solve.

`factor_t1` replaces the TPU kernel
`calipso_tpu/ops/pallas_riccati.py:_factor_lanes_t1_kernel` and
`solve_t1` replaces `_solve_lanes_t1_kernel`. Both are hand-written CUDA
for Hopper in `calipso_tpu_torch/csrc/riccati_t1.cu` (one warp per matrix,
staged in shared memory; built by `ops/_build.py`).

What bounds them on an H100: per factorization 2*n^2 elements are read
and written and n^3/3 flops are done, so at the flagship's n=32 the
factor is memory- and latency-bound (2.7 flops per float32 byte, far
below the card's balance point); the substitution moves n^2 + 2n elements
for n^2 flops. The design keeps each matrix in shared memory for the
whole factorization so device memory is touched once on the way in and
once on the way out.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes
the plain PyTorch version, a CUDA tensor launches the kernel (or raises
on a dtype, shape or layout the kernel does not take). `LAUNCHES` counts
kernel launches, one per wrapper call that launched.

A matrix that is not positive definite comes out with NaN over its whole
lower triangle on both paths: that is the inertia signal the solver's
inertia ladder reads, never an exception.
"""

from __future__ import annotations

import torch

LAUNCHES = {"factor_t1": 0, "solve_t1": 0}
MAX_N = 128
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def factor_t1_plain(S):
    """Lower Cholesky factors of a (B, n, n) batch; NaN over the lower
    triangle of every lane that is not positive definite."""
    L, info = torch.linalg.cholesky_ex(S)
    bad = (info > 0) | ~torch.isfinite(L).all(dim=-1).all(dim=-1)
    lower = torch.ones(S.shape[-2:], dtype=torch.bool, device=S.device).tril()
    L = torch.where(lower, L, torch.zeros((), dtype=S.dtype, device=S.device))
    nan = torch.full((), float("nan"), dtype=S.dtype, device=S.device)
    return torch.where(bad[:, None, None] & lower, nan, L)


def solve_t1_plain(L, b):
    """x with L L^T x = b, for L (B, n, n) lower and b (B, n)."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _dims(S):
    if S.dim() != 3 or S.shape[1] != S.shape[2]:
        raise ValueError(f"expected a (B, n, n) batch, got {tuple(S.shape)}")
    B, n = S.shape[0], S.shape[1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the T=1 kernels take 1 <= n <= {MAX_N}, got n={n}")
    if S.dtype not in _SUFFIX:
        raise TypeError(f"the T=1 kernels take float32 or float64, got {S.dtype}")
    return B, n


def factor_t1(S):
    """Batched lower Cholesky of S (B, n, n) (see module doc)."""
    if S.device.type == "cpu":
        return factor_t1_plain(S)
    B, n = _dims(S)
    _check("S", S, S.dtype, (B, n, n))
    L = torch.empty_like(S)
    if B == 0:
        return L
    from calipso_tpu_torch.ops import _build

    fn = getattr(_build.load(), f"calipso_factor_t1_{_SUFFIX[S.dtype]}")
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream(S.device).cuda_stream
        err = fn(S.data_ptr(), L.data_ptr(), B, n, stream)
    if err != 0:
        raise RuntimeError(f"factor_t1 launch failed: CUDA error {err}")
    LAUNCHES["factor_t1"] += 1
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
    if B == 0:
        return x
    from calipso_tpu_torch.ops import _build

    fn = getattr(_build.load(), f"calipso_solve_t1_{_SUFFIX[L.dtype]}")
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream(L.device).cuda_stream
        err = fn(L.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, stream)
    if err != 0:
        raise RuntimeError(f"solve_t1 launch failed: CUDA error {err}")
    LAUNCHES["solve_t1"] += 1
    return x
