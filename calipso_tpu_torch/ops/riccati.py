"""Cholesky factor and solve of the primal Schur complement, batch-first:
the counterpart of `calipso_tpu/ops/riccati.py`.

- `chol`/`chol_solve` (the schur backend; `chol_cv`, `chol_solve_cv` in
  the reference): the dense T=1 case, S (B, n, n) and b (B, n).
- `factor`/`solve` (the riccati backend; `factor_cv`, `solve_cv`): the
  block-tridiagonal Cholesky over T stages of D (B, T, d, d) diagonal and
  O (B, T-1, d, d) sub-diagonal blocks, where block row t+1 holds O_t to
  the left of D_{t+1}. `factor` returns L (B, T, d, d) lower and M
  (B, T-1, d, d) with M_t = L_t^{-1} O_t^T; `solve` takes b (B, T, d),
  `solve_multi` b (B, T, d, K). Ragged stage widths are padded to d with
  identity diagonal blocks, which decouple exactly.

The route is chosen from the shape and dtype, before anything launches:

- `t1_route(n, dtype)`: "kernel" (`factor_t1`/`solve_t1`) up to
  `cuda_riccati.MAX_N[dtype]` (288 in float32, 192 in float64), "library"
  past it: `chol_library` and `chol_solve_library`, the port of the
  reference's XLA branch (`jnp.linalg.cholesky` and two triangular
  solves, which it takes wherever `_use_pallas` gives no resident tile).
- `route(d, dtype, T)`: "lanes" (one warp per lane, `factor_lanes`/
  `solve_lanes`) up to 32, "stream" (one thread block per lane,
  `factor_stream`/`solve_stream`) from 33 to `cuda_riccati.MAX_D[dtype]`
  (169 in float32, 120 in float64), and "scan" past it: `factor_scan`/
  `solve_scan`, the port of the reference's scan, a loop over the T
  stages of batched library calls; but a one-stage horizon (T = 1) past
  MAX_D is one dense system, "t1": the T=1 kernels up to MAX_N (M is
  empty; `solve_multi` launches `solve_t1` a column), as the reference
  takes its resident kernel there. On an H100 the lanes route's factor
  keeps a stage in registers up to d=32, and there the lanes route is the
  faster at both batches measured (B=128, T=8 and B=1024, T=31, d=9 to
  32); past 32 its factor stages in shared memory and the stream route
  wins (d=33 at B=128). The reference splits the same two regimes
  (resident d=9, streamed d=54) by TPU VMEM. `solve_multi` takes the
  stream solve, the one that serves K columns from one factor, up to
  MAX_D; both kernel routes write the same (L, M).

A dtype without kernels takes the library and scan routes. The limits
cover every shape where the reference's `_use_pallas` gives a float32
route (its resident T=1 tile reaches n = 221 at B = 32, its stream
kernels d = 165 at B = 32; tests/test_torch_wide_routes.py checks the
cover): past them the library and scan routes are the reference's own
route at those widths, as they are in float64 and for batches under 32
lanes, where `_use_pallas` gives none.

On the kernel routes a CUDA tensor goes to the hand-written kernel and a
CPU tensor to its plain PyTorch version (`ops/cuda_riccati.py`); the
library and scan routes run the same calls on either device, and count
each call on a CUDA tensor in `cuda_riccati.LAUNCHES` (keys
`factor_t1_library`, `solve_t1_library`, `factor_scan`, `solve_scan`).
`chol_solve_multi`, the schur backend's solve for K right-hand sides
(implicit differentiation), is the reference's pair of triangular solves
at every width, counted as `solve_t1_multi_library`.
A lane that is not positive definite comes out with NaN over the lower
triangle of its factor (the inertia signal), never an exception; in the
block-tridiagonal factor, from the first stage that is not positive
definite on (see `ops/cuda_riccati.py`).
"""

import torch

from calipso_tpu_torch.ops import cuda_riccati

STREAM_MIN_D = 33


def t1_route(n, dtype):
    """"kernel" or "library": the T=1 route for width n in `dtype` (the
    library route past MAX_N[dtype], whatever the batch: see module doc)."""
    return "kernel" if n <= cuda_riccati.MAX_N.get(dtype, 0) else "library"


def route(d, dtype, T):
    """"lanes", "stream", "t1" or "scan": the block-tridiagonal route for
    stage width d in `dtype` over T stages (past MAX_D[dtype] the scan,
    whatever the batch, but a one-stage horizon, which is one dense
    system, on the T=1 kernels up to MAX_N[dtype]: see module doc)."""
    if d > cuda_riccati.MAX_D.get(dtype, 0):
        return "t1" if T == 1 and t1_route(d, dtype) == "kernel" else "scan"
    return "stream" if d >= STREAM_MIN_D else "lanes"


def _count(name, t):
    if t.device.type == "cuda":
        cuda_riccati.LAUNCHES[name] += 1


def chol_library(S):
    """Lower Cholesky factors of S (B, n, n) by `torch.linalg.cholesky_ex`,
    NaN over the lower triangle of each lane that is not positive
    definite: the `else` branch of the reference's `_chol_vmap`
    (`calipso_tpu/ops/riccati.py:227-228`). The same calls as the T=1
    kernel's plain version."""
    _count("factor_t1_library", S)
    return cuda_riccati.factor_t1_plain(S)


def chol_solve_library(L, b):
    """x with L L^T x = b for L (B, n, n) lower and b (B, n), by two
    triangular solves: the `else` branch of the reference's
    `_chol_solve_vmap` (`calipso_tpu/ops/riccati.py:257-263`). The same
    calls as the T=1 kernel's plain version."""
    _count("solve_t1_library", L)
    return cuda_riccati.solve_t1_plain(L, b)


def chol_solve_multi(L, B):
    """X with L L^T X = B for L (B, n, n) lower and K right-hand sides B
    (B, n, K), by two triangular solves: what the reference's schur
    backend takes for several columns at any width
    (`calipso_tpu/solver/kkt.py:738-742`, XLA's `solve_triangular`, no
    Pallas kernel). Counted as `solve_t1_multi_library` on CUDA tensors."""
    _count("solve_t1_multi_library", L)
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def factor_scan(D, O):
    """(L, M) of D (B, T, d, d) and O (B, T-1, d, d) by a loop over the
    stages (S_t = D_t - M_{t-1}^T M_{t-1}, L_t = chol(S_t), M_t = L_t^{-1}
    O_t^T): the reference's `factor` scan (`calipso_tpu/ops/riccati.py:28-
    47`) under vmap, the route `_factor_vmap` takes where `_use_pallas`
    gives none. NaN from the first stage that is not positive definite
    on, as the kernels give it (the reference by propagation). The same
    loop as the kernels' plain version."""
    _count("factor_scan", D)
    return cuda_riccati.factor_lanes_plain(D, O)


def solve_scan(L, M, b):
    """x with S x = b for the factor (L, M) of `factor_scan`: b (B, T, d),
    or (B, T, d, K) for K right-hand sides per lane. The reference's
    `solve` scans (`calipso_tpu/ops/riccati.py:50-78`; `solve_multi`,
    `:81-83`, maps them over the columns): u_t = L_t^{-1}(b_t - M_{t-1}^T
    u_{t-1}) forward, x_t = L_t^{-T}(u_t - M_t x_{t+1}) backward, the
    stream kernels' plain sweeps."""
    _count("solve_scan", L)
    if b.dim() == 3:
        return cuda_riccati.solve_lanes_plain(L, M, b)
    return cuda_riccati.solve_bwd_stream_plain(L, M, cuda_riccati.solve_fwd_stream_plain(L, M, b))


def chol(S):
    """Batched lower Cholesky factor of S (B, n, n)."""
    if t1_route(S.shape[-1], S.dtype) == "library":
        return chol_library(S)
    return cuda_riccati.factor_t1(S)


def chol_solve(L, b):
    """Solve L L^T x = b for each lane: L (B, n, n), b (B, n) -> (B, n)."""
    if t1_route(L.shape[-1], L.dtype) == "library":
        return chol_solve_library(L, b)
    return cuda_riccati.solve_t1(L, b)


def factor(D, O):
    """Batched block-tridiagonal Cholesky: (D, O) -> (L, M)."""
    D, O = D.contiguous(), O.contiguous()
    r = route(D.shape[-1], D.dtype, D.shape[1])
    if r == "scan":
        return factor_scan(D, O)
    if r == "t1":
        return cuda_riccati.factor_t1(D[:, 0].contiguous())[:, None], torch.empty_like(O)
    if r == "stream":
        return cuda_riccati.factor_stream(D, O)
    return cuda_riccati.factor_lanes(D, O)


def solve(L, M, b):
    """Solve S x = b for each lane with the factor (L, M) of `factor`."""
    L, M, b = L.contiguous(), M.contiguous(), b.contiguous()
    r = route(L.shape[-1], L.dtype, L.shape[1])
    if r == "scan":
        return solve_scan(L, M, b)
    if r == "t1":
        return cuda_riccati.solve_t1(L[:, 0].contiguous(), b[:, 0].contiguous())[:, None]
    if r == "stream":
        return cuda_riccati.solve_stream(L, M, b)
    return cuda_riccati.solve_lanes(L, M, b)


def solve_multi(L, M, B):
    """Solve S X = B for K right-hand sides per lane, B (B, T, d, K)."""
    L, M, B = L.contiguous(), M.contiguous(), B.contiguous()
    r = route(L.shape[-1], L.dtype, L.shape[1])
    if r == "scan":
        return solve_scan(L, M, B)
    if r == "t1":  # a launch a column
        L0 = L[:, 0].contiguous()
        cols = [cuda_riccati.solve_t1(L0, B[:, 0, :, k].contiguous()) for k in range(B.shape[-1])]
        return torch.stack(cols, dim=-1)[:, None] if cols else torch.empty_like(B)
    return cuda_riccati.solve_stream(L, M, B)
