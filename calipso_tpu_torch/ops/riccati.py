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

`route(d)` picks the block-tridiagonal kernels by the stage width alone:
"lanes" (one warp per lane, `factor_lanes`/`solve_lanes`) below 32, and
"stream" (one thread block per lane, `factor_stream`/`solve_stream`) from
32 on, the contact class's d=54. On an H100 the crossover moves with the
batch: at B=1024 the lanes route is faster up to d=24 and the stream route
at d=32, at B=128 the stream route from d=16 on (one warp a lane leaves
most of the card idle there); d=32 is the narrowest width measured where
the stream route wins at every batch size. The reference splits the same two regimes (resident d=9, streamed
d=54) by TPU VMEM. `solve_multi` always takes the stream solve, the one
that serves K columns from one factor; both routes write the same (L, M).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
PyTorch version (`ops/cuda_riccati.py`); nothing else decides. A lane
that is not positive definite comes out with NaN over the lower triangle
of its factor (the inertia signal), never an exception.
"""

from calipso_tpu_torch.ops import cuda_riccati

STREAM_MIN_D = 32


def route(d):
    """"lanes" or "stream": the block-tridiagonal kernels for stage width d."""
    return "stream" if d >= STREAM_MIN_D else "lanes"


def chol(S):
    """Batched lower Cholesky factor of S (B, n, n)."""
    return cuda_riccati.factor_t1(S)


def chol_solve(L, b):
    """Solve L L^T x = b for each lane: L (B, n, n), b (B, n) -> (B, n)."""
    return cuda_riccati.solve_t1(L, b)


def factor(D, O):
    """Batched block-tridiagonal Cholesky: (D, O) -> (L, M)."""
    D, O = D.contiguous(), O.contiguous()
    if route(D.shape[-1]) == "stream":
        return cuda_riccati.factor_stream(D, O)
    return cuda_riccati.factor_lanes(D, O)


def solve(L, M, b):
    """Solve S x = b for each lane with the factor (L, M) of `factor`."""
    L, M, b = L.contiguous(), M.contiguous(), b.contiguous()
    if route(L.shape[-1]) == "stream":
        return cuda_riccati.solve_stream(L, M, b)
    return cuda_riccati.solve_lanes(L, M, b)


def solve_multi(L, M, B):
    """Solve S X = B for K right-hand sides per lane, B (B, T, d, K)."""
    return cuda_riccati.solve_stream(L.contiguous(), M.contiguous(), B.contiguous())
