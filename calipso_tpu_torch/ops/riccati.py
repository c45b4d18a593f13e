"""Cholesky factor and solve of the primal Schur complement, batch-first:
the counterpart of `calipso_tpu/ops/riccati.py`.

- `chol`/`chol_solve` (the schur backend; `chol_cv`, `chol_solve_cv` in
  the reference): the dense T=1 case, S (B, n, n) and b (B, n).
- `factor`/`solve` (the riccati backend; `factor_cv`, `solve_cv`): the
  block-tridiagonal Cholesky over T stages of D (B, T, d, d) diagonal and
  O (B, T-1, d, d) sub-diagonal blocks, where block row t+1 holds O_t to
  the left of D_{t+1}. `factor` returns L (B, T, d, d) lower and M
  (B, T-1, d, d) with M_t = L_t^{-1} O_t^T; `solve` takes b (B, T, d).
  Ragged stage widths are padded to d with identity diagonal blocks,
  which decouple exactly.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
PyTorch version (`ops/cuda_riccati.py`); nothing else decides. A lane
that is not positive definite comes out with NaN over the lower triangle
of its factor (the inertia signal), never an exception.
"""

from calipso_tpu_torch.ops import cuda_riccati


def chol(S):
    """Batched lower Cholesky factor of S (B, n, n)."""
    return cuda_riccati.factor_t1(S)


def chol_solve(L, b):
    """Solve L L^T x = b for each lane: L (B, n, n), b (B, n) -> (B, n)."""
    return cuda_riccati.solve_t1(L, b)


def factor(D, O):
    """Batched block-tridiagonal Cholesky: (D, O) -> (L, M)."""
    return cuda_riccati.factor_lanes(D.contiguous(), O.contiguous())


def solve(L, M, b):
    """Solve S x = b for each lane with the factor (L, M) of `factor`."""
    return cuda_riccati.solve_lanes(L.contiguous(), M.contiguous(), b.contiguous())
