"""Dense Cholesky factor and solve of the primal Schur complement: the
T=1 part of `calipso_tpu/ops/riccati.py` (`chol_cv`, `chol_solve_cv`).

Batch-first: S is (B, n, n) and b is (B, n). A CUDA tensor goes to the
hand-written kernel, a CPU tensor to its plain PyTorch version
(`ops/cuda_riccati.py`); nothing else decides. A lane whose S is not
positive definite comes out with NaN over the lower triangle of its
factor (the inertia signal), never an exception.

The block-tridiagonal T>1 factor and solve (the riccati backend) are
ROADMAP Queue 1 item 10.
"""

from calipso_tpu_torch.ops import cuda_riccati


def chol(S):
    """Batched lower Cholesky factor of S (B, n, n)."""
    return cuda_riccati.factor_t1(S)


def chol_solve(L, b):
    """Solve L L^T x = b for each lane: L (B, n, n), b (B, n) -> (B, n)."""
    return cuda_riccati.solve_t1(L, b)
