"""CALIPSO-TPU on PyTorch and CUDA: the conic augmented-Lagrangian
interior-point solver of `calipso_tpu`, ported to run on an NVIDIA GPU.

Solves

    minimize_x   c(x; theta)
    subject to   g(x; theta) = 0
                 h(x; theta) in K = R+^q x Q_l1 x ... x Q_lj

with a stagewise trajectory-optimization front-end and batched scenario
solves. The JAX package `calipso_tpu` is the reference this package is
tested against; this package imports torch and never jax.

Batch-first: the solver state carries a leading lane axis, every loop is a
Python loop over "any lane still active", and finished lanes are frozen
by masks. User callables are torch functions of one unbatched lane; the
derivatives come from `torch.func`. The linear algebra of the schur and
riccati KKT backends runs in hand-written CUDA kernels
(`ops/cuda_riccati.py`) for CUDA tensors and in plain PyTorch for CPU
tensors. Every entry point solves on the card unless given
`device="cpu"`.

`examples/` holds the JAX package's seven example scripts, ported
(`python -m calipso_tpu_torch.examples.<name>`). `utils/` holds the
checkpoint (`checkpoint.save_point`, `load_point`), profiling
(`profiling.trace`, `iteration_stats`, `batch_stats`) and platform
helpers and `aot`, the manifest of kernel libraries behind the batched
solvers' `aot_save` / `aot_load` (`parallel/batch.py`).
"""

from calipso_tpu_torch.options import Options
from calipso_tpu_torch.ops.cones import ConeLayout
from calipso_tpu_torch.solver.problem import ProblemFunctions, empty_constraint
from calipso_tpu_torch.solver.api import Solver, SolveResult
from calipso_tpu_torch.trajopt.api import (
    TrajOptSolver,
    Cost,
    Dynamics,
    Constraint,
    linear_interpolation,
)
from calipso_tpu_torch.parallel.batch import BatchedSolver, BatchedTrajOptSolver

__all__ = [
    "Options",
    "ConeLayout",
    "ProblemFunctions",
    "empty_constraint",
    "Solver",
    "SolveResult",
    "TrajOptSolver",
    "Cost",
    "Dynamics",
    "Constraint",
    "linear_interpolation",
    "BatchedSolver",
    "BatchedTrajOptSolver",
]

__version__ = "0.1.0"
