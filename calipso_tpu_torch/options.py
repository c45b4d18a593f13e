"""Solver options.

The same frozen dataclass as `calipso_tpu.options.Options`: the same fields
with the same defaults, so one set of options configures both packages
(`calipso_tpu_torch.utils.convert.options_from_jax` copies one into the
other and checks that the field sets agree).

The port has the six KKT backends: ``linear_solver`` "schur",
"riccati", "cr", "ldl", "lu" and "spike" (riccati, cr and spike for
trajopt problems), ``refinement_fallback=True`` and
``differentiate=True`` (on all six). "spike" shards the horizon over the
ranks of ``spike_mesh``, a `calipso_tpu_torch.parallel.mesh.Mesh` whose
``axis`` must be ``spike_axis``; the horizon must split into chunks of
at least 2 stages a rank. What a solver cannot take is refused when it is
built (see `solver/solve.py:resolve_options`).

``matmul_precision="highest"`` keeps float32 matrix products in full
float32 on the GPU (`torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32` both False). The reference found that
reduced-precision passes wreck the chained factorizations (iteration
counts explode); TF32 keeps about three decimal digits.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class Options:
    # norms (p for ||.||_p; 1.0, 2.0 or inf)
    residual_norm: float = 1.0
    constraint_norm: float = 1.0

    # iteration caps
    max_outer_iterations: int = 10
    max_residual_iterations: int = 100

    # line search
    scaling_line_search: float = 0.5
    max_residual_line_search: int = 25
    max_cone_line_search: int = 25
    violation_tolerance: float = 1.0e-5
    violation_exponent: float = 1.1
    merit_tolerance: float = 1.0e-5
    merit_exponent: float = 2.3
    armijo_tolerance: float = 1.0e-4
    machine_tolerance: float = 1.0e-16

    # iterative refinement
    iterative_refinement: bool = True
    max_iterative_refinement: int = 10
    min_iterative_refinement: int = 1
    iterative_refinement_tolerance: float = 1.0e-10
    # full-system LU escalation after diverging refinement
    refinement_fallback: bool = False

    # central path / interior point
    central_path_initial: float = 1.0
    central_path_update_tolerance: float = 10.0
    central_path_scaling: float = 0.2
    central_path_exponent: float = 1.5
    min_central_path: float = 1.0e-8

    # augmented Lagrangian
    penalty_initial: float = 1.0
    penalty_scaling: float = 10.0
    dual_initial: float = 0.0
    max_penalty: float = 1.0e8

    # convergence tolerances
    residual_tolerance: float = 1.0e-4
    optimality_tolerance: float = 1.0e-4
    slack_tolerance: float = 1.0e-4
    equality_tolerance: float = 1.0e-4
    complementarity_tolerance: float = 1.0e-4

    # regularization / inertia-correction ladder
    min_regularization: float = 1.0e-20
    primal_regularization_initial: float = 1.0e-7
    dual_regularization_initial: float = 1.0e-7
    max_regularization: float = 1.0e40
    dual_regularization: float = 1.0e-8
    dual_regularization_exponent: float = 0.25
    scaling_regularization_initial: float = 100.0
    scaling_regularization: float = 8.0
    scaling_regularization_last: float = 1.0 / 3.0

    # second derivatives of constraints in the Lagrangian Hessian
    constraint_tensor: bool = True

    # linear-solver backend: "auto" resolves to "riccati" for trajopt
    # problems with more than 96 variables, else "schur" (dense Cholesky of
    # the (n, n) primal Schur complement); also "cr", "ldl", "lu" and
    # "spike" (the horizon sharded over the ranks of spike_mesh, a
    # parallel.mesh.Mesh over the axis spike_axis)
    linear_solver: str = "auto"
    spike_mesh: object = None
    spike_axis: str = "horizon"

    # line-search execution mode:
    #   "auto"     -> "parallel" for CUDA tensors, "serial" for CPU tensors
    #   "serial"   -> masked backtracking loops, one candidate per trip
    #   "parallel" -> chunks of candidates evaluated as one oracle batch
    #                 (identical accept rule)
    line_search_mode: str = "auto"
    parallel_line_search_width: int = 8

    # implicit differentiation of the solution (SolveResult.sensitivity)
    differentiate: bool = False

    # keep the caller-provided primal-dual point instead of reinitializing
    warmstart: bool = False

    # filter capacity; reset every outer iteration
    max_filter: int = 102

    # "highest" turns TF32 off for float32 matrix products
    matmul_precision: str = "highest"

    # host-side printing: banner, iteration rows and the final summary
    verbose: bool = False
    print_frequency: int = 1

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)
