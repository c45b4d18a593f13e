"""Trajectory-optimization front-end namespace: re-exports the public
surface of calipso_tpu_torch.trajopt.transcription."""

from calipso_tpu_torch.trajopt.transcription import (
    Constraint,
    Cost,
    Dynamics,
    TrajOptSolver,
    linear_interpolation,
)

__all__ = ["TrajOptSolver", "Cost", "Dynamics", "Constraint", "linear_interpolation"]
