"""Example systems written in torch. Each module exposes a `*_problem(...)`
builder returning a dict of TrajOptSolver arguments plus initialization
trajectories. The pendulum, the rocket and the quadruped are ported so
far (the other models are ROADMAP Queue 1 items 11, 21 and 22)."""

from calipso_tpu_torch.models import pendulum, quadruped, rocket

__all__ = ["pendulum", "quadruped", "rocket"]
