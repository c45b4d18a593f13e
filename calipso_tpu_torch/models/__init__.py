"""Example systems written in torch. Each module exposes a `*_problem(...)`
builder returning a dict of TrajOptSolver arguments plus initialization
trajectories. The pendulum and the rocket are ported so far (the other
models are ROADMAP Queue 1 items 11, 12 and 21)."""

from calipso_tpu_torch.models import pendulum, rocket

__all__ = ["pendulum", "rocket"]
