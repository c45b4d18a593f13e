"""Example systems written in torch. Each trajopt module exposes a
`*_problem(...)` builder returning a dict of TrajOptSolver arguments plus
initialization trajectories; `bunnyhop` is a flat NLP for `Solver`. The
pendulum, the rocket and the contact models (quadruped, hopper,
ball-in-cup, box, bunny hop) are ported so far (the other models are
ROADMAP Queue 1 items 11, 21 and 22)."""

from calipso_tpu_torch.models import ball_in_cup, box, bunnyhop, hopper, pendulum, quadruped, rocket

__all__ = ["ball_in_cup", "box", "bunnyhop", "hopper", "pendulum", "quadruped", "rocket"]
