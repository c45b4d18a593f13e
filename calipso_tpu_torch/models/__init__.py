"""Example systems written in torch. Each trajopt module exposes a
`*_problem(...)` builder returning a dict of TrajOptSolver arguments plus
initialization trajectories; `bunnyhop` is a flat NLP for `Solver`. Every
model of the JAX package is ported: the pendulum, cart-pole, acrobot,
double integrator and rocket, and the contact models (quadruped, hopper,
ball-in-cup, box, bunny hop, cyberdrift)."""

from calipso_tpu_torch.models import (
    acrobot,
    ball_in_cup,
    box,
    bunnyhop,
    cartpole,
    cyberdrift,
    double_integrator,
    hopper,
    pendulum,
    quadruped,
    rocket,
)

__all__ = [
    "acrobot", "ball_in_cup", "box", "bunnyhop", "cartpole", "cyberdrift",
    "double_integrator", "hopper", "pendulum", "quadruped", "rocket",
]
