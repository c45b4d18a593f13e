"""Pendulum swing-up, in torch (the counterpart of
`calipso_tpu/models/pendulum.py`)."""

import math

import numpy as np
import torch

from calipso_tpu_torch.trajopt.transcription import linear_interpolation


def continuous(x, u, mass=1.0, length_com=0.5, gravity=9.81, damping=0.1):
    ml2 = mass * length_com * length_com
    return torch.stack(
        [
            x[1],
            u[0] / ml2 - gravity * torch.sin(x[0]) / length_com - damping * x[1] / ml2,
        ]
    )


def discrete(y, x, u, h=0.05):
    """Implicit midpoint: y - (x + h f((x+y)/2, u)) = 0."""
    return y - (x + h * continuous(0.5 * (x + y), u))


def swingup_problem(horizon=11, parametric_initial_state=False):
    """Swing-up from hanging to upright. With parametric_initial_state the
    stage-0 equality reads the initial state from the stage parameter, so
    one solver serves scenario batches (the benchmark flagship)."""
    x_init = np.array([0.0, 0.0])
    x_goal = np.array([math.pi, 0.0])

    objective = [
        *[(lambda x, u, w: 0.1 * x @ x + 0.1 * u @ u)] * (horizon - 1),
        lambda x, u, w: 0.1 * x @ x,
    ]
    if parametric_initial_state:
        eq0 = lambda x, u, w: x - w
        parameters = [x_init] + [np.zeros(0)] * (horizon - 1)
    else:
        eq0 = lambda x, u, w: torch.stack([x[0] - 0.0, x[1] - 0.0])
        parameters = None
    goal = lambda x, u, w: torch.stack([x[0] - math.pi, x[1] - 0.0])
    equality = [eq0, *[None] * (horizon - 2), goal]

    return dict(
        objective=objective,
        dynamics=[discrete] * (horizon - 1),
        num_states=[2] * horizon,
        num_actions=[1] * (horizon - 1),
        equality=equality,
        parameters=parameters,
        state_guess=linear_interpolation(x_init, x_goal, horizon),
        state_initial=x_init,
        state_goal=x_goal,
    )
