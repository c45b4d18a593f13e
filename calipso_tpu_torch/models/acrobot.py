"""Acrobot swing-up, in torch (the counterpart of
`calipso_tpu/models/acrobot.py`). The mass matrix is inverted in closed
form, as the reference does."""

import math

import numpy as np
import torch

from calipso_tpu_torch.models.constants import Const
from calipso_tpu_torch.trajopt.transcription import linear_interpolation

MASS1, INERTIA1, LENGTH1, LENGTHCOM1 = 1.0, 0.33, 1.0, 0.5
MASS2, INERTIA2, LENGTH2, LENGTHCOM2 = 1.0, 0.33, 1.0, 0.5
GRAVITY, FRICTION1, FRICTION2 = 9.81, 0.1, 0.1

_X_INIT = Const([0.0, 0.0, 0.0, 0.0])
_X_GOAL = Const([math.pi, 0.0, 0.0, 0.0])


def continuous(x, u):
    c2 = torch.cos(x[1])
    a = INERTIA1 + INERTIA2 + MASS2 * LENGTH1**2 + 2.0 * MASS2 * LENGTH1 * LENGTHCOM2 * c2
    b = INERTIA2 + MASS2 * LENGTH1 * LENGTHCOM2 * c2
    c = INERTIA2
    det = a * c - b * b

    tau1 = (
        -MASS1 * GRAVITY * LENGTHCOM1 * torch.sin(x[0])
        - MASS2 * GRAVITY * (LENGTH1 * torch.sin(x[0]) + LENGTHCOM2 * torch.sin(x[0] + x[1]))
    )
    tau2 = -MASS2 * GRAVITY * LENGTHCOM2 * torch.sin(x[0] + x[1])
    s2 = torch.sin(x[1])
    k = MASS2 * LENGTH1 * LENGTHCOM2 * s2
    v1, v2 = x[2], x[3]
    # -C v + tau + B u - friction v, with C = [[-2 k v2, -k v2], [k v1, 0]]
    r1 = (2.0 * k * x[3] * v1 + k * x[3] * v2) + tau1 - FRICTION1 * v1
    r2 = -(k * x[2] * v1) + tau2 + u[0] - FRICTION2 * v2
    # Minv = [[c, -b], [-b, a]] / det
    qdd = torch.stack([(c * r1 - b * r2) / det, (-b * r1 + a * r2) / det])
    return torch.cat([x[2:], qdd])


def discrete(y, x, u, h=0.05):
    """Explicit midpoint (reference acrobot.jl: acrobot_discrete)."""
    xm = x + 0.5 * h * continuous(x, u)
    return y - (x + h * continuous(xm, u))


def swingup_problem(horizon=51):
    x_init = np.array([0.0, 0.0, 0.0, 0.0])
    x_goal = np.array([math.pi, 0.0, 0.0, 0.0])
    objective = [
        *[(lambda x, u, w: 0.1 * x[2:] @ x[2:] + 0.1 * u @ u)] * (horizon - 1),
        lambda x, u, w: 0.1 * x[2:] @ x[2:],
    ]
    equality = [
        lambda x, u, w: x - _X_INIT.like(x),
        *[None] * (horizon - 2),
        lambda x, u, w: x - _X_GOAL.like(x),
    ]
    return dict(
        objective=objective,
        dynamics=[discrete] * (horizon - 1),
        num_states=[4] * horizon,
        num_actions=[1] * (horizon - 1),
        equality=equality,
        state_guess=linear_interpolation(x_init, x_goal, horizon),
        state_initial=x_init,
        state_goal=x_goal,
    )
