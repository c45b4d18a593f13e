"""Cart-pole swing-up, in torch (the counterpart of
`calipso_tpu/models/cartpole.py`). The 2 x 2 mass matrix is solved in
closed form (its adjugate over its determinant) where the reference calls
`jnp.linalg.solve`: the solver differentiates the dynamics up to the third
order, in reverse mode, and a closed form keeps library solves (and their
error checks) out of every derivative."""

import math

import numpy as np
import torch

from calipso_tpu_torch.models.constants import Const
from calipso_tpu_torch.trajopt.transcription import linear_interpolation

_X_INIT = Const([0.0, 0.0, 0.0, 0.0])
_X_GOAL = Const([0.0, math.pi, 0.0, 0.0])


def continuous(x, u, mc=1.0, mp=0.2, pole_length=0.5, gravity=9.81):
    q2, qd = x[1], x[2:]
    s, c = torch.sin(q2), torch.cos(q2)
    # H = [[h11, h12], [h12, h22]], rhs = B u - C - G
    h11, h12, h22 = mc + mp, mp * pole_length * c, mp * pole_length**2
    r1 = u[0] + mp * qd[1] * pole_length * s * qd[1]
    r2 = -mp * gravity * pole_length * s
    det = h11 * h22 - h12 * h12
    qdd = torch.stack([(h22 * r1 - h12 * r2) / det, (h11 * r2 - h12 * r1) / det])
    return torch.cat([qd, qdd])


def discrete(y, x, u, h=0.05):
    return y - (x + h * continuous(0.5 * (x + y), u))


def swingup_problem(horizon=51, parametric_initial_state=False):
    x_init = np.array([0.0, 0.0, 0.0, 0.0])
    x_goal = np.array([0.0, math.pi, 0.0, 0.0])

    objective = [
        *[(lambda x, u, w: 0.1 * x @ x + 0.1 * u @ u)] * (horizon - 1),
        lambda x, u, w: 0.1 * x @ x,
    ]
    if parametric_initial_state:
        eq0 = lambda x, u, w: x - w
        parameters = [x_init] + [np.zeros(0)] * (horizon - 1)
    else:
        eq0 = lambda x, u, w: x - _X_INIT.like(x)
        parameters = None
    equality = [eq0, *[None] * (horizon - 2), lambda x, u, w: x - _X_GOAL.like(x)]

    return dict(
        objective=objective,
        dynamics=[discrete] * (horizon - 1),
        num_states=[4] * horizon,
        num_actions=[1] * (horizon - 1),
        equality=equality,
        parameters=parameters,
        state_guess=linear_interpolation(x_init, x_goal, horizon),
        state_initial=x_init,
        state_goal=x_goal,
    )
