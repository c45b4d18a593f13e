"""Parameterized double integrator, in torch (the counterpart of
`calipso_tpu/models/double_integrator.py`): per-stage parameters carry the
(A, B) matrices, the cost weights and the boundary states -- the
canonical differentiable-solver example."""

import numpy as np
import torch

from calipso_tpu_torch.trajopt.transcription import linear_interpolation


def dynamics(y, x, u, w):
    A = w[:4].reshape(2, 2)
    B = w[4:6]
    return y - (A @ x + B * u[0])


def obj_stage(x, u, w):
    Q = w[6:8]
    R = w[8]
    return 0.5 * x @ (Q * x) + 0.5 * R * (u @ u)


def obj_final(x, u, w):
    Q = w[0:2]
    return 0.5 * x @ (Q * x)


def problem(horizon=5):
    state_initial = np.array([0.0, 0.0])
    state_goal = np.array([1.0, 0.0])
    A = np.array([[1.0, 1.0], [0.0, 1.0]])
    B = np.array([0.0, 1.0])
    Qt, Rt, QT = np.array([1.0, 1.0]), np.array([0.1]), np.array([10.0, 10.0])

    theta1 = np.concatenate([A.reshape(-1), B, Qt, Rt, state_initial])
    thetat = np.concatenate([A.reshape(-1), B, Qt, Rt])
    thetaT = np.concatenate([QT, state_goal])
    parameters = [theta1] + [thetat] * (horizon - 2) + [thetaT]

    objective = [obj_stage] * (horizon - 1) + [obj_final]
    equality = [
        lambda x, u, w: x - w[9:11],
        *[None] * (horizon - 2),
        lambda x, u, w: x - w[2:4],
    ]
    return dict(
        objective=objective,
        dynamics=[dynamics] * (horizon - 1),
        num_states=[2] * horizon,
        num_actions=[1] * (horizon - 1),
        equality=equality,
        parameters=parameters,
        state_guess=linear_interpolation(state_initial, state_goal, horizon),
        state_initial=state_initial,
        state_goal=state_goal,
    )
