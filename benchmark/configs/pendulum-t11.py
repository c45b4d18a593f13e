"""Plain float64 reference of the pendulum swing-up (CALIPSO.jl's
pendulum example, at the horizon and batch form of the reference
benchmark's flagship): written again from the published equations, with
nothing of the program under test.

Stage t has the state x_t = (angle, angular velocity) and, before the
last stage, the torque u_t. The parameter theta is the initial state.

  minimise   sum_{t<T-1} 0.1 |x_t|^2 + 0.1 |u_t|^2  +  0.1 |x_{T-1}|^2
  subject to x_{t+1} - x_t - h f((x_t + x_{t+1}) / 2, u_t) = 0  (implicit midpoint)
             x_0 - theta = 0,  x_{T-1} - (pi, 0) = 0
  f(x, u) = (x_1, u / (m l^2) - g sin(x_0) / l - b x_1 / (m l^2))
"""

import math

import torch

HORIZON, NUM_STATES, NUM_ACTIONS, NUM_PARAMETERS = 11, 2, 1, 2
SECOND_ORDER = ()  # sizes of the second-order cones, in row order
NONNEGATIVE = 0
MASS, LENGTH, GRAVITY, DAMPING, STEP = 1.0, 0.5, 9.81, 0.1, 0.05


def _f(x, u):
    ml2 = MASS * LENGTH * LENGTH
    acc = u[..., 0] / ml2 - GRAVITY * torch.sin(x[..., 0]) / LENGTH - DAMPING * x[..., 1] / ml2
    return torch.stack([x[..., 1], acc], dim=-1)


def objective(xs, us, theta):
    return 0.1 * (xs * xs).sum((1, 2)) + 0.1 * (us * us).sum((1, 2))


def equality(xs, us, theta):
    x, y = xs[:, :-1], xs[:, 1:]
    dyn = y - (x + STEP * _f(0.5 * (x + y), us))
    goal = torch.tensor([math.pi, 0.0], dtype=xs.dtype, device=xs.device)
    return torch.cat([dyn.flatten(1), xs[:, 0] - theta, xs[:, -1] - goal], dim=1)


def cone(xs, us, theta):
    return xs.new_zeros((xs.shape[0], 0))
