"""Plain float64 reference of the rocket soft landing (CALIPSO.jl's
rocket-landing example, at the horizon and batch form of the reference
benchmark's rocket batch): written again from the published equations,
with nothing of the program under test.

Stage t has the state x_t = (position p, velocity v) in R^6 and, before
the last stage, the thrust u_t in R^3.

  minimise   sum_{t<T-1} |p_t|^2 + 0.1 |v_t|^2 + 0.1 |u_t|^2  +  |p_{T-1}|^2 + 0.1 |v_{T-1}|^2
  subject to x_{t+1} - x_t - h f((x_t + x_{t+1}) / 2, u_t) = 0  (implicit midpoint)
             x_0 - (3, 2, 1, 0, 0, 0) = 0,  x_{T-1} = 0
             (u_z, u_x, u_y) in the second-order cone |(u_x, u_y)| <= u_z, every t < T-1
  f(x, u) = (v, u / m + (0, 0, g))
"""

import torch

HORIZON, NUM_STATES, NUM_ACTIONS, NUM_PARAMETERS = 31, 6, 3, 0
SECOND_ORDER = (3,) * (HORIZON - 1)
NONNEGATIVE = 0
MASS, GRAVITY, STEP = 1.0, -9.81, 0.05
START = (3.0, 2.0, 1.0, 0.0, 0.0, 0.0)


def _f(x, u):
    acc = u / MASS + torch.tensor([0.0, 0.0, GRAVITY], dtype=u.dtype, device=u.device)
    return torch.cat([x[..., 3:6], acc], dim=-1)


def objective(xs, us, theta):
    p, v = xs[..., :3], xs[..., 3:6]
    return (p * p).sum((1, 2)) + 0.1 * (v * v).sum((1, 2)) + 0.1 * (us * us).sum((1, 2))


def equality(xs, us, theta):
    x, y = xs[:, :-1], xs[:, 1:]
    dyn = y - (x + STEP * _f(0.5 * (x + y), us))
    start = torch.tensor(START, dtype=xs.dtype, device=xs.device)
    return torch.cat([dyn.flatten(1), xs[:, 0] - start, xs[:, -1]], dim=1)


def cone(xs, us, theta):
    return torch.stack([us[..., 2], us[..., 0], us[..., 1]], dim=-1).flatten(1)
