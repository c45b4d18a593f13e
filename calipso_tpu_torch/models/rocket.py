"""Rocket soft landing with a second-order thrust cone, and its
state-triggered variant, in torch (the counterpart of
`calipso_tpu/models/rocket.py`)."""

import numpy as np
import torch

from calipso_tpu_torch.trajopt.transcription import linear_interpolation

GRAVITY, MASS = -9.81, 1.0


def continuous(x, u):
    v = x[3:6]
    acc = torch.stack([u[0] / MASS, u[1] / MASS, GRAVITY + u[2] / MASS])
    return torch.cat([v, acc])


def discrete(y, x, u, h=0.05):
    return y - (x + h * continuous(0.5 * (x + y), u))


def thrust_cone(x, u, w):
    """SOC: |u_xy| <= u_z."""
    return torch.stack([u[2], u[0], u[1]])


def _const(values, like):
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def state_triggered_problem(horizon=51):
    """Rocket landing with state-triggered constraints: two
    trigger/constraint pairs encoded as split nonnegative variables
    g+/g-/c+/c- with the complementarity equality g+*c- = 0, plus box
    bounds on thrust. Action: [tx, ty, tz, g1+, g1-, c1+, c1-, g2+, g2-,
    c2+, c2-]."""
    x1 = np.array([-5.0, 0.0, 5.0, 0.0, 0.0, 0.0])
    xT = np.zeros(6)
    a_trig, b_trig, c_trig, d_trig = -0.5, 3.0, 0.3, 3.0
    F_min = [-10.0, -10.0, 0.0]
    F_max = [10.0, 10.0, 20.0]
    nu = 11

    def goal_gap(x):
        return x[:3] - _const(xT[:3], x)

    objective = [
        *[(lambda x, u, w: goal_gap(x) @ goal_gap(x) + 0.1 * x[3:6] @ x[3:6] + 0.1 * u[:3] @ u[:3])]
        * (horizon - 1),
        lambda x, u, w: goal_gap(x) @ goal_gap(x) + 0.1 * x[3:6] @ x[3:6],
    ]

    def stc_con(x, u, w):
        g1 = -x[0] + a_trig
        c1 = x[2] - b_trig
        g2 = x[0] - c_trig
        c2 = x[2] - d_trig
        return torch.stack(
            [
                u[3] - u[4] - g1,
                u[5] - u[6] - c1,
                u[3] * u[6],
                u[7] - u[8] - g2,
                u[9] - u[10] - c2,
                u[7] * u[10],
            ]
        )

    equality = [
        lambda x, u, w: x - _const(x1, x),
        *[stc_con] * (horizon - 2),
        lambda x, u, w: x - _const(xT, x),
    ]

    def bounds(x, u, w):
        return torch.cat([u[:3] - _const(F_min, u), _const(F_max, u) - u[:3], u[3:11]])

    nonnegative = [*[bounds] * (horizon - 1), None]

    # initialization: velocity ramp and feasible trigger splits
    interp = [v.numpy().copy() for v in linear_interpolation(x1, xT, horizon)]
    h = 0.05 / 2
    for v in interp:
        v[3:6] = (xT[:3] - x1[:3]) / (h * horizon)
    u_guess = []
    for i in range(horizon - 1):
        u = np.zeros(nu)
        u[:3] = [0.0, 0.0, 9.8]
        for base, (gv, cv) in (
            (3, (-interp[i][0] + a_trig, interp[i][2] - b_trig)),
            (7, (interp[i][0] - c_trig, interp[i][2] - d_trig)),
        ):
            u[base + 0], u[base + 1] = (gv, 0.0) if gv >= 0 else (0.0, -gv)
            u[base + 2], u[base + 3] = (cv, 0.0) if cv >= 0 else (0.0, -cv)
        u_guess.append(u)

    return dict(
        objective=objective,
        dynamics=[discrete] * (horizon - 1),
        num_states=[6] * horizon,
        num_actions=[nu] * (horizon - 1),
        equality=equality,
        nonnegative=nonnegative,
        state_guess=interp,
        action_guess=u_guess,
        state_initial=x1,
        state_goal=xT,
        penalty_initial=1.0e3,
    )


def landing_problem(horizon=101):
    """Soft landing from [3, 2, 1] at rest to the origin at rest, thrust
    in the cone |u_xy| <= u_z at every stage."""
    x_init = np.array([3.0, 2.0, 1.0, 0.0, 0.0, 0.0])
    x_goal = np.zeros(6)
    objective = [
        *[(lambda x, u, w: x[:3] @ x[:3] + 0.1 * x[3:6] @ x[3:6] + 0.1 * u @ u)] * (horizon - 1),
        lambda x, u, w: x[:3] @ x[:3] + 0.1 * x[3:6] @ x[3:6],
    ]
    equality = [
        lambda x, u, w: x - _const(x_init, x),
        *[None] * (horizon - 2),
        lambda x, u, w: x - _const(x_goal, x),
    ]
    second_order = [[thrust_cone] for _ in range(horizon - 1)] + [[]]
    return dict(
        objective=objective,
        dynamics=[discrete] * (horizon - 1),
        num_states=[6] * horizon,
        num_actions=[3] * (horizon - 1),
        equality=equality,
        second_order=second_order,
        state_guess=linear_interpolation(x_init, x_goal, horizon),
        state_initial=x_init,
        state_goal=x_goal,
    )
