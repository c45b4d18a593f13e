"""Ball-in-cup: contact-implicit trajopt with an impact impulse and
complementarity constraints, in torch (the counterpart of
`calipso_tpu/models/ball_in_cup.py`).

A cup (2-d point mass) swings a ball (2-d point mass) attached by an
inextensible string of length L. The signed distance phi = L^2 - |dp|^2
must stay nonnegative; the string impulse gamma >= 0 acts along the
string direction; gamma(-) * phi = 0 is the complementarity equality.
State: [q_prev(4); q_cur(4)] at t=0, plus a gamma-memory slot afterwards.
Action: [u_cup(2); gamma(1)]. The Lagrangian's derivatives are constant
or linear here, so nothing is taken by autodiff inside the model."""

import numpy as np
import torch

from calipso_tpu_torch.models.constants import Const
from calipso_tpu_torch.trajopt.transcription import linear_interpolation

MASS_CUP, MASS_BALL = 1.0, 0.01
STRING_LENGTH = 1.0
GRAVITY_CUP, GRAVITY_BALL = 0.0, 10.0
TIMESTEP = 0.075

_MASS = Const([MASS_CUP, MASS_CUP, MASS_BALL, MASS_BALL])
_BIAS = Const([0.0, MASS_CUP * GRAVITY_CUP, 0.0, MASS_BALL * GRAVITY_BALL])


def mass_matrix_diag(like):
    return _MASS.like(like)


def dynamics_bias(like):
    return _BIAS.like(like)


def signed_distance(q):
    d = q[:2] - q[2:4]
    return (STRING_LENGTH**2 - d @ d).reshape(1)


def impact_impulse(q, gamma):
    """lambda = J(q)' gamma with J = -2 dp' [I, -I]."""
    d = q[:2] - q[2:4]
    return -2.0 * torch.cat([d, -d]) * gamma


def implicit_dynamics(h, q0, q1, u, lam, q2):
    """Variational midpoint integrator residual: dL/dq = -b and
    dL/dv = M v."""
    M, b = mass_matrix_diag(q1), dynamics_bias(q1)
    vm1 = (q1 - q0) / h
    vm2 = (q2 - q1) / h
    d = 0.5 * h * -b + M * vm1 + 0.5 * h * -b - M * vm2
    d = d + torch.cat([u[:2], u.new_zeros(2)])
    return d + lam


def dynamics(y, x, u):
    """Stage dynamics rows: configuration shift, variational residual and
    the gamma-memory pass-through."""
    q1m, q2m = x[0:4], x[4:8]
    q2p, q3p = y[0:4], y[4:8]
    lam = impact_impulse(q2p, u[2])
    return torch.cat([q2p - q2m, implicit_dynamics(TIMESTEP, q1m, q2p, u, lam, q3p), y[8:9] - u[2:3]])


def problem(horizon=21, waypoints=True):
    x1 = np.array([0.0, 0.0, 0.0, -0.99, 0.0, 0.0, 0.0, -0.99])
    xT = np.array([0.0, 0.0, 0.0, 0.125, 0.0, 0.0, 0.0, 0.125])
    xM1 = np.array([0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    dr = np.sqrt(0.5 * STRING_LENGTH**2)
    xM2 = np.array([0.0, 0.0, dr, dr, 0.0, 0.0, dr, dr])
    tM1, tM2 = 10, 15  # 0-based (reference: stages 11 and 16 of 21)
    x1_c = Const(x1)
    goal_c, ball_end = Const(xT[4:6]), Const(xT[6:8])
    cup_start = Const(xT[0:2])
    ball_m1, ball_m2 = Const(xM1[6:8]), Const(xM2[6:8])

    num_states = [8] + [9] * (horizon - 1)
    num_actions = [3] * (horizon - 1)

    def obj_t(x, u):
        v = (x[4:8] - x[0:4]) / TIMESTEP
        d_goal = x[4:6] - goal_c.like(x)
        return 0.05 * v @ v + 0.5 * d_goal @ d_goal + 0.5 * (0.1 * u[:2] @ u[:2] + 0.1 * u[2] ** 2)

    def obj_T(x, u):
        v = (x[4:8] - x[0:4]) / TIMESTEP
        d_goal = x[4:6] - goal_c.like(x)
        d_cup_ball = x[4:6] - x[6:8]
        return 0.05 * v @ v + 0.5 * d_goal @ d_goal + 0.5 * d_cup_ball @ d_cup_ball

    objective = [obj_t] * (horizon - 1) + [obj_T]

    def compl(x, u):
        # gamma(-) * phi(q_cur) = 0
        return x[8:9] * signed_distance(x[4:8])

    def eq_1(x, u):
        return x - x1_c.like(x)

    def eq_t(x, u):
        return compl(x, u)

    def eq_tM1(x, u):
        return torch.cat([compl(x, u), x[6:8] - ball_m1.like(x)])

    def eq_tM2(x, u):
        return torch.cat([compl(x, u), x[6:8] - ball_m2.like(x)])

    def eq_T(x, u):
        return torch.cat(
            [compl(x, u), x[0:2] - cup_start.like(x), x[4:6] - goal_c.like(x), x[6:8] - ball_end.like(x)]
        )

    equality = [eq_1]
    for t in range(1, horizon - 1):
        if waypoints and t == tM1:
            equality.append(eq_tM1)
        elif waypoints and t == tM2:
            equality.append(eq_tM2)
        else:
            equality.append(eq_t)
    equality.append(eq_T)

    def ineq_1(x, u):
        return torch.cat([signed_distance(x[4:8]), u[2:3]])

    def ineq_t(x, u):
        return torch.cat([signed_distance(x[4:8]), u[2:3]])

    def ineq_T(x, u):
        return signed_distance(x[4:8])

    nonnegative = [ineq_1] + [ineq_t] * (horizon - 2) + [ineq_T]

    # interpolated guess through the waypoints
    interp = (
        linear_interpolation(x1, xM1, 11)
        + linear_interpolation(xM1, xM2, 6)[1:]
        + linear_interpolation(xM2, xT, 6)[1:]
    )
    state_guess = [np.asarray(interp[0])] + [
        np.concatenate([np.asarray(interp[t]), np.zeros(1)]) for t in range(1, horizon)
    ]

    return dict(
        objective=objective,
        dynamics=[dynamics] * (horizon - 1),
        num_states=num_states,
        num_actions=num_actions,
        equality=equality,
        nonnegative=nonnegative,
        state_guess=state_guess,
        state_initial=x1,
        state_goal=xT,
    )
