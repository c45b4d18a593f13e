"""Planar box move: contact-implicit sliding with corner contacts and
friction cones, in torch (the counterpart of `calipso_tpu/models/box.py`).

Configuration q = [x, z, yaw]; 4 corners at (+-w, +-h) body frame contact
the ground z=0. Per corner: normal impulse gamma_i, friction SOC pair
(beta_i = (slack, force), eta_i = (slack, tangential velocity)).
State: [q_prev; q_cur] (6) at t=0, then + gamma memory (10).
Action u (23) = [F(3); gamma(4); beta(8); eta(8)].

The Lagrangian is quadratic in v and linear in q, so dL/dq = [0, -m g, 0]
and dL/dv = M v in closed form, as are the corner Jacobians. The four
corners are one tensor axis: on the card every operation is a kernel
launch."""

import numpy as np
import torch

from calipso_tpu_torch.models.constants import Const
from calipso_tpu_torch.trajopt.transcription import linear_interpolation

MASS, INERTIA = 1.0, 0.1
HALF_W, HALF_H = 0.5, 0.5
GRAVITY = 9.81
MU = 0.5
TIMESTEP = 0.1
CORNERS = np.array([[HALF_W, HALF_H], [HALF_W, -HALF_H], [-HALF_W, HALF_H], [-HALF_W, -HALF_H]])
NU = 3 + 4 + 8 + 8

_CX, _CZ = Const(CORNERS[:, 0]), Const(CORNERS[:, 1])
_MASS = Const([MASS, MASS, INERTIA])
_GRAVITY_FORCE = Const([0.0, -MASS * GRAVITY, 0.0])
# J_i = J_BASE + (d corner_i / d yaw) x E_YAW (see corner_jacobians)
_J_BASE = Const(np.tile(np.eye(2, 3)[None], (4, 1, 1)))
_E_YAW = Const(np.eye(3)[2][None, None])


def _rotated(q):
    """The corners' offsets from the centre in the world frame, (4, 2),
    and their derivatives by the yaw, (4, 2)."""
    c, s = torch.cos(q[2]), torch.sin(q[2])
    cx, cz = _CX.like(q), _CZ.like(q)
    offsets = torch.stack([cx * c - cz * s, cx * s + cz * c], dim=1)
    d_yaw = torch.stack([-cx * s - cz * c, cx * c - cz * s], dim=1)
    return offsets, d_yaw


def corner_positions(q):
    return q[:2][None, :] + _rotated(q)[0]  # (4, 2)


def corner_jacobians(q):
    """(4, 2, 3) Jacobians of the corners' world positions by q (rows: x,
    z)."""
    return _J_BASE.like(q) + _rotated(q)[1][:, :, None] * _E_YAW.like(q)


def corner_jacobian(q, i):
    """(2, 3) Jacobian of corner i's world position by q."""
    return corner_jacobians(q)[i]


def signed_distance(q):
    return corner_positions(q)[:, 1]  # (4,) corner heights


def lagrangian(q, v):
    return 0.5 * v @ (_MASS.like(v) * v) - MASS * GRAVITY * q[1]


def _D1L(q, v):
    """dL/dq = [0, -m g, 0]."""
    return _GRAVITY_FORCE.like(q)


def _D2L(q, v):
    """dL/dv = M v."""
    return _MASS.like(v) * v


def dynamics(y, x, u):
    h = TIMESTEP
    q1m, q2m = x[0:3], x[3:6]
    q2p, q3p = y[0:3], y[3:6]
    # sum_i J_i' [beta_i force; gamma_i]
    w = torch.stack([u[8:15:2], u[3:7]], dim=1)  # (4, 2)
    lam = torch.einsum("fij,fi->j", corner_jacobians(q2p), w)
    qm1, vm1 = 0.5 * (q1m + q2p), (q2p - q1m) / h
    qm2, vm2 = 0.5 * (q2p + q3p), (q3p - q2p) / h
    d = 0.5 * h * _D1L(qm1, vm1) + _D2L(qm1, vm1) + 0.5 * h * _D1L(qm2, vm2) - _D2L(qm2, vm2)
    d = d + u[0:3] + lam
    return torch.cat([q2p - q2m, d, y[6:10] - u[3:7]])


def dynamics_first(y, x, u):
    return dynamics(y, x, u)


def soc_product2(a, b):
    return torch.stack([a @ b, a[0] * b[1] + b[0] * a[1]])


def contact_equality(x, u):
    """Per corner, interleaved as in the reference: friction cone,
    tangential velocity, and the two Jordan-product rows of (beta_i,
    eta_i)."""
    q2, q3 = x[0:3], x[3:6]
    gamma = u[3:7]
    v = (q3 - q2) / TIMESTEP
    bb, ee = u[7:15].reshape(4, 2), u[15:23].reshape(4, 2)
    vT = corner_jacobians(q3)[:, 0] @ v
    rows = torch.stack(
        [MU * gamma - bb[:, 0], vT - ee[:, 1], (bb * ee).sum(dim=1), bb[:, 0] * ee[:, 1] + ee[:, 0] * bb[:, 1]],
        dim=1,
    )
    return rows.reshape(16)


def move_problem(horizon=11):
    q1 = np.array([0.0, HALF_H, 0.0])
    qT = np.array([1.0, HALF_H, 0.0])
    x1 = np.concatenate([q1, q1])
    xg = np.concatenate([qT, qT])
    x1_c, xg_c = Const(x1), Const(xg)

    def obj_t(x, u):
        dx = x[:6] - xg_c.like(x)
        return 0.5 * dx @ dx + 0.5e-2 * (u[0:3] @ u[0:3])

    def obj_T(x, u):
        dx = x[:6] - xg_c.like(x)
        return 0.5 * dx @ dx

    objective = [obj_t] * (horizon - 1) + [obj_T]

    def compl(x):
        return x[6:10] * signed_distance(x[3:6])

    def eq_1(x, u):
        return torch.cat([contact_equality(x, u), x[0:6] - x1_c.like(x)])

    def eq_t(x, u):
        return torch.cat([contact_equality(x, u), compl(x)])

    def eq_T(x, u):
        return torch.cat([compl(x), x[0:6] - xg_c.like(x)])

    equality = [eq_1] + [eq_t] * (horizon - 2) + [eq_T]

    def ineq_t(x, u):
        return torch.cat([signed_distance(x[3:6]), u[3:7]])

    def ineq_T(x, u):
        return signed_distance(x[3:6])

    nonnegative = [ineq_t] * (horizon - 1) + [ineq_T]

    soc_stage = [(lambda x, u, _i=i: u[7 + 2 * _i : 9 + 2 * _i]) for i in range(4)] + [
        (lambda x, u, _i=i: u[15 + 2 * _i : 17 + 2 * _i]) for i in range(4)
    ]
    second_order = [soc_stage] * (horizon - 1) + [[]]

    interp = linear_interpolation(x1, xg, horizon)
    state_guess = [np.asarray(interp[0])] + [
        np.concatenate([np.asarray(interp[t]), np.zeros(4)]) for t in range(1, horizon)
    ]
    # support impulses: bottom corners carry the weight
    g_half = MASS * GRAVITY * TIMESTEP / 2.0
    action_guess = [
        np.concatenate([np.zeros(3), [0.0, g_half, 0.0, g_half], np.tile([0.2, 0.0], 4), np.tile([0.2, 0.0], 4)])
        for _ in range(horizon - 1)
    ]

    return dict(
        objective=objective,
        dynamics=[dynamics] * (horizon - 1),
        num_states=[6] + [10] * (horizon - 1),
        num_actions=[NU] * (horizon - 1),
        equality=equality,
        nonnegative=nonnegative,
        second_order=second_order,
        state_guess=state_guess,
        action_guess=action_guess,
        state_initial=x1,
        state_goal=xg,
    )
