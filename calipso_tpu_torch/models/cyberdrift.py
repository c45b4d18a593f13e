"""CYBERDRIFT: a planar car drifting around obstacles with second-order
cone friction at its front and rear contact patches, in torch (the
counterpart of `calipso_tpu/models/cyberdrift.py`).

Configuration q = [x, y, yaw]; state [q_prev; q_cur]; action u (14) =
[v_cmd, omega_cmd; beta1(3); eta1(3); beta2(3); eta2(3)], where (beta_i,
eta_i) are the 3-d SOC friction primal/dual triples of each contact.

The solver differentiates the dynamics and the contact equalities again,
in reverse mode only (`solver/problem.py`), up to the third order. So
the contact and input Jacobians are written in closed form, as the
products of their sines and cosines with the patch offsets, and no
matrix is built inside a derivative. Numeric constants are made once per
(device, dtype) (`Const`)."""

import numpy as np
import torch

from calipso_tpu_torch.models.constants import Const
from calipso_tpu_torch.trajopt.transcription import linear_interpolation

MASS, INERTIA = 1.0, 0.1
MU = (0.5, 0.25)  # front, rear
KIN_FRONT = np.array([0.1, 0.0])
KIN_REAR = np.array([-0.1, 0.0])
TIMESTEP = 0.1
NQ, NU = 3, 14

_M = Const([MASS, MASS, INERTIA])
_RU = Const(np.concatenate([np.ones(2), 1.0e-5 * np.ones(12)]))


def _rotated(c, s, r):
    """R(yaw) r for a constant offset r: (c r0 - s r1, s r0 + c r1)."""
    return c * r[0] - s * r[1], s * r[0] + c * r[1]


def contact_jacobian(q):
    """(4, 3): [tangent-plane velocities of the front patch; the rear
    patch's]."""
    c, s = torch.cos(q[2]), torch.sin(q[2])
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    fx, fy = _rotated(c, s, KIN_FRONT)
    rx, ry = _rotated(c, s, KIN_REAR)
    return torch.stack(
        [
            torch.stack([one, zero, fy]),
            torch.stack([zero, one, -fx]),
            torch.stack([one, zero, ry]),
            torch.stack([zero, one, -rx]),
        ]
    )


def contact_impulse(q, b1, b2):
    """contact_jacobian(q)' [b1; b2] for the tangent pairs b1, b2 (2,)."""
    c, s = torch.cos(q[2]), torch.sin(q[2])
    fx, fy = _rotated(c, s, KIN_FRONT)
    rx, ry = _rotated(c, s, KIN_REAR)
    return torch.stack(
        [b1[0] + b2[0], b1[1] + b2[1], fy * b1[0] - fx * b1[1] + ry * b2[0] - rx * b2[1]]
    )


def input_jacobian(q):
    c, s = torch.cos(q[2]), torch.sin(q[2])
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([torch.stack([c, s, zero]), torch.stack([zero, zero, one])])


def input_force(q, v):
    """input_jacobian(q)' v for the commands v (2,)."""
    c, s = torch.cos(q[2]), torch.sin(q[2])
    return torch.stack([c * v[0], s * v[0], v[1]])


def dynamics(y, x, u):
    """Variational midpoint with a constant diagonal mass matrix (D1L = 0:
    no in-plane gravity)."""
    M = _M.like(x)
    h = TIMESTEP
    q1m, q2m = x[0:3], x[3:6]
    q2p, q3p = y[0:3], y[3:6]
    lam = contact_impulse(q2p, u[3:5], u[9:11])
    vm1 = (q2p - q1m) / h
    vm2 = (q3p - q2p) / h
    qm2 = 0.5 * (q2p + q3p)
    d = M * vm1 - M * vm2 + input_force(qm2, u[0:2]) + lam
    return torch.cat([q2p - q2m, d])


def soc_product3(a, b):
    return torch.cat([(a @ b).reshape(1), a[0] * b[1:] + b[0] * a[1:]])


def _patch_velocities(q3, v):
    """contact_jacobian(q3) @ v, (4,)."""
    c, s = torch.cos(q3[2]), torch.sin(q3[2])
    fx, fy = _rotated(c, s, KIN_FRONT)
    rx, ry = _rotated(c, s, KIN_REAR)
    return torch.stack(
        [v[0] + fy * v[2], v[1] - fx * v[2], v[0] + ry * v[2], v[1] - rx * v[2]]
    )


def contact_equality(x, u):
    q2, q3 = x[0:3], x[3:6]
    b1, e1 = u[2:5], u[5:8]
    b2, e2 = u[8:11], u[11:14]
    v = _patch_velocities(q3, (q3 - q2) / TIMESTEP)
    return torch.cat(
        [
            (b1[0] - MU[0] * MASS * 9.81 * TIMESTEP).reshape(1),
            (b2[0] - MU[1] * MASS * 9.81 * TIMESTEP).reshape(1),
            v[0:2] - e1[1:3],
            v[2:4] - e2[1:3],
            soc_product3(b1, e1),
            soc_product3(b2, e2),
        ]
    )


def drift_problem(horizon=15):
    x1 = np.array([0.0, 1.5, -0.5 * np.pi] * 2)
    xg = np.array([3.0, 0.0, 0.5 * np.pi] * 2)
    u_min, u_max = np.array([0.0, -0.5]), np.array([25.0, 0.5])
    p_car1, p_car2 = (3.0, 0.65), (3.0, -0.65)
    x1_c, xg_c = Const(x1), Const(xg)
    u_min_c, u_max_c = Const(u_min), Const(u_max)

    def vel_term(x):
        v = (x[3:6] - x[0:3]) / TIMESTEP
        return v @ v

    def obj_t(x, u):
        dx = x - xg_c.like(x)
        return 0.5e-3 * vel_term(x) + 0.5e-3 * dx @ dx + 0.5e-3 * u @ (_RU.like(u) * u)

    def obj_T(x, u):
        dx = x - xg_c.like(x)
        return 2.5 * vel_term(x) + 0.5e-3 * dx @ dx

    objective = [obj_t] * (horizon - 1) + [obj_T]

    def eq_1(x, u):
        return torch.cat([contact_equality(x, u), x - x1_c.like(x)])

    def eq_t(x, u):
        return contact_equality(x, u)

    def eq_T(x, u):
        return x[0:3] - xg_c.like(x)[0:3]

    equality = [eq_1] + [eq_t] * (horizon - 2) + [eq_T]

    def circle(x, p, r):
        return ((x[0] - p[0]) ** 2 + (x[1] - p[1]) ** 2 - r**2).reshape(1)

    def ineq_t(x, u):
        return torch.cat(
            [
                u_max_c.like(u) - u[0:2],
                u[0:2] - u_min_c.like(u),
                circle(x, p_car1, 0.1),
                circle(x, p_car2, 0.1),
            ]
        )

    nonnegative = [ineq_t] * (horizon - 1) + [None]

    soc_stage = [
        lambda x, u: u[2:5],
        lambda x, u: u[5:8],
        lambda x, u: u[8:11],
        lambda x, u: u[11:14],
    ]
    second_order = [soc_stage] * (horizon - 1) + [[]]

    state_guess = linear_interpolation(x1, xg, horizon)
    return dict(
        objective=objective,
        dynamics=[dynamics] * (horizon - 1),
        num_states=[6] * horizon,
        num_actions=[NU] * (horizon - 1),
        equality=equality,
        nonnegative=nonnegative,
        second_order=second_order,
        state_guess=state_guess,
        state_initial=x1,
        state_goal=xg,
    )
