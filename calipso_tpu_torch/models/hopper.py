"""Planar hopper gait: contact-implicit trajopt with nonlinear (SOC)
friction cones, complementarity, joint limits and gait periodicity, in
torch (the counterpart of `calipso_tpu/models/hopper.py`).

Configuration q = [x_body, z_body, body_angle, leg_length]:
  foot position  p_f = (x + r sin th, z - r cos th)
Contacts (4): body-ground, foot-ground, leg min/max limits.
Action u (14) = [controls(2); gamma(4); beta(4); eta(4)]: gamma contact
impulses, beta = (slack, force) friction pairs, eta = (slack, tangential
velocity) duals; |beta2| <= beta1 = mu*gamma through 2-d SOCs on the
(beta, eta) pairs with beta o eta = 0.
State: [q1; q2] at t=0 (8), then [q1; q2; gamma_prev(4)] (12). The gait's
periodicity and travel rows couple the first and last stages through
`equality_general`, which the riccati backend takes as a low-rank border;
`gait_problem(carry_first_state=True)` instead carries a copy of x_1 in
every stage's state, as the reference's Julia example does.

The solver differentiates the dynamics again, in reverse mode only
(`solver/problem.py`), up to the third order for the Lagrangian Hessian
of the dynamics. So the foot Jacobian is written in closed form and the
momentum dL/dv is M(q) v: only dL/dq is taken by autodiff. Numeric
constants are made once per (device, dtype) (`Const`).
"""

import numpy as np
import torch
from torch.func import grad

from calipso_tpu_torch.models.constants import Const

MASS_BODY, MASS_FOOT = 1.0, 0.1
INERTIA_BODY = 0.1
BODY_RADIUS, FOOT_RADIUS = 0.1, 0.05
GRAVITY = 9.81
MU_BODY, MU_FOOT = 0.5, 0.5
LEG_MIN, LEG_MAX = 0.25, 1.0
TIMESTEP = 0.05
NQ, NU_CTRL = 4, 2
NU = NU_CTRL + 4 + 4 + 4  # controls, gamma, beta, eta

_EYE2 = Const(np.eye(2))
_M_BODY = Const(np.diag([MASS_BODY, MASS_BODY, INERTIA_BODY, 1.0e-4]))
_MU = Const([MU_BODY, MU_FOOT])


def kinematics_foot(q):
    return torch.stack([q[0] + q[3] * torch.sin(q[2]), q[1] - q[3] * torch.cos(q[2])])


def foot_jacobian(q):
    """d kinematics_foot / dq, (2, 4): [I | [[r c, s], [r s, -c]]]."""
    s, c, r = torch.sin(q[2]), torch.cos(q[2]), q[3]
    return torch.cat([_EYE2.like(q), torch.stack([r * c, s, r * s, -c]).reshape(2, 2)], dim=1)


def mass_matrix(q):
    J = foot_jacobian(q)
    return _M_BODY.like(q) + MASS_FOOT * J.T @ J


def potential(q):
    zf = q[1] - q[3] * torch.cos(q[2])
    return GRAVITY * (MASS_BODY * q[1] + MASS_FOOT * zf)


def lagrangian(q, v):
    return 0.5 * v @ (mass_matrix(q) @ v) - potential(q)


_D1L = grad(lagrangian, argnums=0)


def _D2L(q, v):
    """dL/dv = M(q) v."""
    return mass_matrix(q) @ v


def signed_distance(q):
    zf = q[1] - q[3] * torch.cos(q[2])
    return torch.stack([q[1] - BODY_RADIUS, zf - FOOT_RADIUS, q[3] - LEG_MIN, LEG_MAX - q[3]])


def contact_impulse(q, gamma, beta):
    """Generalized contact impulse: body (tangent, normal), foot (tangent,
    normal), leg-limit impulses, plus the body rolling moment
    (BODY_RADIUS * beta[1] on the angle), as one out-of-place sum."""
    body = torch.stack([beta[1], gamma[0], BODY_RADIUS * beta[1], gamma[2] - gamma[3]])
    return body + foot_jacobian(q).T @ torch.stack([beta[3], gamma[1]])


def variational_dynamics(h, q0, q1, u_ctrl, lam, q2):
    """Variational midpoint integrator residual."""
    qm1, vm1 = 0.5 * (q0 + q1), (q1 - q0) / h
    qm2, vm2 = 0.5 * (q1 + q2), (q2 - q1) / h
    d = 0.5 * h * _D1L(qm1, vm1) + _D2L(qm1, vm1) + 0.5 * h * _D1L(qm2, vm2) - _D2L(qm2, vm2)
    # the controls act on the angle and the leg length
    return d + torch.cat([u_ctrl.new_zeros(2), u_ctrl]) + lam


def _dyn_core(y, x, u):
    q1m, q2m = x[0:4], x[4:8]
    q2p, q3p = y[0:4], y[4:8]
    gamma, beta = u[2:6], u[6:10]
    lam = contact_impulse(q2p, gamma, beta)
    return torch.cat([q2p - q2m, variational_dynamics(TIMESTEP, q1m, q2p, u[:2], lam, q3p)])


def dynamics(y, x, u):
    # y carries [q2+, q3+, gamma]
    return torch.cat([_dyn_core(y, x, u), y[8:12] - u[2:6]])


def dynamics_first_carried(y, x, u):
    # y carries [q2+, q3+, gamma, x_first(8)]
    return torch.cat([_dyn_core(y, x, u), y[8:12] - u[2:6], y[12:20] - x])


def dynamics_t_carried(y, x, u):
    return torch.cat([_dyn_core(y, x, u), y[8:12] - u[2:6], y[12:20] - x[12:20]])


def soc_product2(a, b):
    return torch.stack([a @ b, a[0] * b[1] + b[0] * a[1]])


def friction_equality(x, u):
    """fc (2), vc (2), SOC products beta o eta (4), pair by pair."""
    q2, q3 = x[0:4], x[4:8]
    gamma, beta, eta = u[2:6], u[6:10], u[10:14]
    fc = _MU.like(x) * gamma[:2] - beta[0::2]
    v = (q3 - q2) / TIMESTEP
    vT_body = v[0] + BODY_RADIUS * v[2]
    vT_foot = foot_jacobian(q3)[0] @ v
    vc = torch.stack([vT_body - eta[1], vT_foot - eta[3]])
    bb, ee = beta.reshape(2, 2), eta.reshape(2, 2)
    soc = torch.stack([(bb * ee).sum(dim=1), bb[:, 0] * ee[:, 1] + ee[:, 0] * bb[:, 1]], dim=1)
    return torch.cat([fc, vc, soc.reshape(4)])


def _limits(x):
    """The heights and leg lengths of both configurations, and the legs'
    upper limits: [x1, x3, x5, x7, 1 - x3, 1 - x7]."""
    return torch.cat([x[1:8:2], 1.0 - x[3:8:4]])


def gait_problem(horizon=21, travel=0.5, carry_first_state=False):
    q1 = np.array([0.0, 0.5 + FOOT_RADIUS, 0.0, 0.5])
    q_ref = np.array([0.5, 0.5 + FOOT_RADIUS, 0.0, 0.25])
    x1 = np.concatenate([q1, q1])
    x_ref = np.concatenate([q_ref, q_ref])
    r_cost, q_cost = 1.0e-1, 1.0e-1
    foot1 = np.array([q1[0] + q1[3] * np.sin(q1[2]), q1[1] - q1[3] * np.cos(q1[2])])
    x_ref_c, q1_c, q1_tail = Const(x_ref), Const(q1), Const(q1[1:4])
    foot1_c = Const(np.concatenate([foot1, foot1]))
    u_low = Const([-10.0, -10.0, 0.0, 0.0, 0.0, 0.0])

    nx_t = 20 if carry_first_state else 12
    num_states = [8] + [nx_t] * (horizon - 1)
    num_actions = [NU] * (horizon - 1)

    def obj1(x, u):
        dx = x - x_ref_c.like(x)
        return 0.5 * dx @ dx + 0.5 * r_cost * (u[:2] @ u[:2])

    def objt(x, u):
        dx = x[:8] - x_ref_c.like(x)
        return 0.5 * q_cost * dx @ dx + 0.5 * r_cost * (u[:2] @ u[:2])

    def objT(x, u):
        dx = x[:8] - x_ref_c.like(x)
        return 0.5 * dx @ dx

    objective = [obj1] + [objt] * (horizon - 2) + [objT]

    def eq_1(x, u):
        feet = torch.cat([kinematics_foot(x[0:4]), kinematics_foot(x[4:8])])
        return torch.cat([feet - foot1_c.like(x), friction_equality(x, u), x[0:4] - q1_c.like(x)])

    def compl(x):
        return x[8:12] * signed_distance(x[4:8])

    def eq_t(x, u):
        return torch.cat([friction_equality(x, u), compl(x)])

    def eq_T_carried(x, u):
        # periodicity in (z, angle, leg) for both configurations against
        # the carried first state
        th = x[12:20]
        return torch.cat([compl(x), x[1:4] - th[1:4], x[5:8] - th[5:8]])

    def eq_T(x, u):
        # config-1 periodicity rows are stage-local: eq_1 pins x[0:4] = q1,
        # so x_T[1:4] - x_1[1:4] reduces to x[1:4] - q1[1:4]
        return torch.cat([compl(x), x[1:4] - q1_tail.like(x)])

    equality = [eq_1] + [eq_t] * (horizon - 2) + [eq_T_carried if carry_first_state else eq_T]

    def ineq_1(x, u):
        return torch.cat(
            [signed_distance(x[4:8]), u[0:6] - u_low.like(u), 10.0 - u[0:2], _limits(x)]
        )

    ineq_t = ineq_1

    def ineq_T_carried(x, u):
        th = x[12:20]
        moved = torch.stack([x[0] - th[0] - travel, x[4] - th[4] - travel])
        return torch.cat([moved, signed_distance(x[4:8]), _limits(x)])

    def ineq_T(x, u):
        # config-1 travel is stage-local too (x_1[0] = q1[0] is pinned)
        return torch.cat(
            [signed_distance(x[4:8]), (x[0] - (q1[0] + travel)).reshape(1), _limits(x)]
        )

    nonnegative = [ineq_1] + [ineq_t] * (horizon - 2) + [ineq_T_carried if carry_first_state else ineq_T]

    # 2-d SOC pairs (beta and eta per contact) per stage
    soc_stage = [
        lambda x, u: u[6:8],
        lambda x, u: u[8:10],
        lambda x, u: u[10:12],
        lambda x, u: u[12:14],
    ]
    second_order = [soc_stage] * (horizon - 1) + [[]]

    if carry_first_state:
        state_guess = [x1] + [np.concatenate([x1, np.zeros(4), x1]) for _ in range(horizon - 1)]
        dyn = [dynamics_first_carried] + [dynamics_t_carried] * (horizon - 2)
        equality_general = None
    else:
        state_guess = [x1] + [np.concatenate([x1, np.zeros(4)]) for _ in range(horizon - 1)]
        dyn = [dynamics] * (horizon - 1)

        def equality_general(z, theta):
            # the rows that couple stages: config-2 periodicity (x_1[4:8] is
            # free: eq_1 pins the foot kinematics, not the configuration)
            # and the config-2 travel, made exact
            n = z.shape[0]
            x_first, x_last = z[0:8], z[n - 12 : n - 4]
            return torch.cat([x_last[5:8] - x_first[5:8], x_last[4:5] - x_first[4:5] - travel])

    action_guess = [
        np.concatenate([[0.0, GRAVITY * MASS_BODY * 0.5 * TIMESTEP], 1.0e-1 * np.ones(NU - 2)])
        for _ in range(horizon - 1)
    ]

    return dict(
        objective=objective,
        dynamics=dyn,
        num_states=num_states,
        num_actions=num_actions,
        equality=equality,
        equality_general=equality_general,
        nonnegative=nonnegative,
        second_order=second_order,
        state_guess=state_guess,
        action_guess=action_guess,
        state_initial=x1,
    )
