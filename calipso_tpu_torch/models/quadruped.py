"""Planar quadruped: contact-implicit drop, gaits and stance MPC, in torch
(the counterpart of `calipso_tpu/models/quadruped.py`).

Configuration q (11) = [x, z, pitch, (alpha_i, r_i) x 4]: body pose plus a
swing angle and telescoping length per leg. Foot i sits at
  p_f,i = p_body + R(pitch) @ (hip_i + r_i [sin a_i, -cos a_i]).
Controls (8) = hip torques + leg forces. Contacts: 4 feet with friction
second-order cone pairs, leg limits as plain inequalities.
State: [q1; q2] (22) at t=0, then [q1; q2; gamma(4)] (26); action u (28)
= [u_ctrl(8); gamma(4); beta(8); eta(8)]. The gaits' periodicity and
travel rows couple the first and last stages through `equality_general`,
which the riccati backend takes as a low-rank border.

The reference takes the foot Jacobians with `jax.jacfwd` and the foot
velocities with `jax.jvp`. The solver differentiates these functions
again, in reverse mode only (`solver/problem.py`), up to the third order
for the Lagrangian Hessian of the dynamics. So here the foot Jacobian J(q)
is written in closed form, a foot velocity is J(q) v, and the momentum
dL/dv is M(q) v: only dL/dq is taken by autodiff. The foot axis stays
vectorised, as in the reference: the oracles are bound by the number of
operations, and on the card every operation is a kernel launch. Numeric
constants are made once per (device, dtype) (`Const`): a copy from host
memory to the card waits for the card's queue.
"""

import numpy as np
import torch
from torch.func import grad

from calipso_tpu_torch.models.constants import Const

MASS_BODY, INERTIA_BODY = 1.0, 0.1
MASS_FOOT = 0.05
HIPS = np.array([0.3, 0.1, -0.1, -0.3])
FOOT_RADIUS = 0.02
GRAVITY = 9.81
MU = 0.8
LEG_MIN, LEG_MAX = 0.15, 0.45
ALPHA_LIM = 0.6
TIMESTEP = 0.05
NQ = 11
NU_CTRL = 8
NU = NU_CTRL + 4 + 8 + 8  # 28


def _onehot(cols, rows=4):
    """(rows, 1, NQ) with a one at column cols[f] of row f."""
    out = np.zeros((rows, 1, NQ))
    out[np.arange(rows), 0, cols] = 1.0
    return out


_HIPS = Const(HIPS)
# J = J_BASE + dtheta x E_PITCH + dalpha x E_ALPHA + dr x E_LEG (see foot_jacobians)
_J_BASE = Const(np.tile(np.eye(2, NQ)[None], (4, 1, 1)))
_E_PITCH = Const(_onehot([2, 2, 2, 2]))
_E_ALPHA = Const(_onehot(3 + 2 * np.arange(4)))
_E_LEG = Const(_onehot(4 + 2 * np.arange(4)))
_M_BODY = Const(np.diag([MASS_BODY, MASS_BODY, INERTIA_BODY] + [0.0] * 8))


def _legs(q):
    """cos/sin of the pitch, the legs' local offsets (4, 2) and the
    derivatives of those offsets by alpha and r, each (4, 2)."""
    c, s = torch.cos(q[2]), torch.sin(q[2])
    a, r = q[3::2], q[4::2]
    sa, ca = torch.sin(a), torch.cos(a)
    local = torch.stack([_HIPS.like(q) + r * sa, -r * ca], dim=1)
    d_alpha = torch.stack([r * ca, r * sa], dim=1)
    d_leg = torch.stack([sa, -ca], dim=1)
    return c, s, local, d_alpha, d_leg


def _rotate(c, s, v):
    """R(pitch) @ v for each row of v (4, 2)."""
    return torch.stack([c * v[:, 0] - s * v[:, 1], s * v[:, 0] + c * v[:, 1]], dim=1)


def foot_positions(q):
    """All four foot positions at once, (4, 2)."""
    c, s, local, _, _ = _legs(q)
    return q[:2][None, :] + _rotate(c, s, local)


def foot_position(q, i):
    return foot_positions(q)[i]


def foot_jacobians(q):
    """d foot_positions / dq, (4, 2, 11), in closed form: the body
    translation, the pitch (dR/dpitch @ local) and each leg's own alpha
    and r (R @ d local)."""
    c, s, local, d_alpha, d_leg = _legs(q)
    d_pitch = _rotate(-s, c, local)  # dR/dpitch = R(pitch + pi/2)
    return (
        _J_BASE.like(q)
        + d_pitch[:, :, None] * _E_PITCH.like(q)
        + _rotate(c, s, d_alpha)[:, :, None] * _E_ALPHA.like(q)
        + _rotate(c, s, d_leg)[:, :, None] * _E_LEG.like(q)
    )


def foot_jacobian(q, i):
    return foot_jacobians(q)[i]


def mass_matrix(q):
    """M(q) = body diag + sum_i m_f J_i' J_i (the kinetic energy of point
    feet)."""
    J = foot_jacobians(q)
    return _M_BODY.like(q) + MASS_FOOT * torch.einsum("fij,fik->jk", J, J)


def lagrangian(q, v):
    pe = MASS_BODY * GRAVITY * q[1] + MASS_FOOT * GRAVITY * foot_positions(q)[:, 1].sum()
    return 0.5 * v @ (mass_matrix(q) @ v) - pe


_D1L = grad(lagrangian, argnums=0)


def _D2L(q, v):
    """dL/dv = M(q) v."""
    return mass_matrix(q) @ v


def signed_distance(q):
    return foot_positions(q)[:, 1] - FOOT_RADIUS


def contact_impulse(q, gamma, beta):
    """sum_i J_i' [beta_i,t; gamma_i] (tangential and normal impulses)."""
    w = torch.stack([beta[1::2], gamma], dim=1)  # (4, 2)
    return torch.einsum("fij,fi->j", foot_jacobians(q), w)


def control_map(u_ctrl):
    """Hip torques act on the alpha DOFs, leg forces on the r DOFs: the
    (alpha_i, r_i) DOFs are contiguous at q[3:11] in control order."""
    return torch.cat([u_ctrl.new_zeros(3), u_ctrl])


def variational_dynamics(h, q0, q1, u_ctrl, lam, q2):
    qm1, vm1 = 0.5 * (q0 + q1), (q1 - q0) / h
    qm2, vm2 = 0.5 * (q1 + q2), (q2 - q1) / h
    d = 0.5 * h * _D1L(qm1, vm1) + _D2L(qm1, vm1) + 0.5 * h * _D1L(qm2, vm2) - _D2L(qm2, vm2)
    return d + control_map(u_ctrl) + lam


def _dyn_core(y, x, u):
    q1m, q2m = x[0:NQ], x[NQ : 2 * NQ]
    q2p, q3p = y[0:NQ], y[NQ : 2 * NQ]
    gamma, beta = u[8:12], u[12:20]
    lam = contact_impulse(q2p, gamma, beta)
    return torch.cat([q2p - q2m, variational_dynamics(TIMESTEP, q1m, q2p, u[:8], lam, q3p)])


def dynamics(y, x, u):
    # y carries [q2+, q3+, gamma]
    return torch.cat([_dyn_core(y, x, u), y[22:26] - u[8:12]])


def soc_product2(a, b):
    return torch.stack([a @ b, a[0] * b[1] + b[0] * a[1]])


def friction_equality(x, u):
    """Friction cone (4), tangential foot velocity (4) and the Jordan
    products of the (beta_i, eta_i) pairs (8), the latter interleaved per
    foot as in the reference."""
    q2, q3 = x[0:NQ], x[NQ : 2 * NQ]
    gamma, beta, eta = u[8:12], u[12:20], u[20:28]
    v = (q3 - q2) / TIMESTEP
    fc = MU * gamma - beta[0::2]
    vc = (foot_jacobians(q3) @ v)[:, 0] - eta[1::2]
    bb, ee = beta.reshape(4, 2), eta.reshape(4, 2)
    soc = torch.stack([(bb * ee).sum(dim=1), bb[:, 0] * ee[:, 1] + ee[:, 0] * bb[:, 1]], dim=1)
    return torch.cat([fc, vc, soc.reshape(8)])


def _nominal_q(x=0.0):
    q = np.zeros(NQ)
    q[0], q[1] = x, 0.3 + FOOT_RADIUS
    q[2] = 0.0
    for i in range(4):
        q[3 + 2 * i] = 0.0
        q[4 + 2 * i] = 0.3
    return q


def _bounds_rows(x, u):
    q3 = x[NQ : 2 * NQ]
    legs = q3[4::2]
    alphas = q3[3::2]
    return torch.cat(
        [legs - LEG_MIN, LEG_MAX - legs, ALPHA_LIM - alphas, alphas + ALPHA_LIM, u[:8] + 20.0, 20.0 - u[:8]]
    )


def _objectives(horizon, x_ref):
    ref = Const(x_ref)

    def obj_t(x, u):
        dx = x[: 2 * NQ] - ref.like(x)
        return 0.05 * dx @ dx + 0.5e-2 * (u[:8] @ u[:8])

    def obj_T(x, u):
        dx = x[: 2 * NQ] - ref.like(x)
        return 0.5 * dx @ dx

    return [obj_t] * (horizon - 1) + [obj_T]


def _complementarity(x):
    return x[22:26] * signed_distance(x[NQ : 2 * NQ])


def drop_problem(horizon=8, drop_height=0.1):
    """Drop from rest above the ground and land: pure contact-implicit
    dynamics feasibility."""
    q0 = _nominal_q()
    q0[1] += drop_height
    x1 = np.concatenate([q0, q0])
    q_ref = _nominal_q()
    x_ref = np.concatenate([q_ref, q_ref])
    x1_c = Const(x1)

    def eq_1(x, u):
        return torch.cat([friction_equality(x, u), x[: 2 * NQ] - x1_c.like(x)])

    def eq_t(x, u):
        return torch.cat([friction_equality(x, u), _complementarity(x)])

    def eq_last(x, u):
        return _complementarity(x)

    equality = [eq_1] + [eq_t] * (horizon - 2) + [eq_last]

    def ineq_t(x, u):
        return torch.cat([signed_distance(x[NQ : 2 * NQ]), u[8:12], _bounds_rows(x, u)])

    def ineq_last(x, u):
        q3 = x[NQ : 2 * NQ]
        legs, alphas = q3[4::2], q3[3::2]
        return torch.cat(
            [signed_distance(q3), legs - LEG_MIN, LEG_MAX - legs, ALPHA_LIM - alphas, alphas + ALPHA_LIM]
        )

    nonnegative = [ineq_t] * (horizon - 1) + [ineq_last]

    soc_stage = [(lambda x, u, _i=i: u[12 + 2 * _i : 14 + 2 * _i]) for i in range(4)] + [
        (lambda x, u, _i=i: u[20 + 2 * _i : 22 + 2 * _i]) for i in range(4)
    ]
    second_order = [soc_stage] * (horizon - 1) + [[]]

    state_guess = [x1] + [np.concatenate([x1, np.zeros(4)]) for _ in range(horizon - 1)]
    g_quarter = (MASS_BODY + 4 * MASS_FOOT) * GRAVITY * TIMESTEP / 4.0
    action_guess = [
        np.concatenate([np.zeros(8), g_quarter * np.ones(4), np.tile([0.3, 0.0], 4), np.tile([0.3, 0.0], 4)])
        for _ in range(horizon - 1)
    ]

    return dict(
        objective=_objectives(horizon, x_ref),
        dynamics=[dynamics] * (horizon - 1),
        num_states=[22] + [26] * (horizon - 1),
        num_actions=[NU] * (horizon - 1),
        equality=equality,
        nonnegative=nonnegative,
        second_order=second_order,
        state_guess=state_guess,
        action_guess=action_guess,
        state_initial=x1,
    )


def _ineq_T(q0, travel):
    """The last stage's cone rows of the gaits: the stage-local config-1
    travel (x_1[0] = q0[0] is pinned) and the feet above the ground."""

    def ineq_T(x, u):
        return torch.cat([(x[0] - (q0[0] + travel)).reshape(1), signed_distance(x[NQ : 2 * NQ])])

    return ineq_T


N_LAST = 26  # last-stage state width [q1; q2; gamma]


def _last_q2(z):
    return z[z.shape[0] - N_LAST + NQ : z.shape[0] - N_LAST + 2 * NQ]


def gait_problem(horizon=11, travel=0.2):
    """Periodic gait with a travel requirement: the final state repeats the
    first up to an x-body translation of `travel`.

    Stage 0 pins only config 1 (x[0:NQ] = q0), leaving config 2 free, so
    the config-2 periodicity and travel rows couple the first and last
    stages. They ride `equality_general`, which the riccati backend takes
    as an 11-row low-rank border; the config-1 rows reduce to stage-local
    constraints against the known q0."""
    prob = drop_problem(horizon=horizon, drop_height=0.0)
    q0 = _nominal_q()
    q_ref = _nominal_q(x=travel)
    prob["objective"] = _objectives(horizon, np.concatenate([q_ref, q_ref]))
    q0_c, q0_tail = Const(q0), Const(q0[1:NQ])

    def eq_1(x, u):
        # pin config 1 only; config 2 is set by the border and the dynamics
        return torch.cat([friction_equality(x, u), x[0:NQ] - q0_c.like(x)])

    def eq_T(x, u):
        # config-1 periodicity is stage-local: eq_1 pins x_1[0:NQ] = q0
        return torch.cat([_complementarity(x), x[1:NQ] - q0_tail.like(x)])

    prob["equality"] = [eq_1] + prob["equality"][1:-1] + [eq_T]
    prob["nonnegative"] = prob["nonnegative"][:-1] + [_ineq_T(q0, travel)]

    def equality_general(z, theta):
        # config-2 periodicity (10 rows) and exact config-2 travel (1 row)
        # between the free first-stage config 2 and the last stage
        q2_first, q2_last = z[NQ : 2 * NQ], _last_q2(z)
        return torch.cat([q2_last[1:NQ] - q2_first[1:NQ], q2_last[0:1] - q2_first[0:1] - travel])

    prob["equality_general"] = equality_general
    return prob


def mirror_config(q):
    """The leg-pair mirror of the half-cycle gait: body coordinates fixed,
    legs (0, 1) at hips (0.3, 0.1) and (2, 3) at (-0.1, -0.3) swap within
    each pair (the reference's index [0, 1, 2, 5, 6, 3, 4, 9, 10, 7, 8]),
    by slices (an index tensor would be a copy to the card per call)."""
    return torch.cat([q[0:3], q[5:7], q[3:5], q[9:11], q[7:9]])


def gait_problem_v2(horizon=11, travel=0.2, t_fix=4):
    """Mirrored half-cycle gait with a foot-pinning stance phase: for the
    first `t_fix` stages feet 1 and 3 stay at their nominal ground
    positions; the final state repeats the mirrored first state advanced
    by `travel`, through the same 11-row `equality_general` border as
    gait_problem."""
    prob = drop_problem(horizon=horizon, drop_height=0.0)
    q0 = _nominal_q()
    q_ref = _nominal_q(x=travel)
    prob["objective"] = _objectives(horizon, np.concatenate([q_ref, q_ref]))
    q0_t = torch.as_tensor(q0)
    pins = Const(np.stack([foot_position(q0_t, i).numpy() for i in (1, 3)]))
    q0_c = Const(q0)
    pq0_tail = Const(mirror_config(q0_t).numpy()[1:NQ])

    def pinned_feet(q):
        return (foot_positions(q)[1::2] - pins.like(q)).reshape(4)

    def eq_1(x, u):
        return torch.cat([friction_equality(x, u), x[0:NQ] - q0_c.like(x)])

    def eq_fix(x, u):
        # stance phase: feet 1 and 3 of the current config pinned
        return torch.cat([friction_equality(x, u), _complementarity(x), pinned_feet(x[NQ : 2 * NQ])])

    def eq_t(x, u):
        return torch.cat([friction_equality(x, u), _complementarity(x)])

    def eq_T(x, u):
        # config-1 mirrored periodicity is stage-local: x_T[1:NQ] = (P q0)[1:NQ]
        return torch.cat([_complementarity(x), x[1:NQ] - pq0_tail.like(x)])

    prob["equality"] = [eq_1] + [eq_fix] * (t_fix - 1) + [eq_t] * (horizon - 1 - t_fix) + [eq_T]
    prob["nonnegative"] = prob["nonnegative"][:-1] + [_ineq_T(q0, travel)]

    def equality_general(z, theta):
        # mirrored config-2 periodicity and exact config-2 travel
        pq, q2_last = mirror_config(z[NQ : 2 * NQ]), _last_q2(z)
        return torch.cat([q2_last[1:NQ] - pq[1:NQ], q2_last[0:1] - pq[0:1] - travel])

    prob["equality_general"] = equality_general
    return prob


def mpc_problem(horizon=4):
    """Short-horizon contact-implicit MPC problem for stance stabilization:
    the measured state (q1, q2) enters through the stage-0 parameter, so
    one solver serves every control step and every scenario of a batch."""
    prob = drop_problem(horizon=horizon, drop_height=0.0)

    def eq_1(x, u, w):
        return torch.cat([friction_equality(x, u), x[: 2 * NQ] - w])

    prob["equality"] = [eq_1] + prob["equality"][1:]
    prob["parameters"] = [np.zeros(2 * NQ)] + [np.zeros(0)] * (horizon - 1)
    return prob
