"""Bunny hop: a mountain bike (two wheel masses and a rider mass on a
rigid wheelbase link) jumps both wheels over an obstacle, in torch (the
counterpart of `calipso_tpu/models/bunnyhop.py`).

A flat NLP over z = [q_1..q_N (6 each); u_1..u_{N-1} (2);
lambda_1..lambda_{N-2} (1); eta_1..eta_{N-2} (3)]: variational discrete
Euler-Lagrange dynamics with a wheelbase pin (lambda) and ground-contact
complementarity (eta), a jump equality at the middle step, and
nonnegativity of eta and the contact gaps. It has no stage structure, so
"auto" solves it on the schur backend.

The reference takes the link's gradient and the gaps' Jacobian by
autodiff inside the dynamics; here both are closed forms (2 [(r1 - r2);
-(r1 - r2); 0; 0] and a constant 0/1 matrix), since the solver
differentiates the dynamics again. The N-2 dynamics steps are one tensor
axis: on the card every operation is a kernel launch.
"""

import numpy as np
import torch

from calipso_tpu_torch.models.constants import Const

M_RIDER1, M_RIDER2, M_BODY = 1.0, 1.0, 10.0
H = 0.2
GRAV = np.array([0.0, -9.8])
WHEEL_BASE = 2.0
N = 10


# flat indexing (reference bunnyhop.jl "problem indexing for NLP")
IDX_Q = [np.arange(6 * i, 6 * i + 6) for i in range(N)]
_u0 = IDX_Q[-1][-1] + 1
IDX_U = [np.arange(_u0 + 2 * i, _u0 + 2 * i + 2) for i in range(N - 1)]
_l0 = IDX_U[-1][-1] + 1
IDX_LAM = [np.arange(_l0 + i, _l0 + i + 1) for i in range(N - 2)]
_e0 = IDX_LAM[-1][-1] + 1
IDX_ETA = [np.arange(_e0 + 3 * i, _e0 + 3 * i + 3) for i in range(N - 2)]
NZ = IDX_ETA[-1][-1] + 1

Q0 = np.array([-WHEEL_BASE / 2, 0.0, WHEEL_BASE / 2, 0.0, 0.0, np.sqrt(1.5**2 - (WHEEL_BASE / 2) ** 2)])
Q1 = Q0 + 11 * H * np.array([1, 0, 1, 0, 1, 0.0])
USREF = [-0.95 * np.sqrt(2) * 0.5 * M_BODY * 9.8 * np.ones(2) for _ in range(N - 1)]
QSREF = [Q0 + 11 * H * i * np.array([1, 0, 1, 0, 1, 0.0]) for i in range(N)]
W_Q1 = np.array([0, 1, 0, 1, 0, 0.1])
W_Q2 = np.array([0, 1, 0, 1, 0, 1e4])

_MASS_H = Const(np.repeat([M_RIDER1, M_RIDER2, M_BODY], 2) / H)
_GRAVITY_FORCE = Const(np.concatenate([M_RIDER1 * GRAV, M_RIDER2 * GRAV, M_BODY * GRAV]))
_GAPS_OFFSET = Const([0.0, 0.0, 0.3])
# d gaps / dq (3, 6), transposed: the gaps read q[1], q[3], q[5]
_DGAPS_T = Const(np.eye(6)[:, 1::2])
_QSREF = Const(np.stack(QSREF))
_USREF = Const(np.stack(USREF))
_W_Q = Const(np.stack([W_Q2 if i > 5 else W_Q1 for i in range(N)]))
_Q01 = Const(np.concatenate([Q0, Q1]))
_JUMP = Const([1.1, 1.15])


def _control_forces(r1, r2, u):
    """Equal and opposite forces u along the unit vector from r1 to r2;
    r1, r2 (..., 2), u (...)."""
    d = -r1 + r2
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    return u[..., None] * d, -u[..., None] * d


def link(q):
    r = q[..., 0:2] - q[..., 2:4]
    return (r * r).sum(-1) - WHEEL_BASE**2


def _link_gradient(q):
    """d link / dq = 2 [(r1 - r2); -(r1 - r2); 0; 0]."""
    r = q[..., 0:2] - q[..., 2:4]
    return torch.cat([2.0 * r, -(2.0 * r), torch.zeros_like(r)], dim=-1)


def gaps(q):
    """Wheels above ground, rider above 0.3 m."""
    return q[..., 1::2] - _GAPS_OFFSET.like(q)


def _del_eq(q1, q2, q3, u_m, u_p):
    """The discrete Euler-Lagrange residual of each step, (..., 6)."""

    def forces(qa, qb, u):
        mid = 0.5 * (qa + qb)
        f1, f3a = _control_forces(mid[..., 0:2], mid[..., 4:6], u[..., 0])
        f2, f3b = _control_forces(mid[..., 2:4], mid[..., 4:6], u[..., 1])
        return torch.cat([f1, f2, f3a + f3b], dim=-1)

    Fg = _GRAVITY_FORCE.like(q1)
    Fm = Fg + forces(q1, q2, u_m)
    Fp = Fg + forces(q3, q2, u_p)
    mh = _MASS_H.like(q1)
    core = mh * (q2 - q1) - mh * (q3 - q2)
    return core + 0.5 * H * Fm + 0.5 * H * Fp


def _dyn(q1, q2, q3, lam, eta, u1, u2):
    """The dynamics rows of each step, (..., 10): the Euler-Lagrange
    residual with the link and contact impulses, the link, and the
    contact complementarity."""
    impulses = H * _link_gradient(q2) * lam + H * eta @ _DGAPS_T.like(eta).T
    return torch.cat([_del_eq(q1, q2, q3, u1, u2) + impulses, link(q3)[..., None], eta * gaps(q3)], dim=-1)


def _split(z):
    """The configurations (N, 6), actions (N-1, 2), link impulses (N-2, 1)
    and contact impulses (N-2, 3) of z."""
    q = z[: _u0].reshape(N, 6)
    u = z[_u0:_l0].reshape(N - 1, 2)
    lam = z[_l0:_e0].reshape(N - 2, 1)
    eta = z[_e0:NZ].reshape(N - 2, 3)
    return q, u, lam, eta


def objective(z):
    q, u, _, _ = _split(z)
    dq = q - _QSREF.like(z)
    J = 0.5 * (dq * (_W_Q.like(z) * dq)).sum()
    J = J + 10.0 * ((q[:, 4] - 0.5 * (q[:, 0] + q[:, 2])) ** 2).sum()
    du = u - _USREF.like(z)
    J = J + 0.5 * 0.01 * (du * du).sum()
    step = q[:-1] - q[1:]
    J = J + 0.005 * (step * step).sum()
    xs = q[:, 0::2]
    a = xs[2:] - 2 * xs[1:-1] + xs[:-2]
    return J + 10.0 * (a * a).sum()


def equality(z):
    q, u, lam, eta = _split(z)
    dyn = _dyn(q[:-2], q[1:-1], q[2:], lam, eta, u[:-1], u[1:])
    return torch.cat(
        [
            dyn.reshape(-1),
            z[:12] - _Q01.like(z),
            # jump constraint: both wheels clear the obstacle at step 5
            q[4, 1:4:2] - _JUMP.like(z),
        ]
    )


def inequality(z):
    q, _, _, eta = _split(z)
    return torch.cat([eta.reshape(-1), gaps(q).reshape(-1)])


def initial_guess(seed=0):
    rng = np.random.default_rng(seed)
    z = 10.0 * np.ones(NZ)
    for i in range(N):
        z[IDX_Q[i]] = QSREF[i] + 1e-3 * np.abs(rng.normal(size=6))
    for i in range(N - 1):
        z[IDX_U[i]] = USREF[i] + 1e-3 * rng.normal(size=2)
    for i in range(N - 2):
        z[IDX_ETA[i]] = 9.8 * np.array([M_RIDER1, M_RIDER2, M_BODY])
    return z + 1e-3 * rng.normal(size=NZ)
