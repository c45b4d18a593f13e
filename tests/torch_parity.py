"""Shared pieces of the PyTorch port's parity tests: the same problems
built in both packages, and seeded numpy inputs.

Tier-1 runs several pytest workers on few CPUs, so torch is held to one
thread here (its default is one thread per core in every worker). JAX is
imported only where a JAX problem is built: the card's machine, which runs
the CUDA kernel tests, has no JAX.
"""

import math

import numpy as np
import torch

torch.set_num_threads(1)


def spd_batch(rng, B, n, non_pd=()):
    """(B, n, n) SPD matrices D D' + n I from numpy; the lanes in `non_pd`
    are negated (not positive definite)."""
    D = rng.normal(size=(B, n, n))
    S = D @ np.swapaxes(D, 1, 2) + n * np.eye(n)
    for i in non_pd:
        S[i] = -S[i]
    return S


def nan_lanes(L):
    """Lanes whose factor holds a NaN."""
    return np.isnan(np.asarray(L)).any(axis=(-2, -1))


def pendulum_solver(pkg, horizon, options, cones=False):
    """The benchmark flagship's pendulum swing-up (initial state as the
    stage-0 parameter) as a TrajOptSolver of package `pkg` ("jax" or
    "torch"). With `cones`, every action is bounded to |u| <= 17 (two
    orthant rows) and every stage's velocity to |x_2| <= 10 (a
    2-dimensional second-order cone); both bounds are active at the
    solution, so the cone paths of the solve run."""
    if pkg == "jax":
        import jax.numpy as jnp

        from calipso_tpu import TrajOptSolver
        from calipso_tpu.models import pendulum

        bound = lambda x, u, w: jnp.array([17.0 - u[0], u[0] + 17.0])
        speed = lambda x, u, w: jnp.array([10.0, x[1]])
    else:
        from calipso_tpu_torch import TrajOptSolver
        from calipso_tpu_torch.models import pendulum

        bound = lambda x, u, w: torch.stack([17.0 - u[0], u[0] + 17.0])
        speed = lambda x, u, w: torch.stack([torch.full_like(x[1], 10.0), x[1]])
    prob = pendulum.swingup_problem(horizon, parametric_initial_state=True)
    extra = {} if pkg == "jax" else dict(device="cpu")
    if cones:
        extra.update(
            nonnegative=[bound] * (horizon - 1) + [None],
            second_order=[[speed]] * horizon,
        )
    ts = TrajOptSolver(
        prob["objective"], prob["dynamics"], prob["num_states"], prob["num_actions"],
        equality=prob["equality"], parameters=prob["parameters"], options=options, **extra,
    )
    ts.initialize_states(prob["state_guess"])
    return ts


# ---- the cartpole swing-up of __graft_entry__.py, in both packages ---------


def _cartpole_jax(x, u):
    import jax.numpy as jnp

    mc, mp, l, g = 1.0, 0.2, 0.5, 9.81
    q2, qd = x[1], x[2:]
    s, c = jnp.sin(q2), jnp.cos(q2)
    H = jnp.array([[mc + mp, mp * l * c], [mp * l * c, mp * l**2]])
    Cvec = jnp.array([-mp * qd[1] * l * s * qd[1], 0.0])
    G = jnp.array([0.0, mp * g * l * s])
    B = jnp.array([1.0, 0.0])
    qdd = jnp.linalg.solve(H, B * u[0] - Cvec - G)
    return jnp.concatenate([qd, qdd])


def _cartpole_torch(x, u):
    mc, mp, l, g = 1.0, 0.2, 0.5, 9.81
    q2, qd = x[1], x[2:]
    s, c = torch.sin(q2), torch.cos(q2)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    H = torch.stack(
        [torch.stack([(mc + mp) * one, mp * l * c]), torch.stack([mp * l * c, mp * l**2 * one])]
    )
    Cvec = torch.stack([-mp * qd[1] * l * s * qd[1], zero])
    G = torch.stack([zero, mp * g * l * s])
    Bu = torch.stack([u[0], zero])
    qdd = torch.linalg.solve(H, Bu - Cvec - G)
    return torch.cat([qd, qdd])


def cartpole_solver(pkg, horizon, options):
    """`__graft_entry__._cartpole_trajopt` with the given options."""
    nx, nu = 4, 1
    goal = [0.0, math.pi, 0.0, 0.0]
    if pkg == "jax":
        import jax.numpy as jnp

        from calipso_tpu import TrajOptSolver

        cont = _cartpole_jax
        x_goal = jnp.array(goal)
        goal_eq = lambda x, u, w: x - x_goal
        extra = {}
    else:
        from calipso_tpu_torch import TrajOptSolver

        cont = _cartpole_torch
        goal_eq = lambda x, u, w: x - torch.tensor(goal, dtype=x.dtype, device=x.device)
        extra = dict(device="cpu")

    def midpoint(y, x, u):
        return y - (x + 0.05 * cont(0.5 * (x + y), u))

    objective = [
        *[(lambda x, u, w: 0.1 * x @ x + 0.1 * u @ u)] * (horizon - 1),
        lambda x, u, w: 0.1 * x @ x,
    ]
    equality = [lambda x, u, w: x - w, *[None] * (horizon - 2), goal_eq]
    ts = TrajOptSolver(
        objective, [midpoint] * (horizon - 1), [nx] * horizon, [nu] * (horizon - 1),
        equality=equality, parameters=[np.zeros(nx)] + [np.zeros(0)] * (horizon - 1),
        options=options, **extra,
    )
    ts.initialize_states([np.array(goal) * t / (horizon - 1) for t in range(horizon)])
    return ts
