"""Contact-implicit trajectory optimization examples
(`examples/contact_implicit.py`; reference examples/contact_implicit/):
the hopper gait with cross-stage periodicity through equality_general
(the riccati backend's low-rank border), ball-in-cup with string-length
SOCs, and the quadruped gaits, in float64.

Run:  python -m calipso_tpu_torch.examples.contact_implicit [hopper|ball|quadruped|quadruped_v2] [--cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from calipso_tpu_torch import Options, TrajOptSolver

HOPPER_OPTIONS = Options(verbose=True, print_frequency=25)


def _build(prob, options=Options(), device="cuda"):
    kw = {
        k: v
        for k, v in prob.items()
        if k
        not in ("state_guess", "state_initial", "state_goal", "action_guess", "penalty_initial")
    }
    ts = TrajOptSolver(options=options, device=device, **kw)
    ts.initialize_states(prob["state_guess"])
    if "action_guess" in prob:
        ts.initialize_actions(prob["action_guess"])
    return ts


def _solve(ts):
    """(result, wall seconds) of ts.solve() run to the device's end."""
    t0 = time.time()
    res = ts.solve()
    if ts.solver.device.type == "cuda":
        torch.cuda.synchronize()
    return res, time.time() - t0


def _outcome(ts, res, wall, **printed):
    return {
        "solved": bool(res.solved),
        "iterations": int(res.iterations),
        "seconds": wall,
        **printed,
        "variables": res.variables.detach().cpu().numpy(),
        "solver": ts,
        "result": res,
    }


def hopper_gait(device="cuda"):
    """Planar hopper gait: SOC friction cones, impact complementarity,
    joint limits, gait periodicity + travel coupling first/last stages
    through equality_general -- handled by the structured riccati backend
    as a low-rank border (reference test/examples/hopper_gait.jl)."""
    from calipso_tpu_torch.models import hopper

    ts = _build(hopper.gait_problem(), HOPPER_OPTIONS, device)
    res, wall = _solve(ts)
    states, actions = ts.get_trajectory(res)
    travel = float(states[-1][0] - states[0][0])
    z = [float(s[1]) for s in states]
    print(f"solved={bool(res.solved)} iters={int(res.iterations)} "
          f"backend={ts.solver.options.linear_solver}")
    print(f"body travel: {travel:.3f} m (z range {min(z):.3f}..{max(z):.3f})")
    return _outcome(ts, res, wall, backend=ts.solver.options.linear_solver, travel=travel, z_range=(min(z), max(z)))


def ball_in_cup(device="cuda"):
    """Ball-in-cup: swing the ball into the cup window with the string
    length as a second-order-cone constraint (reference
    test/examples/ball_in_cup.jl)."""
    from calipso_tpu_torch.models import ball_in_cup as bic

    ts = _build(bic.problem(), device=device)
    rng = np.random.default_rng(0)
    ts.initialize_actions(
        [np.concatenate([1e-3 * rng.normal(size=2), 1e-3 * np.ones(1)]) for _ in range(20)]
    )
    res, wall = _solve(ts)
    states, _ = ts.get_trajectory(res)
    print(f"solved={bool(res.solved)} iters={int(res.iterations)}")
    d = states[-1][4:6] - states[-1][6:8]
    distance = float(np.linalg.norm(d))
    print(f"final ball-cup distance: {distance:.3f} "
          f"(string length {bic.STRING_LENGTH})")
    return _outcome(ts, res, wall, distance=distance)


def quadruped_gait(device="cuda"):
    """11-DOF planar quadruped gait with travel (reference
    examples/contact_implicit/quadruped_gait.jl)."""
    from calipso_tpu_torch.models import quadruped

    ts = _build(quadruped.gait_problem(horizon=11, travel=0.2), device=device)
    res, wall = _solve(ts)
    states, _ = ts.get_trajectory(res)
    travel = float(states[-1][0] - states[0][0])
    print(f"solved={bool(res.solved)} iters={int(res.iterations)} "
          f"travel={travel:.3f} m")
    return _outcome(ts, res, wall, travel=travel)


def quadruped_gait_v2(device="cuda"):
    """Mirrored half-cycle gait with a foot-pinning stance phase
    (reference examples/contact_implicit/quadruped_gait_v2.jl): the
    final state repeats the leg-pair-MIRRORED first state advanced by
    the travel, and feet 1/3 are pinned for the first t_fix stages."""
    from calipso_tpu_torch.models import quadruped

    ts = _build(quadruped.gait_problem_v2(horizon=11, travel=0.2, t_fix=4), device=device)
    res, wall = _solve(ts)
    assert bool(res.solved)
    states, _ = ts.get_trajectory(res)
    q2_first = states[0][11:22]
    q2_last = states[-1][11:22]
    mirr = quadruped.mirror_config(torch.tensor(q2_first)).numpy()
    err = float(np.abs((q2_last - mirr)[1:]).max())
    travel = float(q2_last[0] - q2_first[0])
    print(f"solved={bool(res.solved)} iters={int(res.iterations)} "
          f"travel={travel:.3f} m mirror_periodicity_err={err:.2e}")
    return _outcome(ts, res, wall, travel=travel, mirror_periodicity_err=err)


EXAMPLES = {
    "hopper": hopper_gait,
    "ball": ball_in_cup,
    "quadruped": quadruped_gait,
    "quadruped_v2": quadruped_gait_v2,
}


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    EXAMPLES[args[0] if args else "hopper"]("cpu" if "--cpu" in sys.argv[1:] else "cuda")
