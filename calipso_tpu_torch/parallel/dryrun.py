"""The multi-rank dry run: the twin of `__graft_entry__.dryrun_multichip(n)`
over n torch.distributed ranks (`parallel/mesh.py`).

Each part runs on every rank of a batch-axis `Mesh` and returns the same
numbers on every rank:
  1. (`batch_part`) the pendulum at T=5 with `differentiate=True`, two
     scenarios a rank (B = 2n initial states, `default_rng(0)`, from a zero
     guess); the scenario-mean loss |z*|^2 and its gradient through the
     sensitivities, summed over the ranks (the reference's `psum`) -- the
     auto-tuning pattern;
  2. (`spike_part`) one pendulum solve with a horizon of 2n stages on
     `linear_solver="spike"` over the same ranks (a "horizon" axis),
     against the same solve on riccati: the same iterations;
  3. (`contact_part`) the quadruped stance MPC problem at horizon 8 (stage
     blocks d = 54), one drop scenario a rank (heights from
     `default_rng(1)`), tolerances 1e-3, every lane solved.
The reference solves part 3 twice (its first solve compiles); here the
first solve is the only one: nothing is compiled.

Run:  python -m calipso_tpu_torch.parallel.dryrun [ranks] [--cpu]
(ranks share the card, or run on the CPU).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from calipso_tpu_torch import Options, TrajOptSolver
from calipso_tpu_torch.parallel import mesh as pm

HORIZON_BATCH = 5
NX = 2
HORIZON_CONTACT = 8
TOL_CONTACT = 1e-3


def _pend_c(x, u):
    return torch.stack([x[1], u[0] / 0.25 - 9.81 * torch.sin(x[0]) / 0.5 - 0.1 * x[1] / 0.25])


def _pend_d(y, x, u):
    return y - (x + 0.05 * _pend_c(0.5 * (x + y), u))


def _pendulum(horizon, equality, options, device, parameters=None):
    return TrajOptSolver(
        [lambda x, u, w: 0.1 * x @ x + 0.1 * u @ u] * (horizon - 1) + [lambda x, u, w: 10.0 * x @ x],
        [_pend_d] * (horizon - 1),
        [NX] * horizon,
        [1] * (horizon - 1),
        equality=[equality] + [None] * (horizon - 1),
        parameters=parameters,
        options=options,
        device=device,
    )


def batch_solver(device):
    """Part 1's problem: the initial state is the stage-0 parameter."""
    return _pendulum(
        HORIZON_BATCH, lambda x, u, w: x - w, Options(differentiate=True), device,
        parameters=[np.zeros(NX)] + [np.zeros(0)] * (HORIZON_BATCH - 1),
    )


def batch_scenarios(B):
    """Part 1's B initial states (B, 2)."""
    return 0.2 * np.random.default_rng(0).normal(size=(B, NX))


def horizon_solver(horizon, options, device):
    """Part 2's problem: from x0 = (0.3, 0) towards rest, a zero guess."""
    ts = _pendulum(horizon, lambda x, u, w: torch.stack([x[0] - 0.3, x[1]]), options, device)
    ts.initialize_states([np.zeros(NX)] * horizon)
    return ts


def contact_solver(device):
    """Part 3's problem (the quadruped MPC problem at horizon 8)."""
    from calipso_tpu_torch.models import quadruped

    prob = quadruped.mpc_problem(horizon=HORIZON_CONTACT)
    kw = {k: v for k, v in prob.items() if k not in ("state_guess", "state_initial", "state_goal", "action_guess")}
    tol = TOL_CONTACT
    opts = Options(
        residual_tolerance=tol, optimality_tolerance=tol, slack_tolerance=tol,
        equality_tolerance=tol, complementarity_tolerance=tol, max_iterative_refinement=2,
    )
    ts = TrajOptSolver(options=opts, device=device, **kw)
    ts.initialize_states([np.asarray(s) for s in prob["state_guess"]])
    ts.initialize_actions([np.asarray(a) for a in prob["action_guess"]])
    return ts


def contact_scenarios(n):
    """Part 3's n drop states (n, 22): the nominal stance raised by U[0.02,
    0.10] (`default_rng(1)`)."""
    from calipso_tpu_torch.models import quadruped

    q0 = quadruped._nominal_q()
    x0 = np.tile(np.concatenate([q0, q0])[None], (n, 1))
    h = np.random.default_rng(1).uniform(0.02, 0.10, size=(n,))
    x0[:, 1] += h
    x0[:, quadruped.NQ + 1] += h
    return x0


def psum(mesh, t):
    """The sum of `t` over the ranks, added in rank order on every rank, so
    that every rank holds the same bits."""
    return mesh.all_gather(t).sum(dim=0)


def _rows(mesh, a):
    b = a.shape[0] // mesh.size
    return a[mesh.rank * b : (mesh.rank + 1) * b]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def batch_part(mesh, dtype=torch.float64, per_rank=2):
    """Part 1, `per_rank` scenarios a rank: {"loss", "grad" (p,),
    "batch_solved", "batch"}."""
    bts = batch_solver(mesh.device).batched()
    x0 = torch.tensor(batch_scenarios(per_rank * mesh.size), dtype=dtype, device=mesh.device)
    nvar = bts.fns.dims.variables
    res = bts.solve(parameters=_rows(mesh, x0), guess=torch.zeros(nvar, dtype=dtype))
    xs = res.variables
    dxdth = res.sensitivity[:, :nvar, :]
    B = x0.shape[0]
    loss = psum(mesh, (xs**2).sum()) / B
    grad = psum(mesh, torch.einsum("bi,bip->p", 2.0 * xs, dxdth)) / B
    solved = psum(mesh, res.solved.sum())
    return {"loss": loss, "grad": grad, "batch_solved": int(solved), "batch": B}


def spike_part(mesh, dtype=torch.float64):
    """Part 2: {"spike_solved", "spike_iters", "riccati_iters", "spike_x",
    "riccati_x"} for a horizon of 2 stages a rank."""
    horizon = 2 * mesh.size
    horizon_mesh = pm.Mesh("horizon", mesh.device, mesh.group)
    out = {}
    for name, opts in (
        ("spike", Options(linear_solver="spike", spike_mesh=horizon_mesh)),
        ("riccati", Options(linear_solver="riccati")),
    ):
        ts = horizon_solver(horizon, opts, mesh.device)
        r = ts.solver.solve(torch.as_tensor(ts._guess, dtype=dtype))
        out[f"{name}_solved"] = bool(r.solved)
        out[f"{name}_iters"] = int(r.iterations)
        out[f"{name}_x"] = r.variables
    return out


def contact_part(mesh, dtype=torch.float64):
    """Part 3: {"contact_solved", "contact_lanes", "contact_iters",
    "contact_s"} (contact_s: this rank's wall for its lane)."""
    ts = contact_solver(mesh.device)
    x0 = torch.tensor(contact_scenarios(mesh.size), dtype=dtype, device=mesh.device)
    guess = torch.as_tensor(ts._guess, dtype=dtype)
    _sync(mesh.device)
    t0 = time.time()
    res = ts.batched().solve(parameters=_rows(mesh, x0), guess=guess)
    _sync(mesh.device)
    wall = time.time() - t0
    return {
        "contact_solved": int(psum(mesh, res.solved.sum())),
        "contact_lanes": mesh.size,
        "contact_iters": int(psum(mesh, res.iterations.sum())),
        "contact_s": wall,
    }


PARTS = (batch_part, spike_part, contact_part)


def check(out):
    """Raise where the reference's dry run asserts, on the parts' merged
    numbers."""
    if not (torch.isfinite(out["loss"]) and torch.isfinite(out["grad"]).all()):
        raise RuntimeError(f"dryrun: loss {out['loss']} or gradient {out['grad']} not finite")
    if out["batch_solved"] != out["batch"]:
        raise RuntimeError(f"dryrun: {out['batch_solved']}/{out['batch']} batch solves converged")
    if not out["spike_solved"]:
        raise RuntimeError("dryrun: the horizon-sharded solve failed")
    if out["spike_iters"] != out["riccati_iters"]:
        raise RuntimeError(f"dryrun: spike took {out['spike_iters']} iterations, riccati {out['riccati_iters']}")
    if out["contact_solved"] != out["contact_lanes"]:
        raise RuntimeError(f"dryrun: {out['contact_solved']}/{out['contact_lanes']} contact lanes converged")


def dryrun(mesh, dtype=torch.float64):
    """The three parts on this rank of `mesh`, checked (`check`): their
    numbers in one dict."""
    out = {}
    for part in PARTS:
        out.update(part(mesh, dtype))
    check(out)
    return out


def summary(n, out):
    """The reference's dry-run line for one rank's result."""
    return (
        f"dryrun_multichip({n}): loss={float(out['loss']):.6f} grad_norm={float(out['grad'].norm()):.6f} "
        f"batch_solved={out['batch_solved']}/{out['batch']} spike_iters={out['spike_iters']} "
        f"contact_d54_solved={out['contact_solved']}/{out['contact_lanes']} "
        f"contact_iters={out['contact_iters']} contact_solve_s={out['contact_s']:.1f}"
    )


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    ranks = int(args[0]) if args else 2
    results = pm.launch(dryrun, ranks, axis="batch", device="cpu" if "--cpu" in sys.argv[1:] else "cuda:0")
    print(summary(ranks, results[0]))
