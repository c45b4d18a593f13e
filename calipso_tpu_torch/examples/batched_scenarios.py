"""Batched scenario solving (`examples/batched_scenarios.py`): a whole
pendulum swing-up trajopt solve (T=11, n=32, schur) over a batch of
initial states, each the stage-0 parameter of its lane, on one device,
then, with more than one card (or `--ranks P`), the same batch sharded
over P ranks through `mesh=` (`parallel/batch.py`; rank r on card r mod
the cards, every rank on the CPU with `--cpu`).

Run:  python -m calipso_tpu_torch.examples.batched_scenarios [batch_size] [--ranks P] [--cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from calipso_tpu_torch import Options, TrajOptSolver
from calipso_tpu_torch.models import pendulum
from calipso_tpu_torch.parallel import mesh as pm


def _batched(device):
    prob = pendulum.swingup_problem(horizon=11, parametric_initial_state=True)
    kw = {
        k: v
        for k, v in prob.items()
        if k not in ("state_guess", "state_initial", "state_goal")
    }
    ts = TrajOptSolver(options=Options(), device=device, **kw)
    xg = np.array([np.pi, 0.0])
    ts.initialize_states([xg * t / 10 for t in range(11)])
    return ts.batched()


def _scenarios(batch):
    return torch.tensor(0.2 * np.random.default_rng(0).normal(size=(batch, 2)), dtype=torch.float64)


def _sharded(mesh, batch):
    """One rank of the sharded half: the whole batch's result."""
    return _batched(mesh.device).solve(parameters=_scenarios(batch), mesh=mesh)


def main(batch=256, device="cuda", ranks=None):
    """Solve `batch` scenarios twice (the second timed), then over `ranks`
    ranks (by default one a card; none on the CPU) when the batch splits
    evenly, and return {"solved", "batch", "iterations" (B,), "states" (B,
    n), "seconds", "solves_per_s", "device_kind", "sharded" (the sharded
    solve's {"ranks", "solved", "states"}, or None), "solver",
    "result"}."""
    bts = _batched(device)
    on_card = bts.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    x0s = _scenarios(batch)

    # one device
    res = bts.solve(parameters=x0s)
    sync()
    t0 = time.time()
    res = bts.solve(parameters=x0s)
    sync()
    dt = time.time() - t0
    solved = int(res.state.solved.sum())
    kind = torch.cuda.get_device_name(bts.device) if on_card else "cpu"
    print(f"batch: {solved}/{batch} solved, {batch / dt:.0f} solves/s on {kind}")

    # sharded over the ranks, each rank on its card (or the CPU)
    cards = torch.cuda.device_count() if on_card else 0
    ranks = (cards or 1) if ranks is None else ranks
    sharded = None
    if ranks > 1 and batch % ranks == 0:
        devices = [f"cuda:{r % cards}" for r in range(ranks)] if on_card else "cpu"
        res_sh = pm.launch(_sharded, ranks, batch, axis="batch", device=devices)[0]
        sharded = {"ranks": ranks, "solved": int(res_sh.state.solved.sum()), "states": res_sh.variables.numpy()}
        print(f"sharded over {ranks} ranks: {sharded['solved']}/{batch} solved")

    return {
        "solved": solved,
        "batch": batch,
        "iterations": res.state.total_i.cpu().numpy(),
        "states": res.variables.detach().cpu().numpy(),
        "seconds": dt,
        "solves_per_s": batch / dt,
        "device_kind": kind,
        "sharded": sharded,
        "solver": bts,
        "result": res,
    }


if __name__ == "__main__":
    argv = sys.argv[1:]
    ranks = int(argv[argv.index("--ranks") + 1]) if "--ranks" in argv else None
    args = [a for i, a in enumerate(argv) if a not in ("--cpu", "--ranks") and (i == 0 or argv[i - 1] != "--ranks")]
    main(int(args[0]) if args else 256, "cpu" if "--cpu" in argv else "cuda", ranks)
