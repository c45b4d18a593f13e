"""Batched scenario solving (`examples/batched_scenarios.py`): a whole
pendulum swing-up trajopt solve (T=11, n=32, schur) over a batch of
initial states, each the stage-0 parameter of its lane, on one device.

The reference's second half shards the batch over every device when
there is more than one; the port's `mesh=` is not written yet (ROADMAP
Queue 1 item 19), so on a host with several cards that call raises.

Run:  python -m calipso_tpu_torch.examples.batched_scenarios [batch_size] [--cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from calipso_tpu_torch import Options, TrajOptSolver
from calipso_tpu_torch.models import pendulum


def main(batch=256, device="cuda"):
    """Solve `batch` scenarios twice (the second timed) and return
    {"solved", "batch", "iterations" (B,), "states" (B, n), "seconds",
    "solves_per_s", "device_kind", "solver", "result"}."""
    prob = pendulum.swingup_problem(horizon=11, parametric_initial_state=True)
    kw = {
        k: v
        for k, v in prob.items()
        if k not in ("state_guess", "state_initial", "state_goal")
    }
    ts = TrajOptSolver(options=Options(), device=device, **kw)
    xg = np.array([np.pi, 0.0])
    ts.initialize_states([xg * t / 10 for t in range(11)])
    bts = ts.batched()
    on_card = bts.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    rng = np.random.default_rng(0)
    x0s = torch.tensor(0.2 * rng.normal(size=(batch, 2)), dtype=torch.float64)

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

    # sharded over all devices (mesh=: ROADMAP Queue 1 item 19)
    count = torch.cuda.device_count() if on_card else 1
    if count > 1 and batch % count == 0:
        print(f"sharding over {count} devices: mesh= is not ported yet (ROADMAP Queue 1 item 19)")
        bts.solve(parameters=x0s, mesh=[torch.device("cuda", i) for i in range(count)])

    return {
        "solved": solved,
        "batch": batch,
        "iterations": res.state.total_i.cpu().numpy(),
        "states": res.variables.detach().cpu().numpy(),
        "seconds": dt,
        "solves_per_s": batch / dt,
        "device_kind": kind,
        "solver": bts,
        "result": res,
    }


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    main(int(args[0]) if args else 256, "cpu" if "--cpu" in sys.argv[1:] else "cuda")
