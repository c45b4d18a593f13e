"""Profiling helpers (the counterpart of `calipso_tpu/utils/profiling.py`):
a `torch.profiler` trace in place of the reference's `jax.profiler` one,
and the per-iteration diagnostics the solve state already carries as
plain numbers."""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the host and, where there is a card, the device, and write
    a Chrome trace (chrome://tracing, Perfetto) into `log_dir`:

        with profiling.trace("build/trace") as prof:
            solver.solve(x0)
        print(prof.key_averages().table())
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def _at(v, lane):
    return v if v.dim() == 0 else v[lane]


def iteration_stats(state, lane=0):
    """Summarize a SolveResult state's diagnostics as plain floats: a
    single solve's state, or lane `lane` of a batch's."""
    at = lambda v: _at(v, lane)
    return {
        "solved": bool(at(state.solved)),
        "failed": bool(at(state.failed)),
        "outer_iterations": int(at(state.outer_i)),
        "total_iterations": int(at(state.total_i)),
        "residual_violation": float(at(state.residual_violation)),
        "optimality_violation": float(at(state.optimality_violation)),
        "equality_violation": float(at(state.equality_violation)),
        "complementarity_violation": float(at(state.cone_product_violation)),
        "step_size": float(at(state.step_size)),
        "lu_fallbacks": int(at(state.num_fallbacks)),
    }


def batch_stats(state):
    """Summarize a batched SolveResult state (leading lane axis): per-lane
    convergence masks plus iteration-load statistics. The `lockstep_waste`
    fraction is the share of lane-iterations spent as masked no-ops while
    the slowest lane finished -- the knob batch-size tuning trades against
    the card's occupancy."""
    iters = state.total_i.detach().cpu().numpy()
    solved = state.solved.detach().cpu().numpy()
    mx = int(iters.max(initial=0))
    return {
        "batch": int(iters.shape[0]),
        "solved": int(solved.sum()),
        "failed": int(state.failed.detach().cpu().numpy().sum()),
        "iterations_mean": float(iters.mean()),
        "iterations_max": mx,
        "lockstep_waste": float(1.0 - iters.mean() / mx) if mx else 0.0,
    }
