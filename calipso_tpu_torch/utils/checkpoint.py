"""Checkpoint / resume for solver state (the counterpart of
`calipso_tpu/utils/checkpoint.py`).

A primal-dual point (x, r, s, y, z, t) goes to an .npz file under the
reference's field names, so a point saved by either package loads in the
other. The arrays keep their shapes: a single solve's point (from
`Solver.solve`) has none of the lane axis, a batch's keeps it. `load_point`
feeds `Solver.solve(warm=...)` and `BatchedTrajOptSolver.solve(warm=...)`
for warm-started MPC loops or a restart after preemption.
"""

from __future__ import annotations

import numpy as np
import torch

from calipso_tpu_torch.solver.api import resolve_device
from calipso_tpu_torch.solver.kkt import Blocks

_FIELDS = ("x", "r", "s", "y", "z", "t")


def _numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_point(path: str, point: Blocks) -> None:
    """Persist a primal-dual point (x, r, s, y, z, t) to an .npz file."""
    np.savez(path, **{k: _numpy(v) for k, v in zip(_FIELDS, point)})


def load_point(path: str, device="cuda", dtype=None) -> Blocks:
    """Load a point saved with save_point (by either package) onto
    `device` (the card unless asked otherwise), in `dtype` (the file's
    when None)."""
    device = resolve_device(device)
    data = np.load(path)
    return Blocks(*(torch.as_tensor(np.array(data[k]), dtype=dtype, device=device) for k in _FIELDS))
