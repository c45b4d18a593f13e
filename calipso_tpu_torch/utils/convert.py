"""Carry options and solver state from the JAX package into the port.

The parity tests hand one iterate to both packages with these, and
`BatchedTrajOptSolver.solve(warm=...)` accepts the Blocks they build. The
inputs are plain numpy arrays (or anything `numpy.asarray` takes, such as
JAX arrays), so this module imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from calipso_tpu_torch.options import Options
from calipso_tpu_torch.solver.kkt import Blocks
from calipso_tpu_torch.solver.solve import State


def options_from_jax(opts) -> Options:
    """A port Options with every field of the reference's Options."""
    ours = {f.name for f in dataclasses.fields(Options)}
    theirs = {f.name for f in dataclasses.fields(opts)}
    if ours != theirs:
        raise ValueError(
            f"Options field sets differ: only in the port {sorted(ours - theirs)}, "
            f"only in the reference {sorted(theirs - ours)}"
        )
    return Options(**{name: getattr(opts, name) for name in ours})


def _tensor(a, device, dtype):
    a = np.array(a)  # a writable copy (JAX hands out read-only buffers)
    if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def blocks_from_numpy(blocks, device="cpu", dtype=torch.float64) -> Blocks:
    """The port's Blocks from any (x, r, s, y, z, t) sequence of arrays."""
    return Blocks(*(_tensor(a, device, dtype) for a in blocks))


def state_from_numpy(state, device="cpu", dtype=torch.float64) -> State:
    """The port's State from a reference State (batched arrays, lane axis
    first); float fields take `dtype`, integer and bool fields keep theirs
    (integers as int32, the port's counter type)."""
    fields = {}
    for name in State._fields:
        value = getattr(state, name)
        if name == "p":
            fields[name] = blocks_from_numpy(value, device, dtype)
            continue
        t = _tensor(value, device, dtype)
        if t.dtype not in (torch.bool,) and not t.is_floating_point():
            t = t.to(torch.int32)
        fields[name] = t
    return State(**fields)
