"""lockstep_iters (solve loop, `solver/solve.py`; a program counter): the
most iterations of a lane in a batch, `state.total_i.max()`, the most
over the traced batches. Every lane steps until the slowest finishes."""


def read(r):
    return max(b.lockstep_iters for b in r.batches)
