"""oracle_ms_per_iter (oracles: `solver/problem.py`,
`trajopt/structured.py`, `models/`; the device trace): device time of the
operations launched inside the benchmark's spans around the problem
functions' calls in the solve loop (not inside differentiation), in the
host-traced batch, over its lockstep iterations."""


def read(r):
    return 1e3 * r.host.seconds("oracle.", outside=("differentiation.",)) / r.batches[1].lockstep_iters
