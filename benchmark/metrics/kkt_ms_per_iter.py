"""kkt_ms_per_iter (KKT: `solver/kkt.py`; the device trace): device time
of the operations launched inside the benchmark's spans around
`kkt.factorize`, `kkt.solve_with` and `kkt.matvec` in the solve loop (not
inside differentiation), in the host-traced batch, over its lockstep
iterations. It holds the kernels the routes choose."""


def read(r):
    return 1e3 * r.host.seconds("kkt.", outside=("differentiation.",)) / r.batches[1].lockstep_iters
