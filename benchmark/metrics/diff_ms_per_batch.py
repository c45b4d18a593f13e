"""diff_ms_per_batch (differentiation: `solver/differentiate.py`; the
device trace): device time of the operations launched inside the
benchmark's span around the sensitivity computation, in the host-traced
batch. Nothing where the cell does not differentiate."""


def read(r):
    s = r.host.seconds("differentiation.")
    return 1e3 * s if s > 0 else None
