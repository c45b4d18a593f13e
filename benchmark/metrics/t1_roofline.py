"""t1_roofline (kernels: `ops/cuda_riccati.py`, `csrc/riccati_t1.cu`; the
device trace): the least time of every `factor_t1` and `solve_t1` launch
of the device-only traced batch (`benchlib/roofline.py`, at each launch's
own shape) over the device time of their kernels. Nothing where they do
not run."""

from benchlib import roofline


def read(r):
    return roofline.share(r.calls, r.device, ("factor_t1", "solve_t1"))
