"""lanes_roofline (kernels: `ops/cuda_riccati.py`,
`csrc/riccati_lanes.cu`; the device trace): the least time of every
`factor_lanes` and `solve_lanes` launch of the device-only traced batch
(`benchlib/roofline.py`, at each launch's own shape) over the device time
of their kernels. Nothing where they do not run."""

from benchlib import roofline


def read(r):
    return roofline.share(r.calls, r.device, ("factor_lanes", "solve_lanes"))
