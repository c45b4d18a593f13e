"""kernels_per_iter (dispatch; the device trace): the device operations
(kernels, copies and sets) the device-only traced batch ran, over its
lockstep iterations. The host launches each, so it sets the host's
dispatch work a step."""


def read(r):
    return r.device.ops / r.batches[0].lockstep_iters
