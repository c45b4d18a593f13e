"""Runtime-capability probes (the counterpart of
`calipso_tpu/utils/platform.py`).

The reference probes whether its backend runs host callbacks inside a
jitted program, which its in-jit telemetry and `Solver.callbacks` need.
The port runs its solve loop eagerly in Python: its callbacks and verbose
rows are plain Python calls between device operations, on every device,
so the probe has nothing to ask."""


def host_callbacks_supported() -> bool:
    """True: the port's callbacks are plain Python calls in an eager loop."""
    return True
