"""The JAX package's seven example scripts (`examples/*.py`), ported.

Each module builds its script's problem with the script's options, guess
and seeds, solves it through the port's public entry points, checks the
script's assertions and returns the outcomes the script prints as a dict
(with the solver and its result under "solver" and "result"). Every
example solves on the card unless given `device="cpu"`, in float64 (the
JAX scripts run in float64 wherever the device is not a TPU, with their
non-TPU tolerances). Run one with

    python -m calipso_tpu_torch.examples.nonconvex
    python -m calipso_tpu_torch.examples.contact_implicit quadruped_v2

The modules are `nonconvex`, `batched_scenarios`, `rocket_landing`,
`contact_implicit`, `drifting`, `mpc_autotuning` and
`autotuning_acrobot`.
"""
