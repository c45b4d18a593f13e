"""The quadruped drop (`models/quadruped.py:drop_problem`, horizon 8,
drop height 0.1) in both packages on the CPU in float64, held to the
reference test's assertions (`tests/test_contact.py:test_quadruped_drop`,
`heavy` there and here): solved to the contract, and all four feet end
on the ground (signed distance in (-1e-4, 1e-2)). Both solve with the
serial line search (what the reference's "auto" takes on the CPU); the
port takes the reference's iterations, each inner step's merit within
MERIT_RTOL of the reference's (the same float64 arithmetic up to
summation order: 2.4e-10 at most over the 51 steps). The JAX side takes
about 70 s to compile and solve on one CPU core, the port's about 40 s.
"""

import numpy as np
import pytest
import torch

import calipso_tpu
import calipso_tpu_torch
from calipso_tpu.models import quadruped as jquad
from calipso_tpu_torch.models import quadruped as tquad
from calipso_tpu_torch.utils.convert import options_from_jax
from tests.test_solver_nlp import assert_contract

# Tier-1 runs several pytest workers on few CPUs: one torch thread each
torch.set_num_threads(1)

MERIT_RTOL = 1e-8
GUESS_KEYS = ("state_guess", "state_initial", "state_goal", "action_guess")


def _drop(pkg):
    """(TrajOptSolver, result, each inner step's merit) of one package."""
    prob = (jquad if pkg == "jax" else tquad).drop_problem(horizon=8, drop_height=0.1)
    kw = {k: v for k, v in prob.items() if k not in GUESS_KEYS}
    opts = calipso_tpu.Options(line_search_mode="serial")
    if pkg == "jax":
        ts = calipso_tpu.TrajOptSolver(options=opts, **kw)
    else:
        ts = calipso_tpu_torch.TrajOptSolver(options=options_from_jax(opts), device="cpu", **kw)
    ts.initialize_states(prob["state_guess"])
    if "action_guess" in prob:
        ts.initialize_actions(prob["action_guess"])
    merits = []
    ts.solver.callbacks(inner=lambda d: merits.append(float(np.asarray(d["merit"]).reshape(-1)[0])))
    return ts, ts.solve(), np.array(merits)


@pytest.mark.heavy
def test_quadruped_drop_feet_end_on_the_ground():
    _, rj, mj = _drop("jax")
    ts, res, mt = _drop("torch")
    assert_contract(res)
    assert ts.solver.options.linear_solver == "riccati" and ts.solver.fns.stage_structure.dmax == 54
    states, _ = ts.get_trajectory(res)
    phi = tquad.signed_distance(torch.tensor(states[-1][11:22])).numpy()
    assert np.all(phi > -1e-4) and np.all(phi < 1e-2), phi
    assert int(res.iterations) == int(rj.iterations)
    assert mt.shape == mj.shape
    assert float((np.abs(mt - mj) / np.abs(mj)).max()) <= MERIT_RTOL
