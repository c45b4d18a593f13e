"""The controls on the card, at sizes a test run holds: the program with
TF32 in its matrix products (`matmul_precision="high"`, the precision
below the configurations' "highest") must come out not correct, and the
program's differentiation in TF32 must read a sensitivity gap above the
limit that sound runs stay under. The benchmark's own runs do not run
them; their readings at the cells' own sizes are in PERF.md."""

import pytest
import torch
from bench_helpers import small_cell

from benchlib import cli, judge, system

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name,batch", [("pendulum-t11.b131072", 2048), ("rocket-t31.b8192", 256)])
def test_tf32_program_is_not_correct(card, name, batch):
    cell = small_cell(name, batch)
    out = cli.run_cell(cell, 2**31 + 5, 0.0, False, device=card, overrides={"matmul_precision": "high"})
    assert out["correct"] is False
    assert out["compared"]["failed_share"]["value"] > out["compared"]["failed_share"]["limit"]


def test_tf32_differentiation_reads_above_the_limit(card):
    from calipso_tpu_torch.solver import differentiate

    cell = small_cell("pendulum-t11.b262144.sens", 8192)
    limit = cell.traffic["limits"]["sensitivity"]
    sut = system.System(cell.config, cell.traffic, card)
    theta, guess = system.Scenarios(cell.config, cell.traffic, 2**31 + 6, card).next()
    result = sut.solve(theta, guess)
    st = result.state
    m = st.solved
    reg = tuple(a[m] for a in (st.rho, st.eps_p_used, st.eps_d_used))
    point = {k: getattr(result.solution, k)[m] for k in ("x", "y")}
    ref = cell.reference()
    sound = judge.sensitivity_gap(ref, point, theta[m], reg, result.sensitivity[m])
    opts = sut.bts.options.replace(matmul_precision="high")
    try:
        control = differentiate.sensitivity(sut.bts.fns, sut.bts.layout, opts, st, theta).value
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gap = judge.sensitivity_gap(ref, point, theta[m], reg, control[m])
    assert float(sound.max()) < limit < float(gap.max())


@pytest.mark.parametrize("name", ["pendulum-t11.b131072", "rocket-t31.b8192", "pendulum-t11.b262144.sens"])
def test_sound_program_is_correct_on_the_card(card, name):
    cell = small_cell(name, 1024)
    out = cli.run_cell(cell, 2**31 + 7, 0.0, False, device=card)
    assert out["correct"] is True, out["compared"]
