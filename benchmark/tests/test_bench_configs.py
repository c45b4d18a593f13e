"""Each configuration builds at a small B, and its plain reference states
the same problem as the port: the same dimensions, and the same
objective, equality and cone values at random points."""

import json
import os

import pytest
import torch
from bench_helpers import BENCH, ROOT, small_cell

from benchlib import judge, spec, system

CONFIGS = ("pendulum-t11", "rocket-t31")
CELLS = {"pendulum-t11": "pendulum-t11.b131072", "rocket-t31": "rocket-t31.b8192"}


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_states_the_ports_problem(name):
    cell = small_cell(CELLS[name], 2)
    ref = cell.reference()
    cfg = cell.config
    assert judge.dims(ref) == (cfg["num_variables"], cfg["equality_rows"], cfg["cone_rows"])
    sut = system.System(cfg, {**cell.traffic, "differentiate": False}, "cpu", {})
    fns = sut.bts.fns
    g = torch.Generator().manual_seed(3)
    w = torch.randn(5, cfg["num_variables"], generator=g, dtype=torch.float64)
    theta = torch.randn(5, cfg["num_parameters"], generator=g, dtype=torch.float64)
    xs, us = judge.split(ref, w)
    torch.testing.assert_close(ref.objective(xs, us, theta), fns.f(w, theta), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ref.equality(xs, us, theta), fns.g(w, theta), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ref.cone(xs, us, theta), fns.h(w, theta), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_and_solves_at_small_batch(name):
    cell = small_cell(CELLS[name], 2)
    sut = system.System(cell.config, cell.traffic, "cpu")
    theta, guess = system.Scenarios(cell.config, cell.traffic, 5, "cpu").next()
    result = sut.solve(theta, guess)
    assert result.solved.all()
    assert result.variables.dtype == torch.float32 and result.variables.shape == (2, cell.config["num_variables"])


@pytest.mark.parametrize("name", CONFIGS)
def test_base_guess_is_the_models_guess(name):
    """The harness's own straight-line guess is the one the model's
    problem gives the solver (the reference bench's guess)."""
    from calipso_tpu_torch import TrajOptSolver

    cell = small_cell(CELLS[name], 2)
    program = cell.config["program"]
    model = __import__(f"calipso_tpu_torch.models.{program['model']}", fromlist=["x"])
    problem = getattr(model, program["problem"])(**program["arguments"])
    ts = TrajOptSolver(device="cpu", **{k: problem[k] for k in system.TRAJOPT_KEYS if k in problem})
    ts.initialize_states(problem["state_guess"])
    torch.testing.assert_close(system.base_guess(cell.config), torch.as_tensor(ts._guess, dtype=torch.float64))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_matches_its_benchmark_entry(name):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entry = next(c for c in json.load(f)["configs"] if c["name"] == name)
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == name and cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []
    assert os.path.exists(os.path.join(BENCH, "configs", f"{name}.py"))
    assert spec.Cell(CELLS[name]).config_entry["name"] == name
