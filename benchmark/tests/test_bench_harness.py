"""The harness on the CPU at small sizes: the scenarios from the seed,
the window of whole batches, the metrics over all of its batches, the
frozen bound arithmetic, the result line, and a run whose timed path is
broken coming out not correct."""

import json
import math

import pytest
import torch
from bench_helpers import small_cell

from benchlib import cli, roofline, spec, system

CELLS = ("pendulum-t11.b131072", "rocket-t31.b8192", "pendulum-t11.b262144.sens")


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_scenarios_and_batches_differ(name):
    cell = small_cell(name, 16)
    big = 2**31 + 12345
    a = system.Scenarios(cell.config, cell.traffic, big, "cpu")
    b = system.Scenarios(cell.config, cell.traffic, big, "cpu")
    c = system.Scenarios(cell.config, cell.traffic, big + 1, "cpu")
    first_a, second_a = a.next(), a.next()
    first_b, first_c = b.next(), c.next()
    for x, y in zip(first_a, first_b):
        assert torch.equal(x, y)
    varied = 0 if cell.traffic.get("parameters") else 1  # which input the traffic varies
    assert not torch.equal(first_a[varied], second_a[varied])
    assert not torch.equal(first_a[varied], first_c[varied])
    assert first_a[0].shape == (16, cell.config["num_parameters"])
    assert first_a[1].shape == (16, cell.config["num_variables"])
    assert first_a[varied].dtype == torch.float32


class FakeBatch:
    def __init__(self, wall, lanes, solved):
        self.wall, self.lanes, self.solved = wall, lanes, solved


def test_end_to_end_metrics_take_every_batch():
    cell = spec.Cell("pendulum-t11.b131072")
    walls = [1.0, 1.1, 0.9, 1.2, 5.0, 1.0, 1.05, 0.95, 1.0, 1.1, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0]
    batches = [FakeBatch(w, 100, 90 + i % 3) for i, w in enumerate(walls)]
    r = cli.Readings(batches, sum(walls), 12.5)
    assert cell.reader("solves_per_s")(r) == pytest.approx(sum(b.solved for b in batches) / sum(walls))
    # numpy's default percentile, by hand: position 0.95 * 20 = 19 of the sorted walls
    assert cell.reader("batch_p95_s")(r) == pytest.approx(sorted(walls)[19])
    assert cell.reader("setup_s")(r) == 12.5


def test_window_holds_only_whole_batches():
    cell = small_cell("pendulum-t11.b131072", 4)
    out = cli.run_cell(cell, 77, 1.5, False, device="cpu", log=lambda s: None)
    metrics = out["metrics"]
    assert out["attempted"] % 4 == 0 and out["attempted"] >= 4
    batches = out["attempted"] // 4
    # the window ends with the first batch that finishes after --seconds,
    # and holds the time of all of them
    assert out["window_s"] >= 1.5
    solved = out["attempted"] - out["failed"]
    assert metrics["solves_per_s"]["value"] == pytest.approx(solved / out["window_s"])
    assert metrics["solves_per_s"]["unit"] == "solves/s" and metrics["batch_p95_s"]["unit"] == "s"
    assert batches >= 1 and out["correct"]
    assert set(metrics) == {"solves_per_s", "batch_p95_s", "setup_s"}


def test_rocket_reports_no_batch_tail():
    cell = spec.Cell("rocket-t31.b8192")
    assert [m["name"] for m in cell.end_to_end] == ["solves_per_s", "setup_s"]
    assert "lanes_roofline" in [m["name"] for m in cell.per_layer]
    assert "t1_roofline" not in [m["name"] for m in cell.per_layer]


def test_bound_arithmetic_against_hand_counts():
    # pendulum-t11: factor_t1 on (131072, 32, 32): the lower triangle of S
    # (528 words) read, L (1024) written, 4 bytes a word
    assert roofline.kernel_cost("factor_t1", (131072, 32, 32), "float32")[0] == (528 + 1024) * 4 * 131072
    # solve_t1: L's triangle (528) and b (32) read, x (32) written
    assert roofline.kernel_cost("solve_t1", (131072, 32, 32), "float32")[0] == (528 + 64) * 4 * 131072
    # rocket-t31: factor_lanes on (8192, 31, 9, 9): D's 31 triangles of 45,
    # O's 30 blocks of 81 read; L's 31 and M's 30 blocks of 81 written
    assert roofline.kernel_cost("factor_lanes", (8192, 31, 9, 9), "float32")[0] == (31 * 45 + 30 * 81 + 31 * 81 + 30 * 81) * 4 * 8192
    # solve_lanes: L's triangles, M's blocks, b read, x written
    assert roofline.kernel_cost("solve_lanes", (8192, 31, 9, 9), "float32")[0] == (31 * 45 + 30 * 81 + 2 * 31 * 9) * 4 * 8192
    # all four are bound by bytes at these shapes: 813.7 MB in 242.9 us
    assert roofline.bound_s(*roofline.kernel_cost("factor_t1", (131072, 32, 32), "float32")) == pytest.approx(
        813694976 / 3.35e12
    )
    ops = roofline.kernel_cost("factor_t1", (131072, 32, 32), "float32")[1]
    assert ops == pytest.approx(131072 * 32**3 / 3)


class FakeDevice:
    def __init__(self, seconds, count):
        self._s, self._c = seconds, count

    def seconds(self, parts):
        return self._s, self._c


def test_roofline_share_is_silent_where_the_kernels_do_not_run():
    calls = [("factor_t1", (131072, 32, 32), "float32")] * 3
    assert roofline.share(calls, FakeDevice(0.0, 0), ("factor_t1",)) is None
    least = 3 * 813694976 / 3.35e12
    assert roofline.share(calls, FakeDevice(2 * least, 3), ("factor_t1",)) == pytest.approx(50.0)


def test_result_line_keys():
    cell = small_cell("pendulum-t11.b131072", 2)
    out = cli.run_cell(cell, 5, 0.1, False, device="cpu", log=lambda s: None)
    line, compared = cli.result_line(out, "NVIDIA H100 80GB HBM3", 1, False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["device"]["platform"] == "gpu" and set(compared) == {"kkt", "failed_share"}
    for c in compared.values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(line))
    traced = dict(out, busy_s=0.5, traced_window_s=1.0, breakdown={"device_ops": [], "idle_gaps": []})
    line, _ = cli.result_line(traced, "x", 1, True)
    assert list(line)[-2:] == ["breakdown", "compared"] and {"busy_s", "window_s"} <= set(line["device"])
    bad = dict(out, compared={"kkt": {"value": math.inf, "limit": 3.0}, "failed_share": {"value": 0.0, "limit": 0.01}})
    assert cli.result_line(bad, "x", 1, False)[1]["kkt"]["value"] == "inf"


def _state_unchanged(result, guess):
    st = result.state
    solved = torch.zeros_like(st.solved)
    return result._replace(state=st._replace(solved=solved, p=st.p._replace(x=guess.clone())))


def _half_left_out(result, guess):
    st = result.state
    half = st.solved.shape[0] // 2
    solved, x = st.solved.clone(), st.p.x.clone()
    solved[half:] = False
    x[half:] = guess[half:]
    return result._replace(state=st._replace(solved=solved, p=st.p._replace(x=x)))


def _answer_altered(result, guess):
    st = result.state
    x = st.p.x.clone()
    x[-1, 3] += 1e-2
    return result._replace(state=st._replace(p=st.p._replace(x=x)))


def _sensitivity_altered(result, guess):
    value = result.sensitivity.clone()
    value[-1, 5, 1] *= 1.01
    return result._replace(sensitivity=value)


FAULTS = [(cell, fault) for cell in CELLS for fault in (_state_unchanged, _half_left_out, _answer_altered)]
FAULTS.append(("pendulum-t11.b262144.sens", _sensitivity_altered))


@pytest.mark.parametrize("name,fault", FAULTS)
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    """The whole run but the look for a card, with the solve broken
    underneath, at the committed limits: the run must come out not
    correct. (One chip: no exchange between chips to leave out.)"""
    cell = small_cell(name, 4)
    real = system.System.solve

    def broken(self, theta, guess):
        return fault(real(self, theta, guess), guess)

    monkeypatch.setattr(system.System, "solve", broken)
    out = cli.run_cell(cell, 2**31 + 99, 0.0, False, device="cpu", log=lambda s: None)
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_at_the_committed_limits(name):
    cell = small_cell(name, 4)
    out = cli.run_cell(cell, 2**31 + 99, 0.0, False, device="cpu", log=lambda s: None)
    assert out["correct"] is True, out["compared"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert cli.main(["--workload", "pendulum-t11.b131072", "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
