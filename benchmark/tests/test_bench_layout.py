"""What the harness and the reference load, and a cell, a configuration
and a metric added from new files alone."""

import json
import os
import shutil
import subprocess
import sys

from bench_helpers import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "calipso_tpu"}


def _top_level_modules(code, cwd=ROOT):
    """The top-level names of the modules loaded by `code`, run in a fresh
    interpreter."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=cwd, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.pathsep.join([BENCH, ROOT])},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_port():
    code = (
        "from benchlib import judge, spec\n"
        "for c in ('pendulum-t11', 'rocket-t31'):\n"
        "    ref = spec.load_module(spec.BENCH_DIR / 'configs' / (c + '.py'), 'r')\n"
        "    judge.dims(ref)\n"
    )
    loaded = _top_level_modules(code)
    assert not loaded & FORBIDDEN
    assert "calipso_tpu_torch" not in loaded


def test_harness_run_loads_no_jax():
    """A whole CPU run of a cell (the harness, the port, the readers and
    the judge) leaves no module named jax, jaxlib, flax or calipso_tpu
    (compared whole: calipso_tpu_torch is the port)."""
    code = (
        "from benchlib import cli, spec\n"
        "cell = spec.Cell('pendulum-t11.b131072')\n"
        "cell.traffic['batch'] = 2\n"
        "cli.run_cell(cell, 3, 0.1, False, device='cpu', log=lambda s: None)\n"
        "assert not cli.forbidden_modules()\n"
    )
    loaded = _top_level_modules(code)
    assert not loaded & FORBIDDEN
    assert "calipso_tpu_torch" in loaded


def test_new_cell_config_and_metric_from_new_files_alone(tmp_path):
    """Copy the benchmark, add a configuration (the pendulum at horizon 6),
    a cell on it and a per-layer metric as new files and entries, and run
    the new cell from the copy: nothing of the harness is edited."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    configs = tmp_path / "benchmark" / "configs"
    cfg = json.loads((configs / "pendulum-t11.json").read_text())
    cfg.update(name="pendulum-t6", horizon=6, num_variables=17, equality_rows=14)
    cfg["program"]["arguments"]["horizon"] = 6
    (configs / "pendulum-t6.json").write_text(json.dumps(cfg))
    (configs / "pendulum-t6.py").write_text((configs / "pendulum-t11.py").read_text().replace(" = 11, 2, 1, 2", " = 6, 2, 1, 2"))
    (tmp_path / "benchmark" / "workloads" / "pendulum-t6.b8.json").write_text(
        json.dumps({"batch": 8, "parameters": {"scale": 0.2}, "limits": {"kkt": 3.0, "failed_share": 0.5}})
    )
    (tmp_path / "benchmark" / "metrics" / "lanes_per_batch.py").write_text(
        "def read(r):\n    return sum(b.lanes for b in r.batches) / len(r.batches)\n"
    )
    spec["configs"].append({**spec["configs"][0], "name": "pendulum-t6", "file": "benchmark/configs/pendulum-t6.json"})
    spec["workloads"].append({"name": "pendulum-t6.b8", "config": "pendulum-t6", "traffic": "b8", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "lanes_per_batch", "unit": "count", "better": "higher", "bound": 0.01,
                               "source": "host_clock", "workloads": ["pendulum-t6.b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(tmp_path / 'benchmark')!r})\n"
        "from benchlib import cli, spec\n"
        "cell = spec.Cell('pendulum-t6.b8')\n"
        "out = cli.run_cell(cell, 9, 0.1, False, device='cpu', log=lambda s: None)\n"
        "print(out['metrics']['lanes_per_batch']['value'], out['correct'], out['compared']['kkt']['value'])\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    lanes, correct, kkt = out.stdout.split()
    assert float(lanes) == 8.0 and correct == "True" and float(kkt) < 1.0
