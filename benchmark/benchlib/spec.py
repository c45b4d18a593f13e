"""What `BENCHMARK.json` names, found by name in the benchmark's folders.

Nothing here knows a particular cell, configuration or metric: a
configuration is `configs/<config>.json` (its sizes and options; the file
`BENCHMARK.json` names) with its plain reference `configs/<config>.py`
beside it, a cell's traffic is `workloads/<workload>.json`, and a
per-layer metric is the reader `metrics/<metric>.py`. Adding one is adding
its files and its entry.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str):
    """Import the Python file at `path` as a module named `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of `workloads` with everything it names: `entry`, the
    configuration's entry `config_entry`, its file `config`, the traffic
    `traffic`, and the metrics this cell reports, `end_to_end` and
    `per_layer` (their entries)."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / BENCH_DIR.name
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)
        entries = {w["name"]: w for w in self.spec["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
        self.name = name
        self.entry = entries[name]
        self.config_entry = next(c for c in self.spec["configs"] if c["name"] == self.entry["config"])
        self.config_path = self.root / self.config_entry["file"]
        with open(self.config_path) as f:
            self.config = json.load(f)
        with open(self.bench_dir / "workloads" / f"{name}.json") as f:
            self.traffic = json.load(f)
        self.end_to_end = [m for m in self.spec["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in self.spec["per_layer"] if self._reports(m)]

    def _reports(self, metric):
        return self.name in metric.get("workloads", [self.name])

    def reference(self):
        """The configuration's plain reference module."""
        path = self.config_path.with_suffix(".py")
        return load_module(path, "bench_reference_" + path.stem.replace("-", "_").replace(".", "_"))

    def reader(self, metric_name: str):
        """The `read(readings)` function of a per-layer metric."""
        path = self.bench_dir / "metrics" / f"{metric_name}.py"
        return load_module(path, "bench_metric_" + metric_name.replace("-", "_").replace(".", "_")).read
