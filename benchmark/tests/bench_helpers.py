"""Helpers of the benchmark's own tests."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def small_cell(name, batch):
    """The cell `name` of BENCHMARK.json with its batch cut to `batch`
    lanes (for a CPU run)."""
    from benchlib import spec

    cell = spec.Cell(name)
    cell.traffic["batch"] = batch
    return cell
