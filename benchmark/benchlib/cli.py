"""One run of one cell: set-up, the measured window (or the traced
batches), the judge, and the result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A closed loop with one client: batches of the cell's B lanes back to
back, each with fresh scenarios from the seed. The window opens after a
cold batch at the cell's own B (set-up) and ends with the first batch
that finishes after `--seconds`, so it holds only whole batches and its
time is all of theirs. With `--trace 1` the window is two traced batches
instead (see `trace.py`), and the result carries the per-layer metrics.
Every lane's answer of every batch is judged in float64 once the window
has closed (`judge.py`).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "calipso_tpu")
JUDGE_BLOCK = 65536  # lanes the float64 judge takes at a time
CACHE_VARS = ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH", "TORCHINDUCTOR_CACHE_DIR")


def process_age_s():
    """Seconds since this process started (Linux's /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: `calipso_tpu_torch` is not `calipso_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Batch:
    """One solved batch: its host-clock wall, lanes, solved lanes, the most
    iterations of a lane (the lockstep iterations), its host syncs, and
    its answers, kept on the host for the judge."""

    def __init__(self, result, theta, wall, host_syncs, keep_sensitivity):
        st = result.state
        self.wall = wall
        self.lanes = int(theta.shape[0])
        self.solved_mask = st.solved.cpu()
        self.solved = int(self.solved_mask.sum())
        self.lockstep_iters = int(st.total_i.max())
        # lane-steps of the solve's nested loops: inertia-ladder
        # refactorizations, refinement trips, line-search chunks
        self.nested = tuple(int(c.sum()) for c in (st.num_ladder, st.num_refine, st.num_ls_chunks))
        self.host_syncs = host_syncs
        p = result.solution
        self.answer = {k: getattr(p, k).cpu() for k in ("x", "s", "y", "z", "t")}
        self.theta = theta.cpu()
        self.sensitivity = None
        if keep_sensitivity:
            self.sensitivity = result.sensitivity.cpu()
            self.regularization = tuple(a.cpu() for a in (st.rho, st.eps_p_used, st.eps_d_used))


class Readings:
    """What a metric's reader reads: the window's `batches`, `window_s`
    and `setup_s`; in a traced run also the device-only trace's `device`
    summary (`trace.DeviceSummary`) with its kernel-wrapper `calls`, and
    the host-traced batch's `host` attribution (`trace.HostAttribution`),
    the traced batches being `batches[0]` (device only) and `batches[1]`
    (with host operations)."""

    def __init__(self, batches, window_s, setup_s, device=None, calls=None, host=None):
        self.batches, self.window_s, self.setup_s = batches, window_s, setup_s
        self.device, self.calls, self.host = device, calls, host


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: no answer"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_cell(cell, seed, seconds, trace, device="cuda", overrides=None, log=None):
    """Set up, measure and judge one run of `cell` (a `spec.Cell`) on
    `device`; returns the result as a dictionary (`result_line` makes the
    last line of it). `overrides` replaces options of the configuration
    (the control's precision)."""
    import torch

    from benchlib import judge, system, trace as tr

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    config, traffic = cell.config, cell.traffic
    sut = system.System(config, traffic, device, overrides)
    scenarios = system.Scenarios(config, traffic, seed, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    def batch():
        theta, guess = scenarios.next()
        sync()
        t0 = time.perf_counter()
        result = sut.solve(theta, guess)
        sync()
        wall = time.perf_counter() - t0
        return Batch(result, theta, wall, sut.host_syncs, sut.differentiate)

    cold = batch()
    log(f"cold batch (set-up): {cold.wall:.4f} s, {cold.solved}/{cold.lanes} solved, {cold.lockstep_iters} lockstep iterations")
    del cold
    setup_s = process_age_s()
    batches, traced = [], {}
    t_open = time.perf_counter()
    if trace:
        calls = []
        with system.instrument(sut, calls=calls):
            a, events_a = tr.profile(batch, with_host=False)
        device_summary = tr.DeviceSummary(events_a, a.wall)
        del events_a
        with system.instrument(sut, spans=True):
            b, events_b = tr.profile(batch, with_host=True)
        host = tr.HostAttribution(events_b)
        del events_b
        traced = {"device": device_summary, "calls": calls, "host": host}
        log(
            f"traced batches: device-only {a.wall:.4f} s ({device_summary.ops} device operations, busy "
            f"{device_summary.busy_s:.4f} s), with host operations {b.wall:.4f} s; launches linked to their host call "
            f"{host.linked}, not linked {host.unlinked}"
        )
        batches = [a, b]
    else:
        while True:
            batches.append(batch())
            if time.perf_counter() - t_open >= seconds:
                break
    window_s = time.perf_counter() - t_open
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del sut
    if on_card:
        torch.cuda.empty_cache()

    lanes = sum(b.lanes for b in batches)
    solved = sum(b.solved for b in batches)
    log(
        f"window {window_s:.4f} s: {len(batches)} batches, walls {[round(b.wall, 4) for b in batches]}, "
        f"solved {solved}/{lanes}, lockstep iterations {[b.lockstep_iters for b in batches]}, "
        f"host syncs {[b.host_syncs for b in batches]}, ladder / refinement / line-search lane-steps "
        f"{[b.nested for b in batches]}"
    )
    readings = Readings(batches, window_s, setup_s, **traced)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cell.reader(m["name"])(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the judge: every lane of every batch, in float64, after the window
    ref = cell.reference()
    tol = {k: config["options"][k] for k in (
        "residual_tolerance", "equality_tolerance", "complementarity_tolerance", "slack_tolerance")}
    t_judge = time.perf_counter()
    worst, worst_at, sens, sens_at = 0.0, None, 0.0, None
    for i, b in enumerate(batches):
        mask = b.solved_mask
        if not bool(mask.any()):
            continue
        point = {k: v[mask].to(device) for k, v in b.answer.items()}
        theta = b.theta[mask].to(device)
        r = judge.judge(ref, tol, point, theta, block=JUDGE_BLOCK)
        k = int(torch.argmax(r["worst"]))
        if float(r["worst"][k]) > worst or worst_at is None:
            worst = float(r["worst"][k])
            worst_at = (i, {name: float(v[k]) for name, v in r.items()})
        if b.sensitivity is not None:
            gap = judge.sensitivity_gap(
                ref, point, theta, tuple(a[mask].to(device) for a in b.regularization), b.sensitivity[mask].to(device),
                block=JUDGE_BLOCK,
            )
            k = int(torch.argmax(gap))
            if float(gap[k]) > sens or sens_at is None:
                sens, sens_at = float(gap[k]), (i, float(torch.median(gap)))
    limits = traffic["limits"]
    failed_share = (lanes - solved) / lanes
    compared = {
        "kkt": {"value": worst if solved else float("inf"), "limit": limits["kkt"]},
        "failed_share": {"value": failed_share, "limit": limits["failed_share"]},
    }
    if "sensitivity" in limits:
        compared["sensitivity"] = {"value": sens if solved else float("inf"), "limit": limits["sensitivity"]}
        log(f"judge: sensitivity, worst gap {sens!r} (batch, median gap of that batch) {sens_at}")
    log(f"judge ({time.perf_counter() - t_judge:.1f} s): worst solved lane {worst_at}")
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    result = {
        "correct": correct,
        "attempted": lanes,
        "failed": lanes - solved,
        "metrics": metrics,
        "window_s": window_s,
        "memory_peak_bytes": peak,
        "compared": compared,
    }
    if trace:
        result["busy_s"] = readings.device.busy_s
        result["traced_window_s"] = readings.device.wall_s
        result["breakdown"] = {"device_ops": readings.device.top(10), "idle_gaps": readings.host.gaps}
    return result


def result_line(result, kind, chips, trace):
    """The result's last line (a dict) and its judged numbers, each with
    its limit (non-finite numbers as strings)."""
    compared = {k: dict(v) for k, v in result["compared"].items()}
    for c in compared.values():
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])
    device = {"platform": "gpu", "kind": kind, "count": chips, "memory_peak_bytes": result["memory_peak_bytes"]}
    if trace:
        device["busy_s"] = result["busy_s"]
        device["window_s"] = result["traced_window_s"]
    line = {**{k: result[k] for k in ("correct", "attempted", "failed", "metrics")}, "device": device}
    if trace:
        line["breakdown"] = result["breakdown"]
    line["compared"] = compared
    return line, compared


def main(argv=None):
    t_main = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchlib import spec

    cell = spec.Cell(args.workload)
    for var in CACHE_VARS:
        os.environ[var] = str(spec.ROOT / "build" / "benchmark-cache" / var.lower())
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"no result: the cell needs {chips} CUDA device(s), this machine has {have}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"no result: the process loaded {found}", file=sys.stderr)
        return 3
    line, compared = result_line(result, torch.cuda.get_device_name(0), chips, bool(args.trace))
    print(f"run: {time.perf_counter() - t_main:.1f} s in main, window {result['window_s']:.4f} s", file=sys.stderr)
    for name, c in compared.items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0
