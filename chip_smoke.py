#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (each fails loudly; none catches its own failure):
  1. build the CUDA kernels from calipso_tpu_torch/csrc with nvcc (sm_90a);
  2. hold each kernel against its plain PyTorch version on the card at the
     flagship shape B=8192, n=32, in float32 and float64, with 8 lanes that
     are not positive definite (NaN over their lower triangle on both);
  3. solve the benchmark flagship -- 8192 pendulum swing-up trajopt
     problems, T=11, n=32, 24 equality rows, initial state as the stage-0
     parameter, every tolerance 1e-4 -- through
     TrajOptSolver(...).batched().solve(parameters=x0s) on the card in
     float32, with the kernel launch counters set to 0 just before;
  4. require both kernels to have launched in that run;
  5. re-solve the first 64 lanes on the CPU in float64 (plain path) and
     compare solved flags and solutions;
  6. time three warm batches, and each kernel against its plain version.

Prints each number with the card's name and power limit, then a JSON line
of the kernels, the `nvidia-smi` name/power line, and last
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
there is no CUDA device or the package is not beside this script.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

B, HORIZON, TOL = 8192, 11, 1e-4
NON_PD = (5, 77, 1000, 2047, 4096, 5555, 8000, 8191)
RTOL = {"float32": 1e-4, "float64": 1e-12}  # kernel vs plain, relative
CPU_LANES, CPU_ATOL = 64, 1e-3
MIN_SOLVED = 8184
WARM_REPS = 3


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn() on the card (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flagship(options):
    from calipso_tpu_torch import TrajOptSolver
    from calipso_tpu_torch.models import pendulum

    prob = pendulum.swingup_problem(HORIZON, parametric_initial_state=True)
    ts = TrajOptSolver(
        prob["objective"], prob["dynamics"], prob["num_states"], prob["num_actions"],
        equality=prob["equality"], parameters=prob["parameters"], options=options,
    )
    ts.initialize_states(prob["state_guess"])
    return ts.batched()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from calipso_tpu_torch import Options
    from calipso_tpu_torch.ops import _build, cuda_riccati as cr

    dev = torch.device("cuda")
    card = card_line()
    tag = f"[{card}]"
    print(f"{tag} torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.time()
    lib = _build.build()
    _build.load()
    print(f"{tag} build: {lib} in {time.time() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"{tag} ptxas: {line.strip()}")

    # 2. kernels against their plain versions at the flagship shape
    rng = np.random.default_rng(0)
    n = 32
    D = rng.normal(size=(B, n, n))
    S64 = D @ np.swapaxes(D, 1, 2) + n * np.eye(n)
    S64[list(NON_PD)] *= -1.0
    b64 = rng.normal(size=(B, n))
    errs, times = {}, {}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        S = torch.tensor(S64, dtype=dtype, device=dev)
        b = torch.tensor(b64, dtype=dtype, device=dev)
        L, Lp = cr.factor_t1(S), cr.factor_t1_plain(S)
        x, xp = cr.solve_t1(L, b), cr.solve_t1_plain(Lp, b)
        torch.cuda.synchronize()
        bad = torch.isnan(L).any(-1).any(-1)
        check(
            torch.equal(bad, torch.isnan(Lp).any(-1).any(-1))
            and sorted(torch.nonzero(bad)[:, 0].tolist()) == list(NON_PD),
            f"{name}: NaN lanes differ between kernel and plain",
        )
        lower = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
        check(bool(torch.isnan(L[bad][:, lower]).all()), f"{name}: partial NaN factor")
        ok = ~bad
        for kname, got, want in (("factor_t1", L, Lp), ("solve_t1", x, xp)):
            abs_err = float((got[ok].double() - want[ok].double()).abs().max())
            rel_err = abs_err / float(want[ok].double().abs().max())
            errs[(kname, name)] = abs_err
            print(f"{tag} {kname} {name} B={B} n={n}: max_abs_err {abs_err:.3e} max_rel_err {rel_err:.3e} (limit {RTOL[name]:g})")
            check(rel_err <= RTOL[name], f"{kname} {name}: relative error {rel_err:.3e}")
        if name == "float32":
            times["factor_t1"] = (cuda_ms(lambda: cr.factor_t1(S), 50), cuda_ms(lambda: cr.factor_t1_plain(S), 50))
            times["solve_t1"] = (cuda_ms(lambda: cr.solve_t1(L, b), 50), cuda_ms(lambda: cr.solve_t1_plain(L, b), 50))
    for kname, (ms, plain_ms) in times.items():
        print(f"{tag} {kname} float32 B={B} n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    # 3.-4. the flagship on the card, counting kernel launches
    tol = dict(
        residual_tolerance=TOL, optimality_tolerance=TOL, slack_tolerance=TOL,
        equality_tolerance=TOL, complementarity_tolerance=TOL,
        iterative_refinement_tolerance=1e-6,
    )
    bts = flagship(Options(**tol))
    # the benchmark's scenarios (bench.py: a fresh default_rng(0))
    x0_np = (0.2 * np.random.default_rng(0).normal(size=(B, 2))).astype(np.float32)
    x0s = torch.tensor(x0_np, device=dev)
    for k in cr.LAUNCHES:
        cr.LAUNCHES[k] = 0
    t0 = time.time()
    res = bts.solve(parameters=x0s)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    launches = dict(cr.LAUNCHES)
    syncs = bts.stats["host_syncs"]
    st = res.state
    print(f"{tag} flagship cold batch (first solve, includes one-time set-up): {cold_s:.3f} s")
    print(f"{tag} kernel launches in the flagship run: {launches}; host syncs (loop tests): {syncs}")
    check(all(launches[k] > 0 for k in ("factor_t1", "solve_t1")), f"a kernel never launched: {launches}")

    solved = st.solved.cpu().numpy()
    x = st.p.x
    check(tuple(x.shape) == (B, 32) and x.dtype == torch.float32, f"solution shape {tuple(x.shape)}")
    check(bool(torch.isfinite(x[st.solved]).all()), "non-finite solution in a solved lane")
    failed_lanes = np.nonzero(~solved)[0].tolist()
    total_i = st.total_i.cpu().numpy()
    print(f"{tag} solved {int(solved.sum())}/{B}; failed lanes: {failed_lanes}")
    print(
        f"{tag} iterations: total {int(total_i.sum())}, max (lockstep) {int(total_i.max())}, "
        f"mean {float(total_i.mean()):.3f}; ladder {int(st.num_ladder.sum())}, "
        f"refine {int(st.num_refine.sum())}, line-search chunks {int(st.num_ls_chunks.sum())}"
    )
    check(int(solved.sum()) >= MIN_SOLVED, f"only {int(solved.sum())} of {B} lanes solved")

    # 5. the first lanes again on the CPU in float64 through the plain path
    cpu = flagship(Options(**tol))
    ref = cpu.solve(parameters=torch.tensor(x0_np[:CPU_LANES], dtype=torch.float64))
    cpu_solved = ref.state.solved.numpy()
    check(
        cpu_solved.tolist() == solved[:CPU_LANES].tolist(),
        f"solved flags differ from the CPU float64 re-solve: {np.nonzero(cpu_solved != solved[:CPU_LANES])[0].tolist()}",
    )
    diff = float((x[:CPU_LANES].double().cpu() - ref.state.p.x).abs().max())
    iters_cpu = ref.state.total_i.numpy()
    print(
        f"{tag} CPU float64 re-solve of {CPU_LANES} lanes: max |x_gpu - x_cpu| {diff:.3e} "
        f"(limit {CPU_ATOL:g}); iterations equal in {int((iters_cpu == total_i[:CPU_LANES]).sum())}/{CPU_LANES} lanes"
    )
    check(diff <= CPU_ATOL, f"GPU float32 and CPU float64 solutions differ by {diff:.3e}")

    # 6. warm batches, repeated to show their spread
    for rep in range(WARM_REPS):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        start.record()
        warm = bts.solve(parameters=x0s)
        end.record()
        torch.cuda.synchronize()
        wall = time.time() - t0
        check(torch.equal(warm.state.solved, st.solved), "warm batch solved other lanes")
        print(
            f"{tag} flagship warm batch {rep + 1}/{WARM_REPS} B={B}: "
            f"{start.elapsed_time(end) / 1e3:.4f} s (CUDA events), {wall:.4f} s (host clock), "
            f"{B / wall:.1f} solves/s, host syncs {bts.stats['host_syncs']}"
        )

    source = "calipso_tpu_torch/csrc/riccati_t1.cu"
    replaces = {
        "factor_t1": "calipso_tpu/ops/pallas_riccati.py:633",
        "solve_t1": "calipso_tpu/ops/pallas_riccati.py:661",
    }
    kernels = [
        {
            "name": k, "route": "cuda", "source": source, "replaces": replaces[k],
            "launches": launches[k], "max_abs_err": errs[(k, "float32")],
            "ms": times[k][0], "plain_ms": times[k][1],
        }
        for k in ("factor_t1", "solve_t1")
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
