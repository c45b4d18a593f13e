#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (each fails loudly; none catches its own failure):
  1. build the CUDA kernels from calipso_tpu_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all started together;
  2. hold the T=1 kernels (factor_t1, solve_t1) against their plain PyTorch
     versions on the card at the flagship shape B=8192, n=32, the
     block-tridiagonal kernels (factor_lanes, solve_lanes) at the batched
     rocket's shape (B=1024, T=31, d=9) and the contact class's (B=256,
     T=8, d=54), and (2c) the stream kernels (factor_stream,
     solve_fwd_stream, solve_bwd_stream) at the batched quadruped's shape
     (B=128, T=8, d=54) with K=1 and K=22 right-hand sides and at
     (B=1024, T=31, d=9), in float32 and float64, with 8 lanes that are
     not positive definite (NaN on both paths, from the same stage on);
  3. solve the benchmark flagship -- 8192 pendulum swing-up trajopt
     problems, T=11, n=32, 24 equality rows, initial state as the stage-0
     parameter, every tolerance 1e-4 -- through
     TrajOptSolver(...).batched().solve(parameters=x0s) on the card in
     float32 (the schur backend), with the kernel launch counters set to 0
     just before; require both T=1 kernels to have launched; re-solve the
     first 64 lanes on the CPU in float64; time three warm batches;
  4. solve the bench's batched rocket landing -- 1024 soft landings, T=31,
     n=276, 192 equality rows, 30 three-dimensional second-order cones,
     every tolerance 1e-4, max_iterative_refinement=2, scenarios given as
     guesses perturbed by 0.01 N(0, 1) -- through
     TrajOptSolver(...).batched().solve(guess=...) on the card in float32,
     with linear_solver="auto" resolving to riccati; require factor_lanes
     and solve_lanes to have launched and the T=1 kernels not; re-solve
     the first 16 lanes on the CPU in float64; time three warm batches and
     profile one;
  5. time each kernel at its main-path shape against its plain version
     and, where one PyTorch call computes the same function, that call;
     and the lanes and stream kernels side by side at the quadruped's and
     the rocket's shapes (run right after phase 2);
  6. solve the bench's batched quadruped (bench.py:396-503) -- 128
     contact-implicit stance MPC problems, H=8 stages (n=400, stage
     blocks d=54, 344 equality rows, 412 cone rows), stance heights from
     U[0.02, 0.10] (default_rng(0)) as the stage-0 parameter, every
     tolerance 1e-4, max_iterative_refinement=2 -- on the card in float32
     with "auto" resolving to riccati; require the three stream kernels to
     have launched and the lanes and T=1 kernels not, at least 120 lanes
     solved and no foot of a solved lane below -1e-3; print the iteration
     counts beside the JAX reference's; re-solve the first 4 lanes on the
     CPU in float64; time a cold and 2 warm batches and profile the first
     5 lockstep iterations of a warm one;
  7. solve the quadruped gait (horizon 11, travel 0.2) in float64 with
     default Options on the card -- its equality_general rows ride the
     riccati border, through solve_multi on the stream solve kernels --
     and hold it to tests/golden/quadruped_gait.npz (solved, states within
     1e-2, iterations within +-15%).

Prints each number with the card's name and power limit, then a JSON line
of the kernels, the `nvidia-smi` name/power line, and last
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
there is no CUDA device or the package is not beside this script.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

TOL = 1e-4
RTOL = {"float32": 1e-4, "float64": 1e-12}  # kernel vs plain, relative
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

# flagship: bench.py:88-128
B_FLAG, HORIZON_FLAG = 8192, 11
NON_PD = (5, 77, 1000, 2047, 4096, 5555, 8000, 8191)
CPU_LANES_FLAG, CPU_ATOL_FLAG = 64, 1e-3
MIN_SOLVED_FLAG = B_FLAG - 8

# batched rocket: bench.py:530-596, at B=1024 (one warp per lane: 128
# lanes would leave most of the card's 132 SMs idle)
B_ROCKET, HORIZON_ROCKET = 1024, 31
MIN_SOLVED_ROCKET = B_ROCKET - 8
CPU_LANES_ROCKET = 16
# float32 on the card and float64 on the CPU each stop at the first
# iterate inside the 1e-4 contract, so the two solutions differ by the
# distance between two such iterates, not by rounding: the golden tests
# hold rocket states to 1e-3, and the thrust, which rides the cone
# boundary, is less determined than the states, hence 1e-2 over all
CPU_ATOL_ROCKET = 1e-2
LANES_SHAPES = ((B_ROCKET, HORIZON_ROCKET, 9), (256, 8, 54))
# two warm batches of the flagship and the rocket: the quadruped phases
# take most of the script's time limit
WARM_REPS = 2
TOP_KERNELS = 12

# batched quadruped: bench.py:396-503 (B=128, H=8, d=54)
B_QUAD, HORIZON_QUAD = 128, 8
MIN_SOLVED_QUAD = 120
CPU_LANES_QUAD = 4
# contact problems are multi-modal, and at the 1e-4 contract a stance
# MPC's impact stage and impulses are loosely determined: a float32 and a
# float64 solve of one lane may end on different local solutions (on an
# H100, this phase's float64 re-solves of 4 card lanes ended 0.13-0.24
# away, mostly in the contact impulses). A lane within the golden's 1e-2 passes; a
# lane further off is a branch change (ROADMAP Queue 3) and passes only if
# the card's solution, evaluated in float64 on the CPU, meets the equality
# rows and the cones to BRANCH_TOL (float32 headroom over the contract).
CPU_ATOL_QUAD = 1e-2
BRANCH_TOL = 1e-3
FOOT_DEPTH_LIMIT = 1e-3
JAX_QUAD_ITERATIONS = (52, 3876)  # BENCH_r05.json: lockstep, total (TPU run)
WARM_REPS_QUAD = 2
# a whole warm quadruped batch launches ~2M device kernels, whose trace the
# profiler takes minutes to digest; the profile covers the first
# lockstep iterations of a warm batch
PROFILE_ITERS_QUAD = 5
# (B, T, d, K) of the stream kernels' checks; the first is the main path's
STREAM_SHAPES = ((B_QUAD, HORIZON_QUAD, 54, 1), (B_QUAD, HORIZON_QUAD, 54, 22), (B_ROCKET, HORIZON_ROCKET, 9, 1))
GOLDEN_GAIT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "quadruped_gait.npz")


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


def bound(nbytes, flops):
    """(least milliseconds, what sets it): bytes over the memory rate or
    float32 operations over the peak rate, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (1e3 * t_bytes, "bytes") if t_bytes >= t_ops else (1e3 * t_ops, "operations")


def factor_bound(B, T, d):
    """bound() of a float32 block-tridiagonal factor: D and O read, L and M
    written."""
    dd = d * d
    return bound((2 * T + 2 * (T - 1)) * dd * 4 * B, (1.0 / 3.0 + 1.0 + 2.0) * dd * d * T * B)


def solve_bound(B, T, d, K=1, sweeps=2):
    """bound() of a float32 block-tridiagonal solve of K right-hand sides,
    both sweeps or one: L, M and the right-hand sides read, the result
    written."""
    dd = d * d
    return bound((T * dd + (T - 1) * dd + 2 * T * d * K) * 4 * B, 3 * sweeps * dd * K * T * B)


def tol_options(Options, **kw):
    return Options(
        residual_tolerance=TOL, optimality_tolerance=TOL, slack_tolerance=TOL,
        equality_tolerance=TOL, complementarity_tolerance=TOL,
        iterative_refinement_tolerance=1e-6, **kw,
    )


def flagship(options, device):
    from calipso_tpu_torch import TrajOptSolver
    from calipso_tpu_torch.models import pendulum

    prob = pendulum.swingup_problem(HORIZON_FLAG, parametric_initial_state=True)
    ts = TrajOptSolver(
        prob["objective"], prob["dynamics"], prob["num_states"], prob["num_actions"],
        equality=prob["equality"], parameters=prob["parameters"], options=options,
        device=device,
    )
    ts.initialize_states(prob["state_guess"])
    return ts.batched()


def rocket_solver(options, device):
    from calipso_tpu_torch import TrajOptSolver
    from calipso_tpu_torch.models import rocket

    prob = rocket.landing_problem(horizon=HORIZON_ROCKET)
    kw = {k: v for k, v in prob.items() if k not in ("state_guess", "state_initial", "state_goal")}
    ts = TrajOptSolver(options=options, device=device, **kw)
    ts.initialize_states([np.asarray(s, np.float32) for s in prob["state_guess"]])
    return ts


def zero_launches(cr):
    for k in cr.LAUNCHES:
        cr.LAUNCHES[k] = 0


def report_solve(tag, B, st):
    solved = st.solved.cpu().numpy()
    total_i = st.total_i.cpu().numpy()
    print(f"{tag} solved {int(solved.sum())}/{B}; failed lanes: {np.nonzero(~solved)[0].tolist()}")
    print(
        f"{tag} iterations: total {int(total_i.sum())}, max (lockstep) {int(total_i.max())}, "
        f"mean {float(total_i.mean()):.3f}; ladder {int(st.num_ladder.sum())}, "
        f"refine {int(st.num_refine.sum())}, line-search chunks {int(st.num_ls_chunks.sum())}"
    )
    return solved, total_i


def warm_batches(tag, name, B, bts, solve, st, reps=WARM_REPS):
    """Time `reps` warm batches; returns their summed host-clock wall."""
    import torch

    total = 0.0
    for rep in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        start.record()
        warm = solve()
        end.record()
        torch.cuda.synchronize()
        wall = time.time() - t0
        total += wall
        check(torch.equal(warm.state.solved, st.solved), f"{name} warm batch solved other lanes")
        print(
            f"{tag} {name} warm batch {rep + 1}/{reps} B={B}: "
            f"{start.elapsed_time(end) / 1e3:.4f} s (CUDA events), {wall:.4f} s (host clock), "
            f"{B / wall:.1f} solves/s, host syncs {bts.stats['host_syncs']}"
        )
    return total


def cpu_resolve(tag, name, st, ref, lanes, atol):
    """Compare the first `lanes` lanes of a card solve with their CPU
    float64 re-solve."""
    solved = st.solved.cpu().numpy()[:lanes]
    cpu_solved = ref.state.solved.numpy()
    check(
        cpu_solved.tolist() == solved.tolist(),
        f"{name}: solved flags differ from the CPU float64 re-solve: "
        f"{np.nonzero(cpu_solved != solved)[0].tolist()}",
    )
    diff = float((st.p.x[:lanes].double().cpu() - ref.state.p.x).abs().max())
    same_i = int((ref.state.total_i.numpy() == st.total_i[:lanes].cpu().numpy()).sum())
    print(
        f"{tag} {name} CPU float64 re-solve of {lanes} lanes: max |x_gpu - x_cpu| {diff:.3e} "
        f"(limit {atol:g}); iterations equal in {same_i}/{lanes} lanes"
    )
    check(diff <= atol, f"{name}: GPU float32 and CPU float64 solutions differ by {diff:.3e}")


@contextlib.contextmanager
def layer_timers(targets):
    """Wrap each (owner, attribute) callable in a host-clock timer and
    yield {attribute: [seconds, calls]}. A solve that is bound by its host
    spends a layer's time enqueueing that layer's kernels, so these are
    the layers' shares of the wall; the wrappers cost microseconds a
    call."""
    spent, saved = {}, []
    for owner, attr in targets:
        fn = getattr(owner, attr)
        acc = spent.setdefault(attr, [0.0, 0])

        def timed(*a, _fn=fn, _acc=acc, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                _acc[0] += time.perf_counter() - t0
                _acc[1] += 1

        saved.append((owner, attr, fn))
        setattr(owner, attr, timed)
    try:
        yield spent
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def profile(tag, name, solve, host_ops=True):
    """Device busy share of one warm batch and its top device kernels
    (torch.profiler); without `host_ops` only the device is traced (a
    batch of millions of host operations would swamp the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        solve()
        torch.cuda.synchronize()
        wall = time.time() - t0
    device = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    digest = time.time() - t0 - wall
    device_us = sum(e.self_device_time_total for e in device)
    calls = sum(e.count for e in device)
    print(
        f"{tag} {name} profiled warm batch: wall {wall:.4f} s (host clock, profiler on), "
        f"device time {device_us / 1e3:.3f} ms over {calls} device kernels and copies, "
        f"device busy {100.0 * device_us / 1e6 / wall:.2f}% of the wall, "
        f"host time per device kernel {1e6 * wall / max(calls, 1):.2f} us; "
        f"the profiler took {digest:.1f} s more to digest its trace"
    )
    if not device:
        print(f"{tag} {name} profiler saw no device time (CUDA events above stand)")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:TOP_KERNELS]:
        print(
            f"{tag}   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{100.0 * e.self_device_time_total / device_us:5.1f}%  x{e.count:<6d} {e.key[:110]}"
        )


def check_lanes(tag, cr, dev, B, T, d, errs, times=None):
    """factor_lanes/solve_lanes against their plain versions at (B, T, d)
    in float32 and float64: random SPD block-tridiagonal inputs with 8
    lanes not positive definite from the middle stage on. Into `times`,
    when given, the float32 kernel, plain and bound times."""
    import torch

    D64, O64, b64, bad_stage, bad_lanes = tridiag_inputs(B, T, d, 1)
    b64 = b64[..., 0]
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        D, O, b = (torch.tensor(a, dtype=dtype, device=dev) for a in (D64, O64, b64))
        L, M = cr.factor_lanes(D, O)
        Lp, Mp = cr.factor_lanes_plain(D, O)
        x, xp = cr.solve_lanes(L, M, b), cr.solve_lanes_plain(Lp, Mp, b)
        want = [bad_stage if i in bad_lanes else -1 for i in range(B)]
        check(first_nan(L) == first_nan(Lp) == want, f"factor_lanes {name} {B}x{T}x{d}: first NaN stages differ")
        check(first_nan(M) == first_nan(Mp), f"factor_lanes {name} {B}x{T}x{d}: NaN stages of M differ")
        stage_ok = ~torch.isnan(Lp).flatten(2).any(-1)
        for kname, got, ref, ok in (
            ("factor_lanes", L, Lp, stage_ok), ("factor_lanes M", M, Mp, stage_ok[:, :-1]),
            ("solve_lanes", x, xp, stage_ok.all(-1)),
        ):
            abs_err = float((got[ok].double() - ref[ok].double()).abs().max())
            rel_err = abs_err / float(ref[ok].double().abs().max())
            errs[(kname, name, T)] = abs_err
            print(
                f"{tag} {kname} {name} B={B} T={T} d={d}: max_abs_err {abs_err:.3e} "
                f"max_rel_err {rel_err:.3e} (limit {RTOL[name]:g}); NaN lanes "
                f"{bad_lanes.tolist()} from stage {bad_stage} on, on both paths"
            )
            check(rel_err <= RTOL[name], f"{kname} {name} {B}x{T}x{d}: relative error {rel_err:.3e}")
        if name == "float32" and times is not None:
            times["factor_lanes"] = (
                cuda_ms(lambda: cr.factor_lanes(D, O), 50),
                cuda_ms(lambda: cr.factor_lanes_plain(D, O), 10), None, factor_bound(B, T, d),
            )
            times["solve_lanes"] = (
                cuda_ms(lambda: cr.solve_lanes(L, M, b), 50),
                cuda_ms(lambda: cr.solve_lanes_plain(L, M, b), 10), None, solve_bound(B, T, d),
            )


def tridiag_inputs(B, T, d, K):
    """Random SPD block-tridiagonal (D, O), right-hand sides b (B, T, d, K),
    and 8 lanes whose middle (or 15th) stage is negated."""
    rng = np.random.default_rng(T * 100 + d + 1000 * (K - 1))
    A = rng.normal(size=(B, T, d, d))
    D64 = A @ np.swapaxes(A, -1, -2) + d * np.eye(d)
    O64 = 0.3 * rng.normal(size=(B, T - 1, d, d))
    bad_stage = 15 if T > 15 else min(4, T - 1)
    bad_lanes = np.linspace(0, B - 1, 8).astype(int)
    D64[bad_lanes, bad_stage] *= -1.0
    return D64, O64, rng.normal(size=(B, T, d, K)), bad_stage, bad_lanes


def first_nan(Z):
    """Per lane, the first stage whose block holds a NaN (-1: none)."""
    import torch

    return [
        int(np.argmax(row)) if row.any() else -1
        for row in torch.isnan(Z).flatten(2).any(-1).cpu().numpy()
    ]


def rel_check(tag, kname, name, shape, got, ref, ok, errs, key):
    abs_err = float((got[ok].double() - ref[ok].double()).abs().max())
    rel_err = abs_err / float(ref[ok].double().abs().max())
    errs[key] = abs_err
    print(f"{tag} {kname} {name} {shape}: max_abs_err {abs_err:.3e} max_rel_err {rel_err:.3e} (limit {RTOL[name]:g})")
    check(rel_err <= RTOL[name], f"{kname} {name} {shape}: relative error {rel_err:.3e}")


def check_stream(tag, cr, dev, B, T, d, K, errs, times=None):
    """factor_stream, solve_fwd_stream and solve_bwd_stream against their
    plain versions at (B, T, d) with K right-hand sides, float32 and
    float64; each sweep is given the same inputs on both paths (the plain
    factor, then the plain forward sweep's u). Into `times`, when given,
    the float32 kernel, plain and bound times."""
    import torch

    D64, O64, b64, bad_stage, bad_lanes = tridiag_inputs(B, T, d, K)
    shape = f"B={B} T={T} d={d} K={K}"
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        D, O, b = (torch.tensor(a, dtype=dtype, device=dev) for a in (D64, O64, b64))
        L, M = cr.factor_stream(D, O)
        Lp, Mp = cr.factor_stream_plain(D, O)
        up = cr.solve_fwd_stream_plain(Lp, Mp, b)
        u = cr.solve_fwd_stream(Lp, Mp, b)
        xp = cr.solve_bwd_stream_plain(Lp, Mp, up)
        x = cr.solve_bwd_stream(Lp, Mp, up)
        torch.cuda.synchronize()
        want = [bad_stage if i in bad_lanes else -1 for i in range(B)]
        check(first_nan(L) == first_nan(Lp) == want, f"factor_stream {name} {shape}: first NaN stages differ")
        check(first_nan(M) == first_nan(Mp), f"factor_stream {name} {shape}: NaN stages of M differ")
        stage_ok = ~torch.isnan(Lp).flatten(2).any(-1)
        lanes_ok = stage_ok.all(-1)
        check(bool(torch.isnan(x[~lanes_ok]).all()), f"solve_bwd_stream {name} {shape}: a NaN lane came out finite")
        for kname, got, ref, ok in (
            ("factor_stream", L, Lp, stage_ok), ("factor_stream M", M, Mp, stage_ok[:, :-1]),
            ("solve_fwd_stream", u, up, lanes_ok), ("solve_bwd_stream", x, xp, lanes_ok),
        ):
            rel_check(tag, kname, name, shape, got, ref, ok, errs, (kname, name, T, K))
        print(f"{tag} stream kernels {name} {shape}: NaN lanes {bad_lanes.tolist()} from stage {bad_stage} on, on both paths")
        if name == "float32" and times is not None:
            times["factor_stream"] = (
                cuda_ms(lambda: cr.factor_stream(D, O), 50),
                cuda_ms(lambda: cr.factor_stream_plain(D, O), 10), None, factor_bound(B, T, d),
            )
            times["solve_fwd_stream"] = (
                cuda_ms(lambda: cr.solve_fwd_stream(L, M, b), 50),
                cuda_ms(lambda: cr.solve_fwd_stream_plain(L, M, b), 10), None,
                solve_bound(B, T, d, K, sweeps=1),
            )
            times["solve_bwd_stream"] = (
                cuda_ms(lambda: cr.solve_bwd_stream(L, M, up), 50),
                cuda_ms(lambda: cr.solve_bwd_stream_plain(L, M, up), 10), None,
                solve_bound(B, T, d, K, sweeps=1),
            )


def routes_timed_at(tag, cr, dev, B, T, d):
    """The lanes and the stream kernels timed side by side at (B, T, d),
    float32, one right-hand side (what ops/riccati.route chooses
    between)."""
    import torch

    D64, O64, b64, _, _ = tridiag_inputs(B, T, d, 1)
    D, O, b = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (D64, O64, b64[..., 0]))
    L, M = cr.factor_lanes(D, O)
    bk = b[..., None].contiguous()
    for kname, fn, (bms, by) in (
        ("factor_lanes", lambda: cr.factor_lanes(D, O), factor_bound(B, T, d)),
        ("factor_stream", lambda: cr.factor_stream(D, O), factor_bound(B, T, d)),
        ("solve_lanes", lambda: cr.solve_lanes(L, M, b), solve_bound(B, T, d)),
        ("solve_stream (fwd+bwd)", lambda: cr.solve_stream(L, M, bk), solve_bound(B, T, d)),
    ):
        ms = cuda_ms(fn, 50)
        print(
            f"{tag} {kname} float32 B={B} T={T} d={d}: kernel {ms:.4f} ms, bound {bms * 1e3:.2f} us ({by}), "
            f"{100.0 * bms / ms:.1f}% of the bound"
        )


def contract_in_float64(ts, x, theta):
    """Per lane, max |g(x)| and the least cone margin (head minus the norm
    of the tail, over every cone of h(x)) of points x, evaluated in float64
    by the CPU solver `ts`."""
    import torch

    fns, layout = ts.solver.fns, ts.solver.layout
    th = torch.tensor(theta, dtype=torch.float64)
    g = fns.g(x, th)
    hp = layout.gather(fns.h(x, th))
    margin = hp[..., 0] - hp[..., 1:].norm(dim=-1)
    return g.abs().amax(dim=1).tolist(), margin.amin(dim=1).tolist()


def quadruped_solver(options, device, dtype):
    from calipso_tpu_torch import TrajOptSolver
    from calipso_tpu_torch.models import quadruped

    prob = quadruped.mpc_problem(horizon=HORIZON_QUAD)
    kw = {k: v for k, v in prob.items() if k not in ("state_guess", "state_initial", "action_guess")}
    ts = TrajOptSolver(options=options, device=device, **kw)
    ts.initialize_states([np.asarray(s, dtype) for s in prob["state_guess"]])
    ts.initialize_actions([np.asarray(a, dtype) for a in prob["action_guess"]])
    return ts


def quadruped_scenarios(B):
    """bench.py:428-436: the nominal stance dropped from a per-lane height
    in [0.02, 0.10] (default_rng(0)), as the stage-0 parameter (q1, q2)."""
    from calipso_tpu_torch.models import quadruped

    heights = np.random.default_rng(0).uniform(0.02, 0.10, size=(B,))
    q0 = quadruped._nominal_q()
    x0 = np.tile(np.concatenate([q0, q0])[None], (B, 1))
    x0[:, 1] += heights
    x0[:, quadruped.NQ + 1] += heights
    return x0


def foot_depth(ts, x):
    """Per lane, the lowest signed foot distance over every configuration
    of the trajectory (negative: below the ground)."""
    import torch
    from calipso_tpu_torch.models import quadruped

    nq = quadruped.NQ
    qs = torch.stack([x[:, idx[k * nq : (k + 1) * nq]] for idx in ts._state_indices for k in (0, 1)], dim=1)
    return torch.func.vmap(torch.func.vmap(quadruped.signed_distance))(qs).flatten(1).amin(dim=1)


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
    t_start = time.time()

    def phase(name):
        print(f"{tag} [{time.time() - t_start:.1f} s] phase {name}", flush=True)

    # 1. build
    phase("1: build")
    t0 = time.time()
    libs = _build.build()
    for stem in libs:
        _build.load(stem)
    print(f"{tag} build: {', '.join(str(p) for p in libs.values())} in {time.time() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"{tag} ptxas: {line.strip()}")

    errs, times = {}, {}
    # 2a. T=1 kernels against their plain versions at the flagship shape
    phase("2: kernels against their plain versions")
    rng = np.random.default_rng(0)
    n = 32
    A = rng.normal(size=(B_FLAG, n, n))
    S64 = A @ np.swapaxes(A, 1, 2) + n * np.eye(n)
    S64[list(NON_PD)] *= -1.0
    b64 = rng.normal(size=(B_FLAG, n))
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
            print(f"{tag} {kname} {name} B={B_FLAG} n={n}: max_abs_err {abs_err:.3e} max_rel_err {rel_err:.3e} (limit {RTOL[name]:g})")
            check(rel_err <= RTOL[name], f"{kname} {name}: relative error {rel_err:.3e}")
        if name == "float32":
            Sg, Lg, bg = S[ok].contiguous(), L[ok].contiguous(), b[ok].contiguous()
            times["factor_t1"] = (
                cuda_ms(lambda: cr.factor_t1(S), 50), cuda_ms(lambda: cr.factor_t1_plain(S), 50),
                cuda_ms(lambda: torch.linalg.cholesky_ex(Sg), 50),
                bound(2 * n * n * 4 * B_FLAG, n**3 / 3 * B_FLAG),
            )
            times["solve_t1"] = (
                cuda_ms(lambda: cr.solve_t1(L, b), 50), cuda_ms(lambda: cr.solve_t1_plain(L, b), 50),
                cuda_ms(lambda: torch.cholesky_solve(bg[..., None], Lg), 50),
                bound((n * n + 2 * n) * 4 * B_FLAG, 2 * n * n * B_FLAG),
            )

    # 2b. block-tridiagonal kernels against their plain versions
    for B, T, d in LANES_SHAPES:
        check_lanes(tag, cr, dev, B, T, d, errs, times if (B, T, d) == LANES_SHAPES[0] else None)
    # 2c. the stream kernels against their plain versions
    for B, T, d, K in STREAM_SHAPES:
        check_stream(tag, cr, dev, B, T, d, K, errs, times if (B, T, d, K) == STREAM_SHAPES[0] else None)

    # 5. kernel times at the main-path shapes, and the two block-tridiagonal
    # routes side by side at the quadruped's
    phase("5: kernel times")
    for kname, (ms, plain_ms, lib_ms, (bms, by)) in times.items():
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        print(
            f"{tag} {kname} float32 main-path shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib}, bound {bms * 1e3:.2f} us ({by}), {100.0 * bms / ms:.1f}% of the bound"
        )
    for B, T, d in ((B_QUAD, HORIZON_QUAD, 54), (B_ROCKET, HORIZON_ROCKET, 9)):
        routes_timed_at(tag, cr, dev, B, T, d)

    # 3. the flagship on the card (schur backend), counting kernel launches
    phase("3: flagship")
    bts = flagship(tol_options(Options), "cuda")
    # the benchmark's scenarios (bench.py: a fresh default_rng(0))
    x0_np = (0.2 * np.random.default_rng(0).normal(size=(B_FLAG, 2))).astype(np.float32)
    x0s = torch.tensor(x0_np, device=dev)
    zero_launches(cr)
    t0 = time.time()
    res = bts.solve(parameters=x0s)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    launches = dict(cr.LAUNCHES)
    print(f"{tag} flagship cold batch (first solve, includes one-time set-up): {cold_s:.3f} s")
    print(f"{tag} kernel launches in the flagship run: {launches}; host syncs (loop tests): {bts.stats['host_syncs']}")
    check(all(launches[k] > 0 for k in ("factor_t1", "solve_t1")), f"a kernel never launched: {launches}")
    st = res.state
    x = st.p.x
    check(tuple(x.shape) == (B_FLAG, 32) and x.dtype == torch.float32, f"solution shape {tuple(x.shape)}")
    check(bool(torch.isfinite(x[st.solved]).all()), "non-finite solution in a solved lane")
    solved, _ = report_solve(f"{tag} flagship", B_FLAG, st)
    check(int(solved.sum()) >= MIN_SOLVED_FLAG, f"only {int(solved.sum())} of {B_FLAG} flagship lanes solved")
    ref = flagship(tol_options(Options), "cpu").solve(
        parameters=torch.tensor(x0_np[:CPU_LANES_FLAG], dtype=torch.float64)
    )
    cpu_resolve(tag, "flagship", st, ref, CPU_LANES_FLAG, CPU_ATOL_FLAG)
    warm_batches(tag, "flagship", B_FLAG, bts, lambda: bts.solve(parameters=x0s), st)

    # 4. the batched rocket landing on the card (riccati backend)
    phase("4: rocket")
    ropts = tol_options(Options, max_iterative_refinement=2)
    ts = rocket_solver(ropts, "cuda")
    check(ts.solver.options.linear_solver == "riccati", f"auto resolved to {ts.solver.options.linear_solver}")
    dims = ts.dims
    print(
        f"{tag} rocket: n={dims.variables}, {dims.equality} equality rows, {dims.cone} cone rows, "
        f"linear_solver auto -> {ts.solver.options.linear_solver}"
    )
    g0 = np.asarray(ts._guess, np.float32)
    guess_np = g0[None] + 0.01 * np.random.default_rng(0).normal(size=(B_ROCKET, g0.size)).astype(np.float32)
    guess = torch.tensor(guess_np, device=dev)
    rbts = ts.batched()
    zero_launches(cr)
    t0 = time.time()
    rres = rbts.solve(guess=guess)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    rlaunches = dict(cr.LAUNCHES)
    print(f"{tag} rocket cold batch (first solve, includes one-time set-up): {cold_s:.3f} s")
    print(f"{tag} kernel launches in the rocket run: {rlaunches}; host syncs (loop tests): {rbts.stats['host_syncs']}")
    check(
        rlaunches["factor_lanes"] > 0 and rlaunches["solve_lanes"] > 0,
        f"a block-tridiagonal kernel never launched: {rlaunches}",
    )
    check(rlaunches["factor_t1"] == rlaunches["solve_t1"] == 0, f"a T=1 kernel launched: {rlaunches}")
    rst = rres.state
    rx = rst.p.x
    check(tuple(rx.shape) == (B_ROCKET, dims.variables) and rx.dtype == torch.float32, f"rocket solution {tuple(rx.shape)}")
    check(bool(torch.isfinite(rx[rst.solved]).all()), "non-finite solution in a solved rocket lane")
    rsolved, _ = report_solve(f"{tag} rocket", B_ROCKET, rst)
    check(int(rsolved.sum()) >= MIN_SOLVED_ROCKET, f"only {int(rsolved.sum())} of {B_ROCKET} rocket lanes solved")
    u = rx[rst.solved][:, np.concatenate(ts._action_indices)].reshape(-1, HORIZON_ROCKET - 1, 3)
    cone_gap = float((u[..., :2].norm(dim=-1) - u[..., 2]).max())
    print(f"{tag} rocket thrust cone: max |u_xy| - u_z over solved lanes {cone_gap:.3e}")
    check(cone_gap <= 1e-3, f"rocket thrust leaves its cone by {cone_gap:.3e}")
    ref = rocket_solver(ropts, "cpu").batched().solve(
        guess=torch.tensor(guess_np[:CPU_LANES_ROCKET], dtype=torch.float64)
    )
    cpu_resolve(tag, "rocket", rst, ref, CPU_LANES_ROCKET, CPU_ATOL_ROCKET)
    warm_batches(tag, "rocket", B_ROCKET, rbts, lambda: rbts.solve(guess=guess), rst)
    profile(tag, "rocket", lambda: rbts.solve(guess=guess), host_ops=False)

    # 6. the batched quadruped on the card (riccati backend, stream route)
    phase("6: quadruped")
    qopts = tol_options(Options, max_iterative_refinement=2)
    qts = quadruped_solver(qopts, "cuda", np.float32)
    check(qts.solver.options.linear_solver == "riccati", f"auto resolved to {qts.solver.options.linear_solver}")
    qdims = qts.dims
    print(
        f"{tag} quadruped: n={qdims.variables}, {qdims.equality} equality rows, {qdims.cone} cone rows, "
        f"stage blocks d={qts.solver.fns.stage_structure.dmax}, linear_solver auto -> "
        f"{qts.solver.options.linear_solver}"
    )
    x0q_np = quadruped_scenarios(B_QUAD).astype(np.float32)
    x0q = torch.tensor(x0q_np, device=dev)
    qbts = qts.batched()
    zero_launches(cr)
    t0 = time.time()
    qres = qbts.solve(parameters=x0q)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    qlaunches = dict(cr.LAUNCHES)
    print(f"{tag} quadruped cold batch (first solve, includes one-time set-up): {cold_s:.3f} s")
    print(f"{tag} kernel launches in the quadruped run: {qlaunches}; host syncs (loop tests): {qbts.stats['host_syncs']}")
    stream_kernels = ("factor_stream", "solve_fwd_stream", "solve_bwd_stream")
    check(all(qlaunches[k] > 0 for k in stream_kernels), f"a stream kernel never launched: {qlaunches}")
    check(
        all(qlaunches[k] == 0 for k in ("factor_t1", "solve_t1", "factor_lanes", "solve_lanes")),
        f"a lanes or T=1 kernel launched on the stream route: {qlaunches}",
    )
    qst = qres.state
    qx = qst.p.x
    check(tuple(qx.shape) == (B_QUAD, qdims.variables) and qx.dtype == torch.float32, f"quadruped solution {tuple(qx.shape)}")
    check(bool(torch.isfinite(qx[qst.solved]).all()), "non-finite solution in a solved quadruped lane")
    qsolved, qiters = report_solve(f"{tag} quadruped", B_QUAD, qst)
    print(
        f"{tag} quadruped iterations beside the JAX reference (BENCH_r05.json, a TPU run, counts only): "
        f"lockstep {int(qiters.max())} vs {JAX_QUAD_ITERATIONS[0]}, total {int(qiters.sum())} vs {JAX_QUAD_ITERATIONS[1]}"
    )
    check(int(qsolved.sum()) >= MIN_SOLVED_QUAD, f"only {int(qsolved.sum())} of {B_QUAD} quadruped lanes solved")
    depth = foot_depth(qts, qx)[qst.solved]
    print(f"{tag} quadruped feet: lowest signed distance over solved lanes {float(depth.min()):.3e} (limit -{FOOT_DEPTH_LIMIT:g})")
    check(float(depth.min()) >= -FOOT_DEPTH_LIMIT, f"a foot of a solved lane is {float(depth.min()):.3e} below the ground")
    phase("6: quadruped CPU float64 re-solve")
    qref = quadruped_solver(qopts, "cpu", np.float64).batched().solve(
        parameters=torch.tensor(x0q_np[:CPU_LANES_QUAD], dtype=torch.float64)
    )
    cpu_solved = qref.state.solved.numpy()
    check(
        cpu_solved.tolist() == qsolved[:CPU_LANES_QUAD].tolist(),
        f"quadruped: solved flags differ from the CPU float64 re-solve: {cpu_solved.tolist()} vs "
        f"{qsolved[:CPU_LANES_QUAD].tolist()}",
    )
    states = np.concatenate(qts._state_indices)
    xq = qx[:CPU_LANES_QUAD].double().cpu()
    eq_viol, cone_margin = contract_in_float64(quadruped_solver(qopts, "cpu", np.float64), xq, x0q_np[:CPU_LANES_QUAD])
    for lane in range(CPU_LANES_QUAD):
        gap = float((xq[lane, states] - qref.state.p.x[lane, states]).abs().max())
        both = bool(cpu_solved[lane] and qsolved[lane])
        branch = both and gap > CPU_ATOL_QUAD
        print(
            f"{tag} quadruped lane {lane}: CPU float64 re-solve solved {bool(cpu_solved[lane])}, "
            f"iterations {int(qref.state.total_i[lane])} (card {int(qiters[lane])}), max state gap {gap:.3e} "
            + (f"(limit {CPU_ATOL_QUAD:g})" if both else "(not both solved)")
            + (
                f", another local solution: the card's, in float64, max |g| {eq_viol[lane]:.3e}, "
                f"least cone margin {cone_margin[lane]:.3e} (limits {BRANCH_TOL:g})" if branch else ""
            )
        )
        check(
            not branch or (eq_viol[lane] <= BRANCH_TOL and cone_margin[lane] >= -BRANCH_TOL),
            f"quadruped lane {lane}: {gap:.3e} from the CPU re-solve and off the contract in float64",
        )
    phase("6: quadruped warm batches")
    from calipso_tpu_torch.solver import kkt

    oracles = ("lagrangian_hessian_blocks", "gx", "hx", "fx", "gty_x", "htz_x", "f", "g", "h")
    layers = [(qbts.fns, a) for a in oracles] + [(kkt, a) for a in ("factorize", "solve_with", "matvec")]
    with layer_timers(layers) as spent:
        wall = warm_batches(tag, "quadruped", B_QUAD, qbts, lambda: qbts.solve(parameters=x0q), qst, WARM_REPS_QUAD)
    for attr, (sec, calls) in sorted(spent.items(), key=lambda kv: -kv[1][0]):
        print(
            f"{tag}   quadruped warm batches, host time in {attr}: {sec:.3f} s "
            f"({100.0 * sec / wall:.1f}% of the wall) over {calls} calls"
        )
    popts = tol_options(
        Options, max_iterative_refinement=2, max_outer_iterations=1, max_residual_iterations=PROFILE_ITERS_QUAD
    )
    pbts = quadruped_solver(popts, "cuda", np.float32).batched()
    pbts.solve(parameters=x0q)  # its one-time set-up
    profile(
        tag, f"quadruped (first {PROFILE_ITERS_QUAD} lockstep iterations of a batch)",
        lambda: pbts.solve(parameters=x0q), host_ops=False,
    )

    # 7. the quadruped gait golden on the card (float64, the riccati border)
    phase("7: quadruped gait")
    from calipso_tpu_torch import TrajOptSolver
    from calipso_tpu_torch.models import quadruped
    from calipso_tpu_torch.ops import riccati as rc

    gold = np.load(GOLDEN_GAIT)
    gprob = quadruped.gait_problem(horizon=11, travel=0.2)
    gts = TrajOptSolver(
        options=Options(), device="cuda",
        **{k: v for k, v in gprob.items() if k not in ("state_guess", "state_initial", "action_guess")},
    )
    gts.initialize_states(gprob["state_guess"])
    gts.initialize_actions(gprob["action_guess"])
    gst = gts.solver.fns.stage_structure
    check(
        gts.solver.options.linear_solver == "riccati" and len(gst.general_stages) == 2,
        f"gait: {gts.solver.options.linear_solver}, general stages {gst.general_stages}",
    )
    multi = {"calls": 0}
    solve_multi = rc.solve_multi

    def counted_solve_multi(*a):
        multi["calls"] += 1
        return solve_multi(*a)

    rc.solve_multi = counted_solve_multi
    zero_launches(cr)
    t0 = time.time()
    try:
        gres = gts.solve()
        torch.cuda.synchronize()
    finally:
        rc.solve_multi = solve_multi
    gwall = time.time() - t0
    glaunches = dict(cr.LAUNCHES)
    gz = gres.variables.cpu().numpy()
    gstates = lambda z: np.concatenate([z[idx] for idx in gts._state_indices])
    ggap = float(np.abs(gstates(gz) - gstates(gold["variables"])).max())
    giters, gref = int(gres.iterations), int(gold["iterations"])
    print(
        f"{tag} quadruped gait (float64, card): solved {bool(gres.solved)}, iterations {giters} "
        f"(golden {gref}, band {0.85 * gref:.1f}-{1.15 * gref:.1f}), max state gap to the golden {ggap:.3e} "
        f"(limit 1e-2), {gwall:.2f} s; solve_multi calls {multi['calls']}; launches {glaunches}"
    )
    check(bool(gres.solved), "the quadruped gait did not solve on the card")
    check(ggap <= 1e-2, f"gait states differ from the golden by {ggap:.3e}")
    check(0.85 * gref <= giters <= 1.15 * gref, f"gait iterations {giters} outside +-15% of {gref}")
    check(
        multi["calls"] > 0 and all(glaunches[k] > 0 for k in stream_kernels),
        f"the gait's border never ran on the stream kernels: {multi['calls']} solve_multi calls, {glaunches}",
    )

    sources = {
        "t1": "calipso_tpu_torch/csrc/riccati_t1.cu",
        "lanes": "calipso_tpu_torch/csrc/riccati_lanes.cu",
        "stream": "calipso_tpu_torch/csrc/riccati_stream.cu",
    }
    meta = {
        "factor_t1": ("t1", "calipso_tpu/ops/pallas_riccati.py:633", launches, ("factor_t1", "float32")),
        "solve_t1": ("t1", "calipso_tpu/ops/pallas_riccati.py:661", launches, ("solve_t1", "float32")),
        "factor_lanes": ("lanes", "calipso_tpu/ops/pallas_riccati.py:489", rlaunches, ("factor_lanes", "float32", HORIZON_ROCKET)),
        "solve_lanes": ("lanes", "calipso_tpu/ops/pallas_riccati.py:583", rlaunches, ("solve_lanes", "float32", HORIZON_ROCKET)),
        "factor_stream": ("stream", "calipso_tpu/ops/pallas_riccati.py:813", qlaunches, ("factor_stream", "float32", HORIZON_QUAD, 1)),
        "solve_fwd_stream": ("stream", "calipso_tpu/ops/pallas_riccati.py:1081", qlaunches, ("solve_fwd_stream", "float32", HORIZON_QUAD, 1)),
        "solve_bwd_stream": ("stream", "calipso_tpu/ops/pallas_riccati.py:1169", qlaunches, ("solve_bwd_stream", "float32", HORIZON_QUAD, 1)),
    }
    errs[("factor_lanes", "float32", HORIZON_ROCKET)] = max(
        errs[("factor_lanes", "float32", HORIZON_ROCKET)], errs[("factor_lanes M", "float32", HORIZON_ROCKET)]
    )
    errs[("factor_stream", "float32", HORIZON_QUAD, 1)] = max(
        errs[("factor_stream", "float32", HORIZON_QUAD, 1)], errs[("factor_stream M", "float32", HORIZON_QUAD, 1)]
    )
    kernels = []
    for k, (src, replaces, counts, err_key) in meta.items():
        ms, plain_ms, lib_ms, (bms, by) = times[k]
        kernels.append({
            "name": k, "route": "cuda", "source": sources[src], "replaces": replaces,
            "launches": counts[k], "max_abs_err": errs[err_key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_us": bms * 1e3, "bound_by": by, "library_ms": lib_ms,
        })
    phase("done")
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
