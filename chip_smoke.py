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
     not positive definite (NaN on both paths, from the same stage on),
     and (2d) the fused block-tridiagonal solves (solve_batched_fused,
     solve_batched_lanes) at the rocket's and the quadruped's shapes
     against their plain version, float32 and float64, 8 lanes not
     positive definite (NaN over all of their x);
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
     profile one; keep the blocks of its tenth riccati factorization;
  8. call the public solve_batched (the fused kernel) and
     solve_batched_lanes on those blocks with a seeded right-hand side,
     counts zeroed just before: both must launch and nothing else, and
     both agree with ops/riccati's factor + solve on the card;
  9. the cr backend: rocket101 as bench.py:598-645 runs it (T=101, n=903,
     100 cones, float32, tolerances 1e-4, max_iterative_refinement=2), a
     cold and a warm solve, and a warm one on riccati beside it; the same
     solve in float64 with default
     Options on tests/golden/rocket101.npz (states within 1e-3,
     iterations within 2); the batched rocket (B=1024) on cr in float32,
     at least B-8 solved, with a CPU float64 re-solve of 4 lanes;
  10. the pendulum flagship family at B=1024 in float64 on ldl, on lu
     (its ladder on the T=1 factor kernel) and on schur with
     refinement_fallback=True: at least B-8 solved each, a CPU float64
     re-solve of 4 lanes with the same flags and iterations, one warm
     batch each; then the fallback made to fire: schur with
     refinement_fallback=True and the Cholesky factor of every 4th lane
     scaled by 1e4 inside kkt.factorize, where each broken lane and no
     other must fall back to the LU step, with the same flags, iterations
     and fallback counts as a CPU float64 re-solve of 4 lanes under the
     same plant (phases 8-10 run right after phase 4);
  5. time each kernel at its main-path shape against its plain version
     and one PyTorch call computing the same function (for the
     block-tridiagonal kernels, on the assembled dense (B, Td, Td)
     matrices: cholesky_ex, cholesky_solve, solve_triangular, solve), in
     float32 and again in float64; the lanes and stream kernels side by
     side at the quadruped's and the rocket's shapes and, for
     ops/riccati.route's threshold, at d = 9 to 48 with the quadruped's
     B=128, T=8 and d = 12 to 32 with the rocket's B=1024, T=31;
     and the fused solves beside the split factor + solve pair at both
     (run right after phase 2);
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

Partial runs print no such result:
    python3 chip_smoke.py --stream-times         # phase 1, the stream
        # kernels checked and timed at (128, 8, 54) with K=1 and K=22 and
        # the lanes kernels at (1024, 31, 9), in float32 and float64, and
        # the two stream sweeps across d = 50..58 (copied into another
        # checkout, times that one's kernels)
    python3 chip_smoke.py --history rocket,cr    # phase 1, the named
        # earlier phases (none: ''), then a cold and a warm quadruped
        # batch: digests of their solutions and of a few library calls,
        # and of every aten op of each batch's first gx call (--ops-out
        # PATH keeps them; --linalg sets the preferred linalg library), to
        # find what makes the quadruped's float32 numbers depend on the
        # process's history
    python3 chip_smoke.py --compare-ops REF OTHER  # two --ops-out files
        # (no card needed): how many of the cold batches' first gx ops run
        # in another order, and the first op whose inputs are alike and
        # whose outputs differ
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
# H100 SXM outside the tensor cores (NVIDIA data sheet), and bytes a word
FLOPS_PER_S = {"float32": 67e12, "float64": 34e12}
WORD = {"float32": 4, "float64": 8}

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
# the layers whose host time the warm batches report, and whose arguments
# and results the history probe digests (its first DIGEST_CALLS calls)
QUAD_ORACLES = ("lagrangian_hessian_blocks", "gx", "hx", "fx", "gty_x", "htz_x", "f", "g", "h")
KKT_LAYERS = ("factorize", "solve_with", "matvec")
DIGEST_CALLS = 400
# (B, T, d, K) of the stream kernels' checks; the first is the main path's,
# the last a ragged one: d=61 ends on a 5-wide factor panel and a 1-row
# edge of 4 x 4 tiles, K=33 on a second chunk of one column
STREAM_SHAPES = (
    (B_QUAD, HORIZON_QUAD, 54, 1), (B_QUAD, HORIZON_QUAD, 54, 22), (B_ROCKET, HORIZON_ROCKET, 9, 1), (16, 3, 61, 33),
)
# the stage widths at which the forward sweep's bank conflicts are timed
# (--stream-times), and the (B, T, d) at which both routes are timed
# (phase 5): the quadruped's B and T and the rocket's, at the widths
# between their stage blocks, where ops/riccati.route draws its line
CONFLICT_DS = (50, 52, 54, 56, 58)
ROUTE_SHAPES = tuple((B_QUAD, HORIZON_QUAD, d) for d in (9, 12, 16, 24, 32, 33, 40, 48)) + tuple(
    (B_ROCKET, HORIZON_ROCKET, d) for d in (12, 16, 24, 32)
)
GOLDEN_GAIT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "quadruped_gait.npz")

# the fused block-tridiagonal solves (TPU kernels 8 and 9), checked at the
# batched rocket's and the quadruped's stage blocks
BATCHED_KERNELS = ("solve_batched_fused", "solve_batched_lanes")
BATCHED_SHAPES = ((B_ROCKET, HORIZON_ROCKET, 9), (B_QUAD, HORIZON_QUAD, 54))
# the rocket batch's riccati factorization whose blocks the solve_batched
# phase solves again (the first ones are at the initial point)
CAPTURE_CALL = 10
# rocket101 (bench.py:598-645) on cr, and its golden
HORIZON_101 = 101
GOLDEN_ROCKET101 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "rocket101.npz")
# the ldl, lu and fallback phases: the flagship's pendulum at B=1024 in
# float64; their CPU float64 re-solves (and the cr rocket batch's) take 4
# lanes, held to the float64 solutions' agreement
B_DENSE = 1024
CPU_LANES_RESOLVE = 4
CPU_ATOL_DENSE = 1e-6
# the fallback's escalation made to fire: the schur factor of every 4th
# lane scaled by 1e4 (broken_factor)
BROKEN_EVERY, BROKEN_SCALE = 4, 1.0e4


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


def bound(nbytes, flops, dtype="float32"):
    """(least milliseconds, what sets it): bytes over the memory rate or
    operations over the peak rate of `dtype`, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[dtype]
    return (1e3 * t_bytes, "bytes") if t_bytes >= t_ops else (1e3 * t_ops, "operations")


def tri(d):
    """Words of a d x d block's lower triangle: what a function reads of a
    symmetric block or a triangular factor."""
    return d * (d + 1) // 2


def factor_flops(T, d):
    """Operations of one lane's block-tridiagonal factor: T Cholesky
    factors (d^3/3 each) and, for the T-1 couplings, M_t = L_t^-1 O_t' (d^3)
    and the symmetric update D_t+1 - M_t' M_t, lower triangle only
    (d^2 (d+1))."""
    return T * d**3 / 3.0 + (T - 1) * (d * d * (d + 1) + d**3)


def factor_bound(B, T, d, dtype="float32"):
    """bound() of a block-tridiagonal factor: the lower triangles of the
    symmetric D and all of O read; L (its upper zeros too, which the
    contract writes) and M written."""
    dd = d * d
    return bound((T * tri(d) + (T - 1) * dd + T * dd + (T - 1) * dd) * WORD[dtype] * B, factor_flops(T, d) * B, dtype)


def solve_bound(B, T, d, K=1, sweeps=2, dtype="float32"):
    """bound() of a block-tridiagonal solve of K right-hand sides, both
    sweeps or one: the lower triangles of L, all of M and the right-hand
    sides read, the result written."""
    words = T * tri(d) + (T - 1) * d * d + 2 * T * d * K
    return bound(words * WORD[dtype] * B, 3 * sweeps * d * d * K * T * B, dtype)


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


def x_digest(st):
    """A short digest of a batch's solution bits."""
    import hashlib

    return hashlib.sha1(st.p.x.cpu().numpy().tobytes()).hexdigest()[:12]


def warm_batches(tag, name, B, bts, solve, st, reps=WARM_REPS, same_bits=False):
    """Time `reps` warm batches; returns their summed host-clock wall. Each
    must solve the lanes the cold batch `st` solved and, with `same_bits`,
    give its solution bit for bit."""
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
        if not torch.equal(warm.state.solved, st.solved):
            differ = torch.nonzero(warm.state.solved != st.solved)[:, 0].tolist()
            print(
                f"{tag} {name} warm batch {rep + 1}/{reps}: solved flags differ from the cold batch's in lanes "
                f"{differ}: cold {st.solved[differ].tolist()} in {st.total_i[differ].tolist()} iterations, "
                f"warm {warm.state.solved[differ].tolist()} in {warm.state.total_i[differ].tolist()}"
            )
        check(torch.equal(warm.state.solved, st.solved), f"{name} warm batch solved other lanes")
        print(
            f"{tag} {name} warm batch {rep + 1}/{reps} B={B}: "
            f"{start.elapsed_time(end) / 1e3:.4f} s (CUDA events), {wall:.4f} s (host clock), "
            f"{B / wall:.1f} solves/s, host syncs {bts.stats['host_syncs']}; digest of its solution {x_digest(warm.state)}"
            + (f" (cold batch {x_digest(st)})" if same_bits else "")
        )
        if same_bits:
            check(x_digest(warm.state) == x_digest(st), f"{name} warm batch: other solution bits than the cold batch's")
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


def tensor_digest(obj):
    """A short digest of the bits of every tensor in obj (tensors inside
    tuples, lists and dicts included; anything else is skipped)."""
    import hashlib

    import torch

    h = hashlib.sha1()

    def walk(o):
        if isinstance(o, torch.Tensor):
            h.update(o.detach().cpu().numpy().tobytes())
        elif isinstance(o, (tuple, list)):
            for v in o:
                walk(v)
        elif isinstance(o, dict):
            for k in sorted(o):
                walk(o[k])

    walk(obj)
    return h.hexdigest()[:12]


@contextlib.contextmanager
def layer_digests(targets, calls):
    """Wrap each (owner, attribute) callable and yield the list of the first
    `calls` calls in order, as (attribute, digest of the arguments, digest
    of the result)."""
    seen, saved = [], []
    for owner, attr in targets:
        fn = getattr(owner, attr)

        def recorded(*a, _fn=fn, _attr=attr, **k):
            out = _fn(*a, **k)
            if len(seen) < calls:
                seen.append((_attr, tensor_digest((a, k)), tensor_digest(out)))
            return out

        saved.append((owner, attr, fn))
        setattr(owner, attr, recorded)
    try:
        yield seen
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


def check_lanes(tag, cr, dev, B, T, d, errs, times=None, times64=None):
    """factor_lanes/solve_lanes against their plain versions at (B, T, d)
    in float32 and float64: random SPD block-tridiagonal inputs with 8
    lanes not positive definite from the middle stage on. Into `times` and
    `times64`, when given, the float32 and the float64 kernel, plain and
    bound times."""
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
        into = times if name == "float32" else times64
        if into is not None:
            into["factor_lanes"] = (
                cuda_ms(lambda: cr.factor_lanes(D, O), 50),
                cuda_ms(lambda: cr.factor_lanes_plain(D, O), 10), None, factor_bound(B, T, d, name),
            )
            into["solve_lanes"] = (
                cuda_ms(lambda: cr.solve_lanes(L, M, b), 50),
                cuda_ms(lambda: cr.solve_lanes_plain(L, M, b), 10), None, solve_bound(B, T, d, dtype=name),
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


def check_stream(tag, cr, dev, B, T, d, K, errs, times=None, times64=None):
    """factor_stream, solve_fwd_stream and solve_bwd_stream against their
    plain versions at (B, T, d) with K right-hand sides, float32 and
    float64; each sweep is given the same inputs on both paths (the plain
    factor, then the plain forward sweep's u). Into `times` and `times64`,
    when given, the float32 and the float64 kernel, plain and bound
    times."""
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
        into = times if name == "float32" else times64
        if into is not None:
            into["factor_stream"] = (
                cuda_ms(lambda: cr.factor_stream(D, O), 50),
                cuda_ms(lambda: cr.factor_stream_plain(D, O), 10), None, factor_bound(B, T, d, name),
            )
            into["solve_fwd_stream"] = (
                cuda_ms(lambda: cr.solve_fwd_stream(L, M, b), 50),
                cuda_ms(lambda: cr.solve_fwd_stream_plain(L, M, b), 10), None,
                solve_bound(B, T, d, K, sweeps=1, dtype=name),
            )
            into["solve_bwd_stream"] = (
                cuda_ms(lambda: cr.solve_bwd_stream(L, M, up), 50),
                cuda_ms(lambda: cr.solve_bwd_stream_plain(L, M, up), 10), None,
                solve_bound(B, T, d, K, sweeps=1, dtype=name),
            )


def print_times(tag, times, name, shape="main-path shape"):
    """Kernel, plain and bound times of `times` in one precision."""
    for kname, (ms, plain_ms, _, (bms, by)) in times.items():
        print(
            f"{tag} {kname} {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bms * 1e3:.2f} us ({by}), {100.0 * bms / ms:.1f}% of the bound"
        )


def sweeps_across_d(tag, cr, dev):
    """solve_fwd_stream beside solve_bwd_stream at the quadruped's (B, T)
    with d in CONFLICT_DS, K=1, float32: the forward sweep reads columns of
    L_t, strided by d in shared memory (gcd(d, 32) lanes to a bank), the
    backward one rows (no conflict); a time that follows the bank ways and
    not d shows the conflict's cost."""
    import math

    import torch

    B, T = B_QUAD, HORIZON_QUAD
    for d in CONFLICT_DS:
        D64, O64, b64, bad_stage, bad_lanes = tridiag_inputs(B, T, d, 1)
        D64[bad_lanes, bad_stage] *= -1.0  # back to positive definite
        D, O, b = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (D64, O64, b64))
        L, M = cr.factor_stream(D, O)
        u = cr.solve_fwd_stream(L, M, b)
        fwd = cuda_ms(lambda: cr.solve_fwd_stream(L, M, b), 50)
        bwd = cuda_ms(lambda: cr.solve_bwd_stream(L, M, u), 50)
        print(
            f"{tag} sweeps float32 B={B} T={T} d={d} K=1 (column reads {math.gcd(d, 32)} lanes to a bank): "
            f"solve_fwd_stream {fwd:.4f} ms, solve_bwd_stream {bwd:.4f} ms, "
            f"{1e6 * fwd / (T * d):.1f} / {1e6 * bwd / (T * d):.1f} ns a pivot"
        )


def stream_times(tag, cr, dev):
    """--stream-times: the stream kernels checked and timed at the
    quadruped's (B, T, d) with K=1 and K=22 right-hand sides, the lanes
    kernels at the rocket's (B, T, d), float32 and float64, and the sweeps
    across d (sweeps_across_d)."""
    for B, T, d, K in STREAM_SHAPES[:2]:
        times, times64 = {}, {}
        check_stream(tag, cr, dev, B, T, d, K, {}, times, times64)
        for name, into in (("float32", times), ("float64", times64)):
            print_times(tag, into, name, f"B={B} T={T} d={d} K={K}")
    B, T, d = LANES_SHAPES[0]
    times, times64 = {}, {}
    check_lanes(tag, cr, dev, B, T, d, {}, times, times64)
    for name, into in (("float32", times), ("float64", times64)):
        print_times(tag, into, name, f"B={B} T={T} d={d}")
    sweeps_across_d(tag, cr, dev)


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


def dense_tridiag(D, O):
    """The (B, Td, Td) symmetric matrix of diagonal blocks D (B, T, d, d)
    and sub-diagonal blocks O (B, T-1, d, d)."""
    B, T, d = D.shape[0], D.shape[1], D.shape[-1]
    S = D.new_zeros(B, T * d, T * d)
    for t in range(T):
        S[:, t * d:(t + 1) * d, t * d:(t + 1) * d] = D[:, t]
        if t < T - 1:
            S[:, (t + 1) * d:(t + 2) * d, t * d:(t + 1) * d] = O[:, t]
            S[:, t * d:(t + 1) * d, (t + 1) * d:(t + 2) * d] = O[:, t].mT
    return S


def dense_factor(L, M):
    """The (B, Td, Td) lower factor of the block factor (L, M): L_t on the
    diagonal, M_t' below it."""
    B, T, d = L.shape[0], L.shape[1], L.shape[-1]
    F = L.new_zeros(B, T * d, T * d)
    for t in range(T):
        F[:, t * d:(t + 1) * d, t * d:(t + 1) * d] = L[:, t]
        if t < T - 1:
            F[:, (t + 1) * d:(t + 2) * d, t * d:(t + 1) * d] = M[:, t].mT
    return F


def library_times(cr, dev, B, T, d):
    """The library yardsticks of the block-tridiagonal kernels at (B, T, d),
    float32, every lane positive definite, one right-hand side: one
    PyTorch call on the assembled dense (B, Td, Td) matrices (O((Td)^3)
    work where the kernels do O(T d^3)), milliseconds by CUDA events. The
    port never calls them."""
    import torch

    D64, O64, b64, bad_stage, bad_lanes = tridiag_inputs(B, T, d, 1)
    D64[bad_lanes, bad_stage] *= -1.0  # back to positive definite
    D, O, b = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (D64, O64, b64))
    S = dense_tridiag(D, O)
    F = dense_factor(*cr.factor_stream_plain(D, O))
    FT = F.mT.contiguous()
    bv = b.reshape(B, T * d, 1)
    return {
        "factor": cuda_ms(lambda: torch.linalg.cholesky_ex(S), 10),
        "both sweeps": cuda_ms(lambda: torch.cholesky_solve(bv, F), 10),
        "forward sweep": cuda_ms(lambda: torch.linalg.solve_triangular(F, bv, upper=False), 10),
        "backward sweep": cuda_ms(lambda: torch.linalg.solve_triangular(FT, bv, upper=True), 10),
        "factor and solve": cuda_ms(lambda: torch.linalg.solve(S, bv), 10),
    }


# the library call each block-tridiagonal kernel is held to (library_times),
# at the shape of its main path: the rocket's or the quadruped's
LIBRARY_CALLS = {
    "factor_lanes": ("rocket", "factor"), "solve_lanes": ("rocket", "both sweeps"),
    "factor_stream": ("quadruped", "factor"), "solve_fwd_stream": ("quadruped", "forward sweep"),
    "solve_bwd_stream": ("quadruped", "backward sweep"),
    "solve_batched_fused": ("rocket", "factor and solve"), "solve_batched_lanes": ("rocket", "factor and solve"),
}
LIBRARY_NAMES = {
    "factor": "torch.linalg.cholesky_ex", "both sweeps": "torch.cholesky_solve",
    "forward sweep": "torch.linalg.solve_triangular (lower)",
    "backward sweep": "torch.linalg.solve_triangular (upper, the transpose)",
    "factor and solve": "torch.linalg.solve",
}


def batched_bound(B, T, d, dtype="float32"):
    """bound() of a fused block-tridiagonal solve: D's lower triangles, O
    and b read once, x written once; the factor's operations and both
    sweeps' (a triangular solve a stage each, d^2, and a product with M_t
    each, 2 d^2, for the T-1 couplings)."""
    dd = d * d
    sweeps = 2 * dd * T + 4 * dd * (T - 1)
    return bound((T * tri(d) + (T - 1) * dd + 2 * T * d) * WORD[dtype] * B, (factor_flops(T, d) + sweeps) * B, dtype)


def check_batched(tag, cr, dev, B, T, d, errs):
    """solve_batched_fused and solve_batched_lanes against
    solve_batched_plain at (B, T, d) in float32 and float64, with 8 lanes
    not positive definite from the middle stage on (NaN over all of their
    x on every path); each wrapper's launch counter must move by one."""
    import torch

    D64, O64, b64, bad_stage, bad_lanes = tridiag_inputs(B, T, d, 1)
    shape = f"B={B} T={T} d={d}"
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        D, O, b = (torch.tensor(a, dtype=dtype, device=dev) for a in (D64, O64, b64[..., 0]))
        before = dict(cr.LAUNCHES)
        got = {k: getattr(cr, k)(D, O, b) for k in BATCHED_KERNELS}
        torch.cuda.synchronize()
        moved = {k: cr.LAUNCHES[k] - before[k] for k in BATCHED_KERNELS}
        check(all(v == 1 for v in moved.values()), f"batched solves {name} {shape}: launches {moved}")
        xp = cr.solve_batched_plain(D, O, b)
        ok = ~torch.isnan(xp).flatten(1).any(1)
        check(
            torch.nonzero(~ok)[:, 0].tolist() == bad_lanes.tolist() and bool(torch.isnan(xp[~ok]).all()),
            f"solve_batched_plain {name} {shape}: NaN lanes {torch.nonzero(~ok)[:, 0].tolist()}",
        )
        for kname, x in got.items():
            check(
                bool(torch.isnan(x[~ok]).all()) and bool(torch.isfinite(x[ok]).all()),
                f"{kname} {name} {shape}: the NaN lanes differ from the plain version's",
            )
            rel_check(tag, kname, name, shape, x, xp, ok, errs, (kname, name, T))
        print(f"{tag} batched solves {name} {shape}: NaN over all of lanes {bad_lanes.tolist()} (stage {bad_stage}), on every path")


def batched_timed_at(tag, cr, dev, B, T, d, times=None, times64=None):
    """The fused solves, the split factor + solve pair of the route
    ops/riccati.route takes at d, and the plain version, timed side by side
    at (B, T, d), float32, every lane positive definite. The lanes
    wrapper's time includes its layout copies. Into `times`, when given,
    the kernel, plain and bound times of the two fused solves; into
    `times64` the same in float64."""
    import torch
    from calipso_tpu_torch.ops.riccati import route

    D64, O64, b64, bad_stage, bad_lanes = tridiag_inputs(B, T, d, 1)
    D64[bad_lanes, bad_stage] *= -1.0  # back to positive definite
    D, O, b = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (D64, O64, b64[..., 0]))
    if route(d) == "stream":
        split_name, split = "factor_stream + solve_stream", lambda: cr.solve_stream(*cr.factor_stream(D, O), b)
    else:
        split_name, split = "factor_lanes + solve_lanes", lambda: cr.solve_lanes(*cr.factor_lanes(D, O), b)
    bms, by = batched_bound(B, T, d)
    plain_ms = cuda_ms(lambda: cr.solve_batched_plain(D, O, b), 10)
    measured = {}
    for kname, fn, reps in (
        ("solve_batched_fused", lambda: cr.solve_batched_fused(D, O, b), 50),
        ("solve_batched_lanes", lambda: cr.solve_batched_lanes(D, O, b), 10),
        (split_name, split, 50),
    ):
        measured[kname] = ms = cuda_ms(fn, reps)
        print(
            f"{tag} {kname} float32 B={B} T={T} d={d}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bms * 1e3:.2f} us ({by}), {100.0 * bms / ms:.2f}% of the bound"
        )
    print(
        f"{tag} fused against split at B={B} T={T} d={d}: solve_batched_fused "
        f"{measured['solve_batched_fused'] / measured[split_name]:.3f}x the time of {split_name}"
    )
    if times is not None:
        for k in BATCHED_KERNELS:
            times[k] = (measured[k], plain_ms, None, (bms, by))
    if times64 is not None:
        D, O, b = (a.double() for a in (D, O, b))
        plain_ms = cuda_ms(lambda: cr.solve_batched_plain(D, O, b), 10)
        for k, reps in zip(BATCHED_KERNELS, (50, 10)):
            times64[k] = (cuda_ms(lambda: getattr(cr, k)(D, O, b), reps), plain_ms, None, batched_bound(B, T, d, "float64"))


def solve_batched_phase(tag, cr, rc, D, O):
    """The solve_batched entry point and its lanes variant on blocks one of
    the rocket batch's riccati factorizations received, with a seeded
    right-hand side, counts zeroed just before: both kernels must launch
    and nothing else, and both solutions must agree with ops/riccati's
    factor + solve on the card within that route's own float32 error (both
    held to the float64 plain solution). Returns the launch counts."""
    import torch

    B, T, d = D.shape[0], D.shape[1], D.shape[2]
    b = torch.tensor(np.random.default_rng(8).normal(size=(B, T, d)), dtype=D.dtype, device=D.device)
    zero_launches(cr)
    got = {"solve_batched_fused": cr.solve_batched(D, O, b), "solve_batched_lanes": cr.solve_batched_lanes(D, O, b)}
    torch.cuda.synchronize()
    launches = dict(cr.LAUNCHES)
    print(f"{tag} kernel launches in the solve_batched run (B={B} T={T} d={d}, rocket blocks): {launches}")
    check(all(launches[k] > 0 for k in BATCHED_KERNELS), f"a fused solve never launched: {launches}")
    check(all(v == 0 for k, v in launches.items() if k not in BATCHED_KERNELS), f"another kernel launched: {launches}")
    xr = rc.solve(*rc.factor(D, O), b)
    x64 = cr.solve_batched_plain(D.double(), O.double(), b.double())
    ok = torch.isfinite(x64).flatten(1).all(1)
    scale = float(x64[ok].abs().max())
    err_r = float((xr[ok].double() - x64[ok]).abs().max())
    print(
        f"{tag} solve_batched on rocket blocks: {int(ok.sum())}/{B} lanes positive definite; "
        f"riccati factor + solve float32 max |x - x64| {err_r:.3e} (max |x64| {scale:.3e})"
    )
    for kname, x in got.items():
        check(bool(torch.isnan(x[~ok]).all()), f"{kname} on rocket blocks: a failed lane came out finite")
        err = float((x[ok].double() - x64[ok]).abs().max())
        diff = float((x[ok] - xr[ok]).abs().max())
        limit = 10.0 * err_r + RTOL["float32"] * scale
        print(
            f"{tag} {kname} on rocket blocks float32: max |x - x64| {err:.3e}, max |x - x_riccati| {diff:.3e} "
            f"(limit {limit:.3e}: ten times the riccati route's own error plus 1e-4 of max |x64|)"
        )
        check(err <= limit, f"{kname} disagrees with the riccati route on rocket blocks")
    return launches


def rocket101_solver(options, device, dtype):
    """bench.py:598-645: the T=101 rocket landing (903 variables, 100
    three-dimensional cones), states from the problem's guess, actions
    1e-3 N(0, 1) (default_rng(0)). Returns (solver, guess)."""
    from calipso_tpu_torch import TrajOptSolver
    from calipso_tpu_torch.models import rocket

    prob = rocket.landing_problem(horizon=HORIZON_101)
    kw = {k: v for k, v in prob.items() if k not in ("state_guess", "state_initial", "state_goal")}
    ts = TrajOptSolver(options=options, device=device, **kw)
    guess = np.zeros(ts.num_variables, dtype=dtype)
    for t, idx in enumerate(ts._state_indices):
        guess[idx] = np.asarray(prob["state_guess"][t])
    rng = np.random.default_rng(0)
    for t, idx in enumerate(ts._action_indices):
        guess[idx] = 1e-3 * rng.normal(size=3)
    return ts, guess


def cr_phase(tag, cr, Options, dev):
    """The cr backend on the card: rocket101 as the bench runs it
    (float32, one cold and one warm solve), the same solve in float64 with
    default Options on its golden, and the batched rocket (B=1024) in
    float32 with a CPU float64 re-solve of 4 lanes."""
    import torch

    opts = tol_options(Options, max_iterative_refinement=2, linear_solver="cr")
    ts, guess = rocket101_solver(opts, dev, np.float32)
    check(ts.solver.options.linear_solver == "cr", f"rocket101 on {ts.solver.options.linear_solver}")
    zero_launches(cr)
    t0 = time.time()
    ts.solver.initialize(torch.tensor(guess, device=dev))
    r = ts.solver.solve()
    torch.cuda.synchronize()
    cold = time.time() - t0
    launches = dict(cr.LAUNCHES)
    x = r.variables
    t0 = time.time()
    rw = ts.solver.solve(x0=torch.tensor(guess + 1e-5, device=dev))  # bench.py perturbs each rep
    torch.cuda.synchronize()
    warm = time.time() - t0
    print(
        f"{tag} rocket101 on cr (float32, n={ts.num_variables}): solved {bool(r.solved)}, iterations "
        f"{int(r.iterations)}, cold {cold:.3f} s; warm solve: solved {bool(rw.solved)}, iterations "
        f"{int(rw.iterations)}, {warm:.4f} s (host clock); kernel launches {launches} (cr runs no kernel of its own)"
    )
    check(bool(r.solved) and bool(rw.solved), "rocket101 on cr did not solve in float32")
    check(bool(torch.isfinite(x).all()) and tuple(x.shape) == (ts.num_variables,), "rocket101: bad solution")
    # the same solve on riccati, beside it (the reference chose cr for it)
    rts101, _ = rocket101_solver(opts.replace(linear_solver="riccati"), dev, np.float32)
    rts101.solver.initialize(torch.tensor(guess, device=dev))
    rr = rts101.solver.solve()
    torch.cuda.synchronize()
    t0 = time.time()
    rr = rts101.solver.solve(x0=torch.tensor(guess + 1e-5, device=dev))
    torch.cuda.synchronize()
    print(
        f"{tag} rocket101 on riccati beside it (float32): solved {bool(rr.solved)}, iterations "
        f"{int(rr.iterations)}, warm solve {time.time() - t0:.4f} s (host clock; cr {warm:.4f} s)"
    )

    gold = np.load(GOLDEN_ROCKET101)
    gts, gguess = rocket101_solver(Options(linear_solver="cr"), dev, np.float64)
    t0 = time.time()
    gts.solver.initialize(torch.tensor(gguess, device=dev))
    gr = gts.solver.solve()
    torch.cuda.synchronize()
    gz = gr.variables.cpu().numpy()
    states = np.concatenate(gts._state_indices)
    gap = float(np.abs(gz[states] - gold["variables"][states]).max())
    giters, gref = int(gr.iterations), int(gold["iterations"])
    print(
        f"{tag} rocket101 on cr (float64, default Options): solved {bool(gr.solved)}, iterations {giters} "
        f"(golden {gref}, limit +-2), max state gap to the golden {gap:.3e} (limit 1e-3), {time.time() - t0:.2f} s"
    )
    check(bool(gr.solved) and gap <= 1e-3 and abs(giters - gref) <= 2, "rocket101 on cr misses its golden")

    ropts = tol_options(Options, max_iterative_refinement=2, linear_solver="cr")
    rts = rocket_solver(ropts, dev)
    g0 = np.asarray(rts._guess, np.float32)
    guess_np = g0[None] + 0.01 * np.random.default_rng(0).normal(size=(B_ROCKET, g0.size)).astype(np.float32)
    gpu_guess = torch.tensor(guess_np, device=dev)
    rbts = rts.batched()
    zero_launches(cr)
    t0 = time.time()
    res = rbts.solve(guess=gpu_guess)
    torch.cuda.synchronize()
    print(f"{tag} rocket batch on cr cold batch: {time.time() - t0:.3f} s; kernel launches {dict(cr.LAUNCHES)}")
    st = res.state
    check(bool(torch.isfinite(st.p.x[st.solved]).all()), "non-finite solution in a solved cr rocket lane")
    solved, _ = report_solve(f"{tag} rocket batch on cr", B_ROCKET, st)
    check(int(solved.sum()) >= MIN_SOLVED_ROCKET, f"only {int(solved.sum())} of {B_ROCKET} cr rocket lanes solved")
    ref = rocket_solver(ropts, "cpu").batched().solve(guess=torch.tensor(guess_np[:CPU_LANES_RESOLVE], dtype=torch.float64))
    cpu_resolve(tag, "rocket batch on cr", st, ref, CPU_LANES_RESOLVE, CPU_ATOL_ROCKET)
    warm_batches(tag, "rocket batch on cr", B_ROCKET, rbts, lambda: rbts.solve(guess=gpu_guess), st, reps=1)


def dense_phase(tag, cr, Options, dev):
    """The ldl and lu backends and refinement_fallback on schur: the
    flagship's pendulum family at B=1024 in float64, counts zeroed just
    before each; at least B-8 solved each, and a CPU float64 re-solve of 4
    lanes with the same flags and iterations."""
    import torch

    x0_np = 0.2 * np.random.default_rng(0).normal(size=(B_DENSE, 2))
    x0s = torch.tensor(x0_np, dtype=torch.float64, device=dev)
    for label, kw, kernels in (
        ("ldl", dict(linear_solver="ldl"), ()),
        ("lu", dict(linear_solver="lu"), ("factor_t1",)),
        ("schur + refinement_fallback", dict(linear_solver="schur", refinement_fallback=True), ("factor_t1", "solve_t1")),
    ):
        opts = tol_options(Options, **kw)
        bts = flagship(opts, dev)
        zero_launches(cr)
        t0 = time.time()
        res = bts.solve(parameters=x0s)
        torch.cuda.synchronize()
        launches = dict(cr.LAUNCHES)
        st = res.state
        print(
            f"{tag} pendulum B={B_DENSE} float64 on {label}: cold batch {time.time() - t0:.3f} s; "
            f"LU fallbacks {int(st.num_fallbacks.sum())}; kernel launches {launches}"
        )
        check(all(launches[k] > 0 for k in kernels), f"{label}: a kernel of its path never launched: {launches}")
        check(bool(torch.isfinite(st.p.x[st.solved]).all()), f"{label}: non-finite solution in a solved lane")
        solved, _ = report_solve(f"{tag} pendulum on {label}", B_DENSE, st)
        check(int(solved.sum()) >= B_DENSE - 8, f"{label}: only {int(solved.sum())} of {B_DENSE} lanes solved")
        ref = flagship(opts, "cpu").solve(parameters=torch.tensor(x0_np[:CPU_LANES_RESOLVE]))
        same_i = ref.state.total_i.tolist() == st.total_i[:CPU_LANES_RESOLVE].cpu().tolist()
        check(same_i, f"{label}: iterations differ from the CPU float64 re-solve")
        cpu_resolve(tag, f"pendulum on {label}", st, ref, CPU_LANES_RESOLVE, CPU_ATOL_DENSE)
        warm_batches(tag, f"pendulum on {label}", B_DENSE, bts, lambda: bts.solve(parameters=x0s), st, reps=1)


@contextlib.contextmanager
def broken_factor():
    """Inside kkt.factorize, scale the schur factor L of every
    BROKEN_EVERY-th lane of a batch (lane 0 first) by BROKEN_SCALE, as
    tests/test_torch_ldl.py does to a whole problem: those lanes' refined
    steps keep no usable digits, so refinement_fallback must replace them
    with the full-system LU step, and the other lanes' steps must stand."""
    import torch
    from calipso_tpu_torch.solver import kkt

    orig = kkt.factorize

    def factorize(*args, **kw):
        fact = orig(*args, **kw)
        broken = torch.arange(fact.L.shape[0], device=fact.L.device) % BROKEN_EVERY == 0
        return fact._replace(L=torch.where(broken[:, None, None], fact.L * BROKEN_SCALE, fact.L))

    kkt.factorize = factorize
    try:
        yield
    finally:
        kkt.factorize = orig


def fallback_fires_phase(tag, cr, Options, dev):
    """refinement_fallback with its escalation firing: the pendulum at
    B=1024 in float64 on schur under broken_factor(), counts zeroed just
    before. Every broken lane must fall back and no other lane; at least
    B-8 solved; a CPU float64 re-solve of 4 lanes (lane 0 broken) under the
    same plant with the same flags, iterations and fallback counts."""
    import torch

    x0_np = 0.2 * np.random.default_rng(0).normal(size=(B_DENSE, 2))
    opts = tol_options(Options, linear_solver="schur", refinement_fallback=True)
    bts = flagship(opts, dev)
    broken = np.arange(B_DENSE) % BROKEN_EVERY == 0
    with broken_factor():
        zero_launches(cr)
        t0 = time.time()
        res = bts.solve(parameters=torch.tensor(x0_np, device=dev))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(cr.LAUNCHES)
        ref = flagship(opts, "cpu").solve(parameters=torch.tensor(x0_np[:CPU_LANES_RESOLVE]))
    st = res.state
    fb = st.num_fallbacks.cpu().numpy()
    print(
        f"{tag} pendulum B={B_DENSE} float64 on schur + refinement_fallback, the factor of every "
        f"{BROKEN_EVERY}th lane scaled by {BROKEN_SCALE:g}: batch {wall:.3f} s; LU fallbacks {int(fb.sum())} "
        f"(broken lanes: {int(fb[broken].min())}-{int(fb[broken].max())} each; other lanes: "
        f"{int(fb[~broken].max())} at most); kernel launches {launches}"
    )
    check(all(launches[k] > 0 for k in ("factor_t1", "solve_t1")), f"broken factor: a T=1 kernel never launched: {launches}")
    check(bool((fb[broken] > 0).all()), "broken factor: a broken lane never fell back to the LU step")
    check(bool((fb[~broken] == 0).all()), "broken factor: a healthy lane fell back to the LU step")
    check(bool(torch.isfinite(st.p.x[st.solved]).all()), "broken factor: non-finite solution in a solved lane")
    solved, _ = report_solve(f"{tag} pendulum with broken factors", B_DENSE, st)
    check(int(solved.sum()) >= B_DENSE - 8, f"broken factor: only {int(solved.sum())} of {B_DENSE} lanes solved")
    same_i = ref.state.total_i.tolist() == st.total_i[:CPU_LANES_RESOLVE].cpu().tolist()
    same_fb = ref.state.num_fallbacks.tolist() == fb[:CPU_LANES_RESOLVE].tolist()
    print(f"{tag} broken factor CPU float64 re-solve: LU fallbacks {ref.state.num_fallbacks.tolist()} (card {fb[:CPU_LANES_RESOLVE].tolist()})")
    check(same_i and same_fb, "broken factor: iterations or fallback counts differ from the CPU float64 re-solve")
    cpu_resolve(tag, "pendulum with broken factors", st, ref, CPU_LANES_RESOLVE, CPU_ATOL_DENSE)


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


def build_kernels(tag):
    """Phase 1: build every kernel library with nvcc (one process a
    source, all started together) and load it; print ptxas's registers
    and spills."""
    from calipso_tpu_torch.ops import _build

    t0 = time.time()
    libs = _build.build()
    for stem in libs:
        _build.load(stem)
    print(f"{tag} build: {', '.join(str(p) for p in libs.values())} in {time.time() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"{tag} ptxas: {line.strip()}")


def kernel_phases(tag, cr, dev, phase):
    """Phases 2 and 5: every kernel against its plain version, then the
    kernel times. Returns (errs, times), which the kernels line reads."""
    import torch

    errs, times, times64 = {}, {}, {}
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
        into = times if name == "float32" else times64
        Sg, Lg, bg = S[ok].contiguous(), L[ok].contiguous(), b[ok].contiguous()
        into["factor_t1"] = (
            cuda_ms(lambda: cr.factor_t1(S), 50), cuda_ms(lambda: cr.factor_t1_plain(S), 50),
            cuda_ms(lambda: torch.linalg.cholesky_ex(Sg), 50),
            bound((tri(n) + n * n) * WORD[name] * B_FLAG, n**3 / 3 * B_FLAG, name),
        )
        into["solve_t1"] = (
            cuda_ms(lambda: cr.solve_t1(L, b), 50), cuda_ms(lambda: cr.solve_t1_plain(L, b), 50),
            cuda_ms(lambda: torch.cholesky_solve(bg[..., None], Lg), 50),
            bound((tri(n) + 2 * n) * WORD[name] * B_FLAG, 2 * n * n * B_FLAG, name),
        )

    # 2b. block-tridiagonal kernels against their plain versions
    for B, T, d in LANES_SHAPES:
        main_path = (B, T, d) == LANES_SHAPES[0]
        check_lanes(tag, cr, dev, B, T, d, errs, times if main_path else None, times64 if main_path else None)
    # 2c. the stream kernels against their plain versions
    for B, T, d, K in STREAM_SHAPES:
        main_path = (B, T, d, K) == STREAM_SHAPES[0]
        check_stream(tag, cr, dev, B, T, d, K, errs, times if main_path else None, times64 if main_path else None)
    # 2d. the fused solves against their plain version
    phase("2d: fused block-tridiagonal solves against their plain version")
    for B, T, d in BATCHED_SHAPES:
        check_batched(tag, cr, dev, B, T, d, errs)

    # 5. kernel times at the main-path shapes, and the two block-tridiagonal
    # routes side by side at the quadruped's and the rocket's shapes and at
    # the widths between them
    phase("5: kernel times")
    for B, T, d in ((B_QUAD, HORIZON_QUAD, 54), (B_ROCKET, HORIZON_ROCKET, 9)) + ROUTE_SHAPES:
        routes_timed_at(tag, cr, dev, B, T, d)
    for B, T, d in BATCHED_SHAPES:
        main_path = (B, T, d) == BATCHED_SHAPES[0]
        batched_timed_at(tag, cr, dev, B, T, d, times if main_path else None, times64 if main_path else None)
    library = {
        "rocket": library_times(cr, dev, B_ROCKET, HORIZON_ROCKET, 9),
        "quadruped": library_times(cr, dev, B_QUAD, HORIZON_QUAD, 54),
    }
    for kname, (cell, call) in LIBRARY_CALLS.items():
        ms, plain_ms, _, bnd = times[kname]
        times[kname] = (ms, plain_ms, library[cell][call], bnd)
        print(f"{tag} {kname}: library yardstick {LIBRARY_NAMES[call]} on the dense {cell} matrices")
    for kname, (ms, plain_ms, lib_ms, (bms, by)) in times.items():
        print(
            f"{tag} {kname} float32 main-path shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {bms * 1e3:.2f} us ({by}), {100.0 * bms / ms:.1f}% of the bound"
        )
    print_times(tag, times64, "float64")
    return errs, times


def flagship_phase(tag, cr, Options, dev):
    """Phase 3: the flagship batch on the card; returns its launches."""
    import torch

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
    return launches


def rocket_phase(tag, cr, rc, Options, dev):
    """Phase 4: the batched rocket on the card; returns its launches and
    the blocks of its CAPTURE_CALL-th riccati factorization."""
    import torch

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
    # keep the blocks one riccati factorization of this batch receives,
    # for the solve_batched phase
    captured = {"calls": 0}
    rc_factor = rc.factor

    def capturing_factor(D, O):
        captured["calls"] += 1
        if captured["calls"] <= CAPTURE_CALL:
            captured["blocks"] = (D.clone(), O.clone())
        return rc_factor(D, O)

    rc.factor = capturing_factor
    zero_launches(cr)
    t0 = time.time()
    try:
        rres = rbts.solve(guess=guess)
        torch.cuda.synchronize()
    finally:
        rc.factor = rc_factor
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
    return rlaunches, captured


# the earlier phases the history probe can run before the quadruped
HISTORY_GROUPS = ("kernels", "flagship", "rocket", "cr", "dense", "fallback")


def op_digests(dev):
    """Digests of a few float32 library calls of the kinds the quadruped's
    path makes, on seeded inputs at its sizes: a digest that changes within
    a process shows a call whose result depends on what ran before it."""
    import hashlib

    import torch

    g = torch.Generator().manual_seed(0)
    A = torch.randn(B_QUAD, 400, 400, generator=g).to(dev)
    v = torch.randn(B_QUAD, 400, 1, generator=g).to(dev)
    W = A[:, :54, :54]
    S = W @ W.mT + 54.0 * torch.eye(54, device=dev)
    L = torch.linalg.cholesky_ex(S)[0]
    idx = torch.randint(0, 8, (400,), generator=g).to(dev)
    calls = {
        "matmul": lambda: A @ v,
        "bmm": lambda: torch.bmm(A, A),
        "einsum": lambda: torch.einsum("bij,bkj->bik", W, W),
        "sum": lambda: A.sum(dim=(1, 2)),
        "vector_norm": lambda: torch.linalg.vector_norm(A, dim=-1),
        "cholesky_ex": lambda: torch.linalg.cholesky_ex(S)[0],
        "solve_triangular": lambda: torch.linalg.solve_triangular(L, v[:, :54], upper=False),
        "index_add": lambda: torch.zeros(B_QUAD, 8, 400, device=dev).index_add_(1, idx, A),
    }
    return {k: hashlib.sha1(f().cpu().numpy().tobytes()).hexdigest()[:12] for k, f in calls.items()}


def tensor_sig(t):
    """[digest of a tensor's bits, shape, strides and dtype; its
    data_ptr() % 512]."""
    import hashlib

    h = hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes())
    h.update(repr((tuple(t.shape), t.stride(), str(t.dtype))).encode())
    return [h.hexdigest()[:12], t.data_ptr() % 512]


def op_recorder():
    """A TorchDispatchMode that appends, for every aten op run under it,
    [name, input sigs, output sigs] (tensor_sig of every tensor argument
    and result, nested lists included) to its `ops`. Input sigs are taken
    before the op runs: an in-place op overwrites its input."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    def sigs(obj):
        if isinstance(obj, torch.Tensor):
            return [tensor_sig(obj)]
        if isinstance(obj, (tuple, list)):
            return [s for o in obj for s in sigs(o)]
        if isinstance(obj, dict):
            return [s for k in sorted(obj) for s in sigs(obj[k])]
        return []

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = sigs((args, kwargs))
            out = func(*args, **kwargs)
            self.ops.append([str(func), ins, sigs(out)])
            return out

    return Recorder()


@contextlib.contextmanager
def record_first_call(owner, attr):
    """Run the first call of owner.attr under op_recorder(); yield the list
    its ops land in."""
    fn, ops = getattr(owner, attr), []
    seen = []

    def first(*a, **k):
        if seen:
            return fn(*a, **k)
        seen.append(True)
        rec = op_recorder()
        with rec:
            out = fn(*a, **k)
        ops.extend(rec.ops)
        return out

    setattr(owner, attr, first)
    try:
        yield ops
    finally:
        setattr(owner, attr, fn)


def first_op_differing(ref, ops):
    """Compare two op lists of op_recorder(): how many positions hold
    another op (name, input or output bits), whether the two lists hold the
    same ops in another order (names alone, and names with their bits),
    how many ops' data_ptr() % 512 differ, the first op alike in name and
    input bits whose output bits differ (ops that return uninitialised
    memory, the empty family, skipped), and the first position where the
    ops differ; each op with both sides' sigs."""
    import collections

    key = lambda op: (op[0], tuple(s[0] for s in op[1]), tuple(s[0] for s in op[2]))
    entry = lambda i: {"index": i, "ops": [ref[i][0], ops[i][0]], "inputs": [ref[i][1], ops[i][1]], "outputs": [ref[i][2], ops[i][2]]}
    differ = [i for i, (a, b) in enumerate(zip(ref, ops)) if key(a) != key(b)]
    first_out = next(
        (
            i for i, (a, b) in enumerate(zip(ref, ops))
            if key(a)[:2] == key(b)[:2] and key(a) != key(b) and "empty" not in a[0]
        ),
        None,
    )
    align = lambda op: [s[1] for s in op[1] + op[2]]
    return {
        "ops": [len(ref), len(ops)], "ops_differing_by_position": len(differ),
        "same_op_names_in_any_order": collections.Counter(op[0] for op in ref) == collections.Counter(op[0] for op in ops),
        "same_ops_and_bits_in_any_order": collections.Counter(map(key, ref)) == collections.Counter(map(key, ops)),
        "ops_whose_data_ptr_mod_512_differ": sum(align(a) != align(b) for a, b in zip(ref, ops)),
        "first_equal_inputs_other_outputs": None if first_out is None else entry(first_out),
        "first_difference": entry(differ[0]) if differ else None,
    }


def history_probe(tag, cr, rc, Options, dev, groups, phase, ops_out=None, linalg=None):
    """Run the named earlier phases as the full run does, then a cold and a
    warm quadruped batch with no check on them; print digests of both
    batches' solutions and of op_digests() before and after the phases,
    the lanes whose solved flags differ between the batches, and their
    first oracle or KKT call that differs (layer_digests). The first gx
    call of each batch runs under op_recorder(): the first of its aten ops
    whose inputs are alike in both batches and whose outputs differ is
    printed, and both batches' ops go to `ops_out` for a comparison with
    another process (--compare-ops). `linalg` sets
    torch.backends.cuda.preferred_linalg_library before the batches.
    Locates what makes the quadruped's float32 numbers depend on the
    process's history."""
    import torch

    label = ",".join(groups) or "none"
    before = op_digests(dev)
    for g in groups:
        phase(f"history {label}: {g}")
        if g == "kernels":
            kernel_phases(tag, cr, dev, phase)
        elif g == "flagship":
            flagship_phase(tag, cr, Options, dev)
        elif g == "rocket":
            _, captured = rocket_phase(tag, cr, rc, Options, dev)
            solve_batched_phase(tag, cr, rc, *captured["blocks"])
        elif g == "cr":
            cr_phase(tag, cr, Options, dev)
        elif g == "dense":
            dense_phase(tag, cr, Options, dev)
        else:
            fallback_fires_phase(tag, cr, Options, dev)
    after = op_digests(dev)
    changed = [k for k in before if before[k] != after[k]]
    from calipso_tpu_torch.solver import kkt

    qbts = quadruped_solver(tol_options(Options, max_iterative_refinement=2), "cuda", np.float32).batched()
    x0q = torch.tensor(quadruped_scenarios(B_QUAD).astype(np.float32), device=dev)
    layers = [(qbts.fns, a) for a in QUAD_ORACLES] + [(kkt, a) for a in KKT_LAYERS]
    if linalg is not None:
        torch.backends.cuda.preferred_linalg_library(linalg)
        print(f"{tag} history {label}: preferred linalg library {torch.backends.cuda.preferred_linalg_library()}")
    runs, calls, ops = {}, {}, {}
    for name in ("cold", "warm"):
        phase(f"history {label}: quadruped {name} batch")
        with record_first_call(qbts.fns, "gx") as ops[name], layer_digests(layers, DIGEST_CALLS) as calls[name]:
            st = qbts.solve(parameters=x0q).state
        total = st.total_i.cpu().numpy()
        runs[name] = st
        print(
            f"{tag} history {label}: quadruped {name} batch solved {int(st.solved.sum())}/{B_QUAD}, "
            f"iterations total {int(total.sum())}, lockstep {int(total.max())}"
        )
    differ = torch.nonzero(runs["cold"].solved != runs["warm"].solved)[:, 0].tolist()
    # the first layer call of the cold batch that differs from the warm one's:
    # equal arguments and another result locate the history inside the layer
    first = next(
        ({"call": i, "cold": c, "warm": w} for i, (c, w) in enumerate(zip(calls["cold"], calls["warm"])) if c != w), None
    )
    print(json.dumps({
        "history": label, "library_calls_changed": changed, "solved_flags_differ": differ,
        "first_layer_call_differing": first,
        "same_iterations": torch.equal(runs["cold"].total_i, runs["warm"].total_i),
        **{
            name: {
                "solved": int(st.solved.sum()), "total": int(st.total_i.sum()),
                "lockstep": int(st.total_i.max()),
                "x_digest": x_digest(st),
            }
            for name, st in runs.items()
        },
    }))
    print(json.dumps({"history_calls": calls}))
    print(json.dumps({"history": label, "first_gx_ops_cold_against_warm": first_op_differing(ops["warm"], ops["cold"])}))
    if ops_out:
        with open(ops_out, "w") as f:
            json.dump({"history": label, **ops}, f)


def compare_ops(ref_path, path):
    """Print first_op_differing() of the cold batches' first gx ops of two
    history probes (--ops-out files): `ref_path` a process with no earlier
    phase."""
    with open(ref_path) as f:
        ref = json.load(f)
    with open(path) as f:
        other = json.load(f)
    print(json.dumps({
        "first_gx_ops": f"cold batch of history {other['history']} against that of history {ref['history']}",
        **first_op_differing(ref["cold"], other["cold"]),
    }))


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port's main paths on one NVIDIA GPU (no arguments: every phase).")
    ap.add_argument(
        "--stream-times", action="store_true",
        help="only build, check and time the stream kernels at the quadruped's shape, float32 and float64",
    )
    ap.add_argument(
        "--history", metavar="GROUPS",
        help=f"only run these earlier phases (comma-separated of {', '.join(HISTORY_GROUPS)}; or none), "
        "then a cold and a warm quadruped batch; print digests of what came out",
    )
    ap.add_argument("--ops-out", metavar="PATH", help="with --history: write the first gx call's op digests here")
    ap.add_argument(
        "--linalg", choices=("cusolver", "magma"),
        help="with --history: torch.backends.cuda.preferred_linalg_library before the quadruped batches",
    )
    ap.add_argument(
        "--compare-ops", nargs=2, metavar=("REF", "OTHER"),
        help="only compare two --ops-out files: the first op of the cold batches' first gx call that differs",
    )
    args = ap.parse_args()
    groups = [g for g in (args.history or "").split(",") if g not in ("", "none")]
    if not set(groups) <= set(HISTORY_GROUPS):
        ap.error(f"--history: unknown phases {sorted(set(groups) - set(HISTORY_GROUPS))}")
    if args.compare_ops:  # files of earlier runs: no card needed
        compare_ops(*args.compare_ops)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from calipso_tpu_torch import Options
    from calipso_tpu_torch.ops import cuda_riccati as cr, riccati as rc

    dev = torch.device("cuda")
    card = card_line()
    tag = f"[{card}]"
    print(f"{tag} torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t_start = time.time()

    def phase(name):
        print(f"{tag} [{time.time() - t_start:.1f} s] phase {name}", flush=True)

    # 1. build
    phase("1: build")
    build_kernels(tag)
    if args.stream_times:
        stream_times(tag, cr, dev)
        return 0
    if args.history is not None:
        history_probe(tag, cr, rc, Options, dev, groups, phase, args.ops_out, args.linalg)
        return 0

    errs, times = kernel_phases(tag, cr, dev, phase)

    # 3. the flagship on the card (schur backend), counting kernel launches
    phase("3: flagship")
    launches = flagship_phase(tag, cr, Options, dev)

    # 4. the batched rocket landing on the card (riccati backend)
    phase("4: rocket")
    rlaunches, captured = rocket_phase(tag, cr, rc, Options, dev)

    # 8. the solve_batched entry point on the rocket batch's own blocks
    phase(f"8: solve_batched (the blocks of riccati factorization {min(CAPTURE_CALL, captured['calls'])} of the rocket batch)")
    blaunches = solve_batched_phase(tag, cr, rc, *captured["blocks"])
    # 9. the cr backend
    phase("9: cr backend (rocket101, its golden, the rocket batch)")
    cr_phase(tag, cr, Options, dev)
    # 10. the ldl and lu backends and the refinement fallback
    phase("10: ldl, lu and refinement_fallback (pendulum B=1024, float64)")
    dense_phase(tag, cr, Options, dev)
    phase("10: refinement_fallback firing (every 4th lane's schur factor broken)")
    fallback_fires_phase(tag, cr, Options, dev)

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
    print(
        f"{tag} quadruped cold batch (first solve, includes one-time set-up): {cold_s:.3f} s; "
        f"digest of its solution {x_digest(qres.state)}"
    )
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

    layers = [(qbts.fns, a) for a in QUAD_ORACLES] + [(kkt, a) for a in KKT_LAYERS]
    with layer_timers(layers) as spent:
        wall = warm_batches(
            tag, "quadruped", B_QUAD, qbts, lambda: qbts.solve(parameters=x0q), qst, WARM_REPS_QUAD, same_bits=True
        )
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
        "fused": "calipso_tpu_torch/csrc/riccati_fused.cu",
    }
    meta = {
        "factor_t1": ("t1", "calipso_tpu/ops/pallas_riccati.py:633", launches, ("factor_t1", "float32")),
        "solve_t1": ("t1", "calipso_tpu/ops/pallas_riccati.py:661", launches, ("solve_t1", "float32")),
        "factor_lanes": ("lanes", "calipso_tpu/ops/pallas_riccati.py:489", rlaunches, ("factor_lanes", "float32", HORIZON_ROCKET)),
        "solve_lanes": ("lanes", "calipso_tpu/ops/pallas_riccati.py:583", rlaunches, ("solve_lanes", "float32", HORIZON_ROCKET)),
        "factor_stream": ("stream", "calipso_tpu/ops/pallas_riccati.py:813", qlaunches, ("factor_stream", "float32", HORIZON_QUAD, 1)),
        "solve_fwd_stream": ("stream", "calipso_tpu/ops/pallas_riccati.py:1081", qlaunches, ("solve_fwd_stream", "float32", HORIZON_QUAD, 1)),
        "solve_bwd_stream": ("stream", "calipso_tpu/ops/pallas_riccati.py:1169", qlaunches, ("solve_bwd_stream", "float32", HORIZON_QUAD, 1)),
        "solve_batched_fused": ("fused", "calipso_tpu/ops/pallas_riccati.py:117", blaunches, ("solve_batched_fused", "float32", HORIZON_ROCKET)),
        "solve_batched_lanes": ("fused", "calipso_tpu/ops/pallas_riccati.py:245", blaunches, ("solve_batched_lanes", "float32", HORIZON_ROCKET)),
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
