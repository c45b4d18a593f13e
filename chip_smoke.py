#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (each fails loudly; none catches its own failure):
  1. build the CUDA kernels from calipso_tpu_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all started together; require ptxas to give the
     kernels that keep their rows in registers (factor_lanes and the fused
     solve up to d=32, factor_t1 and solve_t1 at every n) no stack frame
     and no spill;
  2. hold the T=1 kernels (factor_t1, solve_t1) against their plain PyTorch
     versions on the card at the flagship shape B=8192, n=32, the
     block-tridiagonal kernels (factor_lanes, solve_lanes) at the batched
     rocket's shape (B=1024, T=31, d=9), at the bench's rocket batch
     (B=128) and at the contact class's (B=256, T=8, d=54), and (2c) the
     stream kernels (factor_stream,
     solve_fwd_stream, solve_bwd_stream) at the batched quadruped's shape
     (B=128, T=8, d=54) with K=1 and K=22 right-hand sides and at
     (B=1024, T=31, d=9), in float32 and float64, with 8 lanes that are
     not positive definite (NaN on both paths, from the same stage on),
     and (2d) the fused block-tridiagonal solves (solve_batched_fused,
     solve_batched_lanes: one kernel template, batch-first and
     batch-last) at the rocket's and the quadruped's shapes and at (1024,
     31, 32), where the register kernel keeps the factor in the
     workspace, against their plain version, float32 and float64, 8 lanes
     not positive definite (NaN over all of their x), and the transpose
     kernel of the lanes wrapper's layout moves bit for bit against
     torch's permute(...).contiguous();
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
     counts zeroed just before: both must launch, and the transposes of
     the lanes wrapper's layout moves, and nothing else, and
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
     and the fused solves beside the split factor + solve pair at both,
     with the lanes wrapper's kernel alone and its layout moves (by the
     transpose kernel, and by torch's strided copies) timed alone and its
     time over the fused solve's, both at the rocket's also replayed from
     a CUDA graph (run right after phase 2);
  6. solve the bench's batched quadruped (bench.py:396-503) -- 128
     contact-implicit stance MPC problems, H=8 stages (n=400, stage
     blocks d=54, 344 equality rows, 412 cone rows), stance heights from
     U[0.02, 0.10] (default_rng(0)) as the stage-0 parameter, every
     tolerance 1e-4, max_iterative_refinement=2 -- on the card in float32
     with "auto" resolving to riccati; require the three stream kernels to
     have launched and the lanes and T=1 kernels not, at least 120 lanes
     solved and no foot of a solved lane below -1e-3; print the iteration
     counts beside the JAX reference's; re-solve the first 4 lanes on the
     CPU in float64 (checked in phase 11b, beside whose cold batch it
     runs); time a cold and a warm batch and profile the first 5 lockstep
     iterations of a warm one;
  7. solve the quadruped gait (horizon 11, travel 0.2) in float64 with
     default Options on the card -- its equality_general rows ride the
     riccati border, through solve_multi on the stream solve kernels --
     and hold it to tests/golden/quadruped_gait.npz (solved, states within
     1e-2, iterations within +-15%);
  11. the contact models, each step with the launch counts set to 0 just
     before it and read just after, each required to launch its route's
     kernels and no other: (a) the bench's hopper gait (bench.py:648-688:
     T=21, n=528, stage blocks d=26 on the lanes route, 4 equality_general
     rows on the border through solve_multi, K=4, on the stream sweeps;
     every tolerance 1e-4, central_path_initial=0.1,
     max_iterative_refinement=2), a cold and a warm float32 solve, solved,
     iterations beside the reference's, and a CPU float64 re-solve held to
     the branch rule (states within 1e-2, or the card's solution meets the
     contract in float64); (c) the hopper gait in float64 with default
     Options against tests/golden/hopper_gait.npz (states within 1e-2 and
     iterations within +-15%, or, on another local solution, the contract
     in float64 and the reference test's travel and friction); (d)
     ball-in-cup (d=12, lanes), the box move (d=33, stream) and the bunny
     hop (a flat NLP, n=110, on the T=1 kernels) in float64 with their
     reference tests' options, guesses and assertions; (b) a B=1024 hopper
     batch in float32, guesses perturbed by 0.01 N(0, 1), at least B-32
     solved, a CPU float64 re-solve of 4 lanes under the branch rule, and
     the first 5 lockstep iterations of a batch timed with per-layer host
     timers and profiled (no whole warm batch: its ~190 s went to phase
     16). Phases 2 and 5 hold and time the lanes
     kernels at (T, d) = (21, 26) and (21, 12), the stream kernels at (21,
     26) with K=4 and at (11, 33) with K=1, and the T=1 kernels' panel
     path at n = 33, 64, 65, 96, 110 (the bunny hop's) and 128, each at
     B=1024 and at the single solves' B=1, with a lane (at B=1 a system
     alone) whose only bad pivot is its last one, in the last panel;
  12. past the narrow kernels' widths (n = 128, d = 64; run after phase
     10), each step with the launch counts set to 0 just before it and
     read just after: (a) the pendulum swing-up at horizon 44 (n = 131)
     on schur in float64 with the serial line search, on the wide T=1
     kernels and no library call, held to the same solve on the CPU
     (solved, iterations within +-15%, states within 1e-3); (b) float32
     schur batches of the flagship's pendulum at the reference's widest
     resident T=1 tiles, horizon 74 (n = 221) at B = 32 and horizon 52 (n
     = 155) at B = 64: the T=1 kernels and no library call, at least B-2
     solved, a CPU float64 re-solve of 4 lanes with the same solved flags
     and states within 1e-3; (c) ops/riccati.factor, solve, solve_multi
     (K=2) and the public solve_batched on the wide stream kernels, float32
     at (128, 8, 82), (64, 8, 116) and (32, 8, 165) and float32 and
     float64 at (4, 5, 65), one lane not positive definite, held to their
     plain versions; (d) the same calls at (4, 5) one past each dtype's
     MAX_D (d = 170, 121) on the scan route, held to the CPU. Phases 2e
     and 5 hold and time the kernels at these shapes (the stream kernels
     at K=1; the T=1 pair at (1, 131), (32, 221) and (64, 155));
  13. implicit differentiation (run after phase 12), each path with the
     launch counts set to 0 just before it and read just after: (a) the
     flagship batch (B=8192, float32) with differentiate=True and its
     initial state as the parameter (p = 2): sensitivity (8192, 80, 2),
     the T=1 kernels and the K-column schur solve (two triangular solves,
     counted as solve_t1_multi_library), at least one more factor_t1
     launch than the same batch undifferentiated, the same lanes solved,
     the wall differentiation adds to a warm batch, and 16 lanes'
     sensitivity against the float64 sensitivity at the same points
     (every lane whose own error estimate, SolveResult.sensitivity_error,
     is at most 1e-5 within 1e-4) and of the same lanes solved again on
     the card; (b) the pendulum at horizon 44 (n = 131,
     "auto" -> riccati, d = 3, B=1024, float32) differentiated: the lanes
     pair and the stream sweeps at K = 2, no T=1 kernel, and the same lane
     check; (c) the differentiable solve (autograd.Function) in float64 on
     4 flagship lanes solved to 1e-10: backward() of a scalar function of
     the solution equals sens' w_bar and central differences;
  14. the applications: (a) the pendulum MPC of tests/test_mpc.py:46-60
     for 1024 scenarios near upright, 100 warm-started steps in float32:
     every lane solved at every step, every final state inside the test's
     bounds, the mean iterations after step 0 not above step 0's, on the
     T=1 kernels; (b) the cart-pole MPC auto-tuning of
     tests/test_autotuning.py:106-183 over 256 initial states in float64,
     3 gradient steps through the differentiable solve: the loss falls.
  Phase 11d also solves, in float64 with the reference tests'
  options and assertions, cyberdrift (schur at n = 286: the T=1 library
  route, the serial line search its reference test runs on the CPU), one
  solve from the reference test's guess held to its assertions or, where
  it fails (its outcome moves with the last bit), to the branch rule of
  cyberdrift_solve: every call of the library route backward stable, its
  merits within 1e-10 of the port's CPU float64 solve's over the first
  30 steps, and that CPU solve meeting the assertions; and the state-triggered rocket (T=51, d=17: the lanes kernels) (the
  quadruped drop's reference test runs in the CPU tests only:
  tests/test_torch_drop.py); phases 2e and 5 hold and
  time the kernels at the shapes phases 11d, 13 and 14 give them: the
  lanes pair at (1024, 44, 3) and (1, 51, 17), the stream kernels at
  (1024, 44, 3) with K=2 and (1, 51, 17), the T=1 pair at (256, 19).
  15. the examples (calipso_tpu_torch/examples), each through its entry
     point at its script's size in float64, with its script's assertions
     and the kernels (or library route) EXAMPLE_KERNELS predicts for it,
     the launch counts set to 0 just before each and read just after:
     nonconvex's three Solver problems (the T=1 kernels at B=1, n = 3, 2
     and 6) and batched_scenarios (B=256, n=32, all solved) in the main
     process; rocket_landing is phase 9's golden solve (cr: no kernel),
     contact_implicit's quadruped gait, hopper gait and ball-in-cup are
     the solves of phases 7, 11c and 11d; beside 11b's cold batch, the
     quadruped gait v2 (held to its golden too) and autotuning_acrobot
     (its H=31 swing-up on the lanes kernels at d=5, then its T=4 policy
     on the T=1 kernels) in a third process, mpc_autotuning in the first
     and drifting in the second (its assertions or, where the card's
     solve fails, cyberdrift_branch_rule against the port's CPU solve of
     the example); then each example's iterations and wall. Phases 2e and
     5 hold and time the kernels at the shapes the examples give them:
     the T=1 pair at (1, 2), (1, 3), (1, 6), (1, 19), (20, 19) and (256,
     32), the lanes pair at (1, 31, 5), the stream kernels at (1, 11, 54)
     with K=1 and 22 and at (1, 21, 26) with K=8.
  16. more than one rank on the one card (calipso_tpu_torch/parallel:
     mesh.launch spawns the ranks, every rank on cuda:0, gloo through
     host memory; each rank's launches counted from 0 just before its
     path and read just after): (a) the flagship batch sharded over 2
     ranks through .batched().solve(parameters=x0s, mesh=mesh), 4096
     lanes a rank, factor_t1 and solve_t1 launched on each rank, the same
     gathered bits on every rank, at least B-8 lanes solved, the same
     solved lanes as phase 3's unsharded batch up to 8 and the states of
     lanes solved in both within 1e-3; (c) on the same 2 ranks,
     parallel/dryrun in float32 (the twin of __graft_entry__'s
     dryrun_multichip): loss and gradient finite and the same bits on
     both ranks, 4/4 lanes solved, the spike solve at horizon 4 in
     riccati's iterations, the two d = 54 drop lanes solved on the stream
     kernels; (b) the pendulum at horizon 44 (n = 131, d = 3), B=256,
     float64, on linear_solver="spike" over 4 ranks (11 stages a chunk):
     factor_lanes on the chunk interiors and the separators, the stream
     sweeps on the K = 6 boundary columns and refinement's columns,
     solve_lanes on the right-hand sides, no T=1 kernel and no scan; held
     to riccati on the same batch in this process (the same solved flags
     and iterations per lane, states within 1e-8). Phases 2e and 5 hold
     and time the kernels at the shapes phase 16 gives them: the lanes
     pair at (256, 10, 3), (256, 4, 3), (1, 1, 3) (a T=1 interior, its O
     empty) and (1, 2, 3), the stream kernels at (256, 10, 3) and (1, 1,
     3) with K=6 and at (1, 8, 54) with K=1.

The solves are bound by the host's dispatch and leave the card idle most
of the time, so beside the hopper batch's cold batch (11b), and beside no
other timed window, run phases 7, 11c and 11d (float64 single solves) and
part of phase 15 in three more processes on the card (7, 11c, 11d's
first three models and the mpc_autotuning example in one, cyberdrift,
the state-triggered rocket and the drifting example in the second, the
quadruped gait v2 and the autotuning_acrobot example in the third) and the CPU float64 re-solves of the
quadruped (phase 6) and the hopper (11a, 11b) in three more; the warm
batches, profiles and single solves' walls have the card and the host to
themselves.

Prints each number with the card's name and power limit, then a JSON line
of the kernels, the `nvidia-smi` name/power line, and last
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
there is no CUDA device or the package is not beside this script.

Partial runs print no such result:
    python3 chip_smoke.py --stream-times         # phase 1, then the
        # T=1 kernels checked and timed at (8192, 32), the stream kernels
        # at (128, 8, 54) with K=1 and K=22, the lanes kernels at
        # (1024, 31, 9) and (128, 31, 9), and the fused solves beside the
        # split pair at (1024, 31, 9) and (128, 8, 54), in float32 and
        # float64, the T=1, lanes, stream and fused kernels also replayed
        # from a CUDA graph, and the two stream sweeps across d = 50..58
        # (copied into another checkout, times that one's kernels)
    python3 chip_smoke.py --t1-times             # phase 1, then the
        # T=1 kernels checked and timed at n = 33, 64, 65, 96, 110, 128 and
        # B = 1024, 1, float32 and float64, and at phase 12's (1, 131),
        # (32, 221) and (64, 155), host-launched and replayed, beside
        # plain, cholesky_ex / cholesky_solve and the bound, with their
        # layout (copied into a `git archive` of another commit, times that
        # one's kernels: run parent, change, change, parent)
    python3 chip_smoke.py --batched-times        # phase 1, then the two
        # fused solves (and the lanes wrapper's kernel and layout moves) at
        # (1024, 31, 9) and (128, 8, 54), float32 and float64, and at the
        # first replayed from a CUDA graph: the parent/change A/B of the
        # fused solves, copied into a `git archive` of the parent
    python3 chip_smoke.py --sass                 # no card needed: compile
        # csrc/riccati_fused.cu to a cubin for sm_90a, disassemble it, and
        # print each solve_batched_reg_kernel instantiation's static
        # instructions and outermost loops (the stage loops)
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
# the bench's own rocket batch (bench.py:530-596), which leaves most SMs
# without a lane on the lanes route
B_ROCKET_BENCH = 128
LANES_SHAPES = ((B_ROCKET, HORIZON_ROCKET, 9), (B_ROCKET_BENCH, HORIZON_ROCKET, 9), (256, 8, 54))
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
QUAD_STREAM_KERNELS = ("factor_stream", "solve_fwd_stream", "solve_bwd_stream")
# one warm quadruped batch (it must repeat the cold batch's bits): the
# contact phases (11) take half of the script's time limit
WARM_REPS_QUAD = 1
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
# where the fused solves' register kernel (d <= 32) keeps the horizon's
# factor in the workspace, not in shared memory
FUSED_WORKSPACE_SHAPES = ((B_ROCKET, HORIZON_ROCKET, 32),)
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

# phase 11: the contact models. The hopper gait (bench.py:648-688; T=21,
# n=528, stage blocks d=26 on the lanes route, its 4-row border through
# solve_multi on the stream sweeps) once, as a B=1024 batch (one warp a
# lane on the lanes route: 128 lanes would leave most SMs idle) and on its
# float64 golden; ball-in-cup (d=12), the box move (d=33, the stream
# route) and the bunny hop (a flat NLP, n=110, on the T=1 kernels) in
# float64 as their reference tests run them
HORIZON_HOPPER = 21
# the CPU float64 re-solves of phases 6, 11a and 11b run in three
# background processes of CPU_REF_THREADS torch threads each, beside the
# hopper batch's cold batch and not beside any timed window; they leave
# two cores to the two processes driving the card
CPU_REF_THREADS = 2
B_HOPPER = 1024
MIN_SOLVED_HOPPER = B_HOPPER - 32
CPU_LANES_HOPPER = 4
JAX_HOPPER_ITERATIONS = 53  # README.md:390: the bench's single solve (a TPU run)
PROFILE_ITERS_HOPPER = 5
GOLDEN_HOPPER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "hopper_gait.npz")
GOLDEN_BAND = 0.15  # tests/test_golden.py:_iteration_band
# the kernels each contact path must launch; every other kernel must not
HOPPER_KERNELS = ("factor_lanes", "solve_lanes", "solve_fwd_stream", "solve_bwd_stream")
CONTACT_KERNELS = {
    "hopper gait": HOPPER_KERNELS,
    "ball-in-cup": ("factor_lanes", "solve_lanes"),
    "box move": ("factor_stream", "solve_fwd_stream", "solve_bwd_stream"),
    "bunny hop": ("factor_t1", "solve_t1"),
}
# the kernels at the contact paths' shapes (phases 2 and 5), each at the
# hopper batch's B and at B=1, the single solves' (11a, 11c, 11d): the
# lanes pair at the hopper's (T, d) and ball-in-cup's, the stream sweeps
# at the hopper border's K=4 and the stream kernels at the box's. B=1
# leaves no room for a lane that is not positive definite beside one that
# is: those checks take none (the T=1 pair checks a failing system alone)
B_CONTACT = 1024
# and the shapes the paths of phases 11d, 13 and 14 give the kernels: the
# differentiated pendulum batch at horizon 44 (B=1024, T=44, d=3: the lanes
# pair, and the stream sweeps with its K=2 parameter columns) and the
# state-triggered rocket's single solve (B=1, T=51, d=17: the lanes pair;
# the stream pair there at K=1 too)
B_DIFF, HORIZON_DIFF = 1024, 44
APP_LANES_SHAPES = ((B_DIFF, HORIZON_DIFF, 3), (1, 51, 17))
APP_STREAM_SHAPES = ((B_DIFF, HORIZON_DIFF, 3, 2), (1, 51, 17, 1))
CONTACT_LANES_SHAPES = tuple((B, HORIZON_HOPPER, d) for d in (26, 12) for B in (B_CONTACT, 1)) + APP_LANES_SHAPES
CONTACT_STREAM_SHAPES = tuple(
    (B, T, d, K) for T, d, K in ((HORIZON_HOPPER, 26, 4), (11, 33, 1)) for B in (B_CONTACT, 1)
) + APP_STREAM_SHAPES
# the T=1 pair's panel kernels (n in 33..128) at the panels' edges and the
# bunny hop's n=110, each at B=1024 and B=1
WIDE_T1_SHAPES = tuple((B, n) for n in (33, 64, 65, 96, 110, 128) for B in (B_CONTACT, 1))
# the T=1 pair at the cart-pole tuning's width (phase 14: B=256, n=19)
B_TUNE = 256
APP_T1_SHAPES = ((B_TUNE, 19),)
# phase 12: past the narrow kernels' widths (n = 128, d = 64), where the
# reference still runs a Pallas kernel in float32 (its _use_pallas; the
# cover is tests/test_torch_wide_routes.py): (a) the pendulum swing-up at
# horizon 44 (n = 131) on schur in float64, one solve, on the wide T=1
# kernels; (b) float32 schur batches at the reference's widest resident
# T=1 tiles, horizon 74 (n = 221) at B = 32 and horizon 52 (n = 155) at B
# = 64, at least B - WIDE_SOLVED_MARGIN solved and a CPU float64 re-solve
# of CPU_LANES_RESOLVE lanes within WIDE_CPU_ATOL; (c) ops/riccati's
# factor, solve, solve_multi (K = 2) and the public solve_batched on the
# stream kernels past d = 64, at the reference's widest float32 stream
# shapes (B a multiple of 128, 64 and 32) and one float64 shape; (d) the
# scan one past each dtype's MAX_D, at (SCAN_B, SCAN_T)
HORIZON_WIDE = 44
WIDE_SCHUR_BATCHES = ((74, 32), (52, 64))  # (horizon, B)
WIDE_SOLVED_MARGIN, WIDE_CPU_ATOL = 2, 1e-3
WIDE_STREAM_SHAPES = (
    ((128, 8, 82), ("float32",)), ((64, 8, 116), ("float32",)), ((32, 8, 165), ("float32",)),
    ((4, 5, 65), ("float32", "float64")),
)
SCAN_B, SCAN_T = 4, 5
WIDE_ROUTE_KERNELS = {
    "pendulum n=131": ("factor_t1", "solve_t1"),
    "pendulum n=221 batch": ("factor_t1", "solve_t1"),
    "pendulum n=155 batch": ("factor_t1", "solve_t1"),
}
# phases 13, 14 and 11d's additions: the kernels (and library routes) each
# path must launch, and no other. Implicit differentiation's K-column
# solve takes the stream sweeps on riccati and two triangular solves on
# schur (ops/riccati.chol_solve_multi, as the reference takes them)
APP_KERNELS = {
    "flagship differentiated": ("factor_t1", "solve_t1", "solve_t1_multi_library"),
    "pendulum n=131 differentiated": ("factor_lanes", "solve_lanes", "solve_fwd_stream", "solve_bwd_stream"),
    "differentiable solve": ("factor_t1", "solve_t1", "solve_t1_multi_library"),
    "pendulum MPC": ("factor_t1", "solve_t1"),
    "cart-pole tuning": ("factor_t1", "solve_t1", "solve_t1_multi_library"),
    "cyberdrift": ("factor_t1_library", "solve_t1_library"),
    "state-triggered rocket": ("factor_lanes", "solve_lanes"),
}
# phase 11d: cyberdrift's branch rule (cyberdrift_solve). Its card solve
# is held step by step against the port's CPU float64 solve from the same
# guess: their merits within CYBER_FOLLOW_RTOL over the first
# CYBER_FOLLOW_STEPS steps (on the CPU the port follows the reference to
# 7.8e-13 over those steps and the two are 1e-6 apart at step 56:
# tests/test_torch_models.py); "parted" past CYBER_PART_RTOL. Every call
# of the library route in its run is held to a normwise backward error of
# CYBER_BACKWARD_TOL in float64 (n = 286: n eps = 3.2e-14), and a factor
# that reports a lane not positive definite to a least eigenvalue under
# CYBER_BACKWARD_TOL times the matrix's Frobenius norm
CYBER_FOLLOW_STEPS, CYBER_FOLLOW_RTOL, CYBER_PART_RTOL = 30, 1e-10, 1e-6
CYBER_BACKWARD_TOL = 1e-12
# phase 13: 16 lanes' float32 sensitivity against the float64 sensitivity
# at the same points (every lane whose own error estimate,
# SolveResult.sensitivity_error, is at most DIFF_TRUST within DIFF_RTOL, and
# the median lane within DIFF_RTOL) and against the float64 solve's of the
# same lanes (the median lane within DIFF_SOLVE_RTOL). The condensed system
# has condition ~1e5 at a solution (rho = 1e5): unrefined, the float32
# columns were 3.0% (flagship) and 7% (the median lane at horizon 44) off
# on the card; refined on the 6-block operator (solver/differentiate.py),
# 1.9e-7 and 4.9e-6 (the median lanes). A lane whose estimate is over
# DIFF_TRUST (a tenth of DIFF_RTOL: on the CPU the estimate is within 3x of
# the error) is one the port itself reports untrustworthy: it is printed
# with its error, estimate and largest entries, not held to a limit
DIFF_LANES = 16
DIFF_RTOL, DIFF_SOLVE_RTOL = 1e-4, 1e-3
DIFF_TRUST = DIFF_RTOL / 10
# the differentiable solve against central differences of float64 solves
# to 1e-10 on 4 lanes: the sensitivity is that of the regularized system
# (eps 1e-7), 9.4e-5 off the differences on the CPU
DIFF_FD_LANES, DIFF_FD_EPS, DIFF_FD_RTOL = 4, 1e-6, 1e-3
# phase 14: the pendulum MPC of tests/test_mpc.py:46-60 for B_MPC scenarios
# near upright (theta - pi and omega each U(-0.3, 0.3), default_rng(0);
# the test's one scenario is (-0.4, 0.3)), MPC_STEPS steps, float32, and
# the test's bounds on the final state
B_MPC, MPC_STEPS = 1024, 100
MPC_BOUNDS = (0.01, 0.02)
# the cart-pole tuning of tests/test_autotuning.py:106-183 over B_TUNE
# initial states (the test's plus 0.05 N(0, 1), default_rng(0)), float64
# (the test's tolerances are 1e-6), max_iterations=3
TUNE_ITERATIONS = 3

# phase 15: the port's examples (calipso_tpu_torch/examples), each through
# its entry point at its script's size, in float64 on the card: the kernels
# (and library routes) each must launch, and no other (the cr route and
# cyberdrift's n = 286 launch no kernel). The rocket landing, the hopper
# gait, ball-in-cup and the quadruped gait are the solves of phases 9, 11c,
# 11d and 7, which run them through the examples; phase 15 reads them
T1_KERNELS = ("factor_t1", "solve_t1")
TUNING_KERNELS = T1_KERNELS + ("solve_t1_multi_library",)
EXAMPLE_KERNELS = {
    "nonconvex wachter": T1_KERNELS,
    "nonconvex maratos": T1_KERNELS,
    "nonconvex complementarity": T1_KERNELS,
    "batched_scenarios": T1_KERNELS,
    "rocket_landing": (),
    "contact_implicit hopper": HOPPER_KERNELS,
    "contact_implicit ball": ("factor_lanes", "solve_lanes"),
    "contact_implicit quadruped": QUAD_STREAM_KERNELS,
    "contact_implicit quadruped_v2": QUAD_STREAM_KERNELS,
    "drifting": ("factor_t1_library", "solve_t1_library"),
    "mpc_autotuning": TUNING_KERNELS,
    # the H=31 swing-up on the lanes route (d = 5), then the T=4 policy's
    # differentiated solves on the T=1 kernels
    "autotuning_acrobot": ("factor_lanes", "solve_lanes") + TUNING_KERNELS,
}
B_SCENARIOS = 256
# the (kernel, shape) pairs phase 15's examples give the kernels (counted
# on an H100), which phases 2e and 5 hold and time: the T=1 pair at
# nonconvex's n = 2, 3 and 6 (B=1), the tuned MPC policies' n = 19 (B=1;
# their differentiated solves' solve_t1 at B=20, one lane a parameter) and
# batched_scenarios' (256, 32); the lanes pair at the acrobot swing-up's
# (1, 31, 5); the stream kernels at the quadruped gaits' (1, 11, 54) with
# K=1 and their border's K=22, and the sweeps at the hopper gait's border,
# K=8 at B=1
EXAMPLE_T1_SHAPES = ((1, 2), (1, 3), (1, 6), (1, 19), (20, 19), (B_SCENARIOS, 32))
EXAMPLE_LANES_SHAPES = ((1, 31, 5),)
EXAMPLE_STREAM_SHAPES = ((1, 11, 54, 1), (1, 11, 54, 22), (1, HORIZON_HOPPER, 26, 8))
# phase 16: more than one rank on the one card (parallel/mesh.launch, gloo
# through host memory). 16a: the flagship batch sharded over SHARD_RANKS
# ranks through mesh=, against phase 3's unsharded batch (the same solved
# lanes up to MIN_SOLVED margin, the states of lanes solved in both within
# CPU_ATOL_FLAG); 16b: the pendulum at horizon 44 (n = 131, d = 3) in
# float64 on linear_solver="spike" over SPIKE_RANKS ranks (chunks of 11
# stages), B_SPIKE lanes, against riccati on the same batch on the card
# (the same solved flags and iterations per lane, states within
# SPIKE_ATOL); 16c: parallel/dryrun over DRYRUN_RANKS ranks in float32
SHARD_RANKS, SPIKE_RANKS, DRYRUN_RANKS = 2, 4, 2
B_SPIKE, SPIKE_ATOL = 256, 1e-8
PARALLEL_KERNELS = {
    "flagship sharded": T1_KERNELS,
    "pendulum n=131 spike": ("factor_lanes", "solve_lanes", "solve_fwd_stream", "solve_bwd_stream"),
    "dryrun batch": T1_KERNELS + ("solve_t1_multi_library",),
    "dryrun spike": ("factor_lanes", "solve_lanes", "solve_fwd_stream", "solve_bwd_stream"),
    "dryrun contact": QUAD_STREAM_KERNELS,
}
# the shapes phase 16 gives the kernels, which phases 2e and 5 hold and
# time: 16b's chunk interior (10 stages), its 4 separators and the K = 2d
# boundary columns on the interior; 16c's spike solve over 2 ranks at
# horizon 4 (a 2-stage chunk's T=1 interior with an empty O, its 2
# separators, K = 6) and its drop lanes (one lane, 8 x 54, K=1)
SPIKE_LANES_SHAPES = (
    (B_SPIKE, HORIZON_DIFF // SPIKE_RANKS - 1, 3), (B_SPIKE, SPIKE_RANKS, 3), (1, 1, 3), (1, DRYRUN_RANKS, 3),
)
SPIKE_STREAM_SHAPES = ((B_SPIKE, HORIZON_DIFF // SPIKE_RANKS - 1, 3, 6), (1, 1, 3, 6), (1, 8, 54, 1))
GOLDEN_GAIT_V2 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "quadruped_gait_v2.npz")


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


def graph_ms(fn, reps):
    """Mean milliseconds per call of fn() replayed from one CUDA graph of
    `reps` calls (CUDA events around 5 replays): the device's time without
    the host's cost of each call, which cuda_ms counts where the host is
    the slower of the two."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    return cuda_ms(g.replay, 5) / reps


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


def example_summary(out, launches, phase, keys=()):
    """What phase 15 reads of an example's run in an earlier phase (plain
    numbers, to cross a process): solved, iterations, wall, its launches,
    the phase, and the outcomes `keys` the example prints."""
    return {
        "solved": out["solved"], "iterations": out["iterations"], "seconds": out["seconds"],
        "launches": launches, "phase": phase, **{k: out[k] for k in keys},
    }


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
        pairs = [("factor_lanes", L, Lp, stage_ok), ("factor_lanes M", M, Mp, stage_ok[:, :-1])][: 2 if T > 1 else 1]
        for kname, got, ref, ok in pairs + [("solve_lanes", x, xp, stage_ok.all(-1))]:
            abs_err = float((got[ok].double() - ref[ok].double()).abs().max())
            rel_err = abs_err / float(ref[ok].double().abs().max())
            errs[(kname, name, B, T, d)] = abs_err
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
    and 8 lanes whose middle (or 15th) stage is negated (none below 8
    lanes)."""
    rng = np.random.default_rng(T * 100 + d + 1000 * (K - 1))
    A = rng.normal(size=(B, T, d, d))
    D64 = A @ np.swapaxes(A, -1, -2) + d * np.eye(d)
    O64 = 0.3 * rng.normal(size=(B, T - 1, d, d))
    bad_stage = 15 if T > 15 else min(4, T - 1)
    bad_lanes = np.linspace(0, B - 1, 8).astype(int) if B >= 8 else np.zeros(0, int)
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


def check_stream(tag, cr, dev, B, T, d, K, errs, times=None, times64=None, dtypes=("float32", "float64")):
    """factor_stream, solve_fwd_stream and solve_bwd_stream against their
    plain versions at (B, T, d) with K right-hand sides, float32 and
    float64 (those of them in `dtypes`); each sweep is given the same
    inputs on both paths (the plain factor, then the plain forward sweep's
    u). Into `times` and `times64`, when given, the float32 and the float64
    kernel, plain and bound times."""
    import torch

    D64, O64, b64, bad_stage, bad_lanes = tridiag_inputs(B, T, d, K)
    shape = f"B={B} T={T} d={d} K={K}"
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        if name not in dtypes:
            continue
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
        pairs = [("factor_stream", L, Lp, stage_ok), ("factor_stream M", M, Mp, stage_ok[:, :-1])][: 2 if T > 1 else 1]
        for kname, got, ref, ok in pairs + [("solve_fwd_stream", u, up, lanes_ok), ("solve_bwd_stream", x, xp, lanes_ok)]:
            rel_check(tag, kname, name, shape, got, ref, ok, errs, (kname, name, B, T, d, K))
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
    """--stream-times: the T=1 kernels checked and timed at the flagship's
    (B, n), the stream kernels at the quadruped's (B, T, d) with K=1 and
    K=22 right-hand sides, the lanes kernels at the rocket's (B, T, d) with
    B = 1024 and the bench's 128, the fused solves beside the split pair
    at the rocket's and the quadruped's (batched_timed_at), float32 and
    float64, the graph replays (graph_times) and the sweeps across d
    (sweeps_across_d)."""
    times, times64 = {}, {}
    check_t1(tag, cr, dev, {}, times, times64)
    for name, into in (("float32", times), ("float64", times64)):
        print_times(tag, into, name, f"B={B_FLAG} n=32")
    for B, T, d, K in STREAM_SHAPES[:2]:
        times, times64 = {}, {}
        check_stream(tag, cr, dev, B, T, d, K, {}, times, times64)
        for name, into in (("float32", times), ("float64", times64)):
            print_times(tag, into, name, f"B={B} T={T} d={d} K={K}")
    for B, T, d in LANES_SHAPES[:2]:
        times, times64 = {}, {}
        check_lanes(tag, cr, dev, B, T, d, {}, times, times64)
        for name, into in (("float32", times), ("float64", times64)):
            print_times(tag, into, name, f"B={B} T={T} d={d}")
    for B, T, d in BATCHED_SHAPES:
        times, times64 = {}, {}
        batched_timed_at(tag, cr, dev, B, T, d, times, times64)
        print_times(tag, times64, "float64", f"B={B} T={T} d={d}")
    graph_times(tag, cr, dev)
    sweeps_across_d(tag, cr, dev)


GRAPH_ROUTES = ("T=1", "lanes", "stream", "fused")


def graph_cases(routes=GRAPH_ROUTES):
    """graph_times' default cases: the T=1 and the lanes kernels at the
    shapes stream_times checks, the stream kernels at the quadruped's
    (K=1) and the two fused solves at the rocket's (of these, the
    `routes`), as (route, shape, input arrays)."""
    n = 32
    S64, b64 = t1_inputs(n)
    cases = [("T=1", f"B={B_FLAG} n={n}", (S64, b64))]
    cases += [("lanes", f"B={B} T={T} d={d}", tridiag_inputs(B, T, d, 1)) for B, T, d in LANES_SHAPES[:2]]
    B, T, d, K = STREAM_SHAPES[0]
    cases.append(("stream", f"B={B} T={T} d={d} K={K}", tridiag_inputs(B, T, d, K)))
    B, T, d = BATCHED_SHAPES[0]
    D64, O64, b64, bad_stage, bad_lanes = tridiag_inputs(B, T, d, 1)
    D64[bad_lanes, bad_stage] *= -1.0  # back to positive definite, as batched_timed_at times it
    cases.append(("fused", f"B={B} T={T} d={d}", (D64, O64, b64)))
    return [case for case in cases if case[0] in routes]


def graph_times(tag, cr, dev, routes=GRAPH_ROUTES, cases=None):
    """The kernels of `cases` (graph_cases(routes) unless given; a case
    (route, shape, arrays, dtypes) only in `dtypes`), timed as
    one CUDA graph of 50 calls (graph_ms) beside the same 50 calls from
    the host (cuda_ms), float32 and float64: where the two differ, the
    host sets cuda_ms. Returns {(kernel, dtype name, shape): (graph ms,
    host-launched ms)}."""
    import torch

    cases = graph_cases(routes) if cases is None else cases
    out = {}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        for route, shape, arrays, *only in cases:
            if only and name not in only[0]:
                continue
            if route == "T=1":
                S, b = (torch.tensor(a, dtype=dtype, device=dev) for a in arrays)
                L = cr.factor_t1(S)
                fns = {"factor_t1": lambda: cr.factor_t1(S), "solve_t1": lambda: cr.solve_t1(L, b)}
            else:
                D, O, b = (torch.tensor(a, dtype=dtype, device=dev) for a in arrays[:3])
                if route == "fused":
                    b = b[..., 0].contiguous()
                    fns = {k: (lambda k=k: getattr(cr, k)(D, O, b)) for k in BATCHED_KERNELS}
                elif route == "lanes":
                    b = b[..., 0].contiguous()
                    L, M = cr.factor_lanes(D, O)
                    fns = {"factor_lanes": lambda: cr.factor_lanes(D, O), "solve_lanes": lambda: cr.solve_lanes(L, M, b)}
                else:
                    L, M = cr.factor_stream(D, O)
                    u = cr.solve_fwd_stream(L, M, b)
                    fns = {
                        "factor_stream": lambda: cr.factor_stream(D, O),
                        "solve_fwd_stream": lambda: cr.solve_fwd_stream(L, M, b),
                        "solve_bwd_stream": lambda: cr.solve_bwd_stream(L, M, u),
                    }
            for kname, fn in fns.items():
                gms, hms = out[(kname, name, shape)] = graph_ms(fn, 50), cuda_ms(fn, 50)
                print(f"{tag} {kname} {name} {shape}: graph {gms:.4f} ms a call, host-launched {hms:.4f} ms a call")
    return out


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


def library_times(cr, dev, B, T, d, K=1):
    """The library yardsticks of the block-tridiagonal kernels at (B, T, d),
    float32, every lane positive definite, K right-hand sides: one
    PyTorch call on the assembled dense (B, Td, Td) matrices (O((Td)^3)
    work where the kernels do O(T d^3)), milliseconds by CUDA events. The
    port never calls them."""
    import torch

    D64, O64, b64, bad_stage, bad_lanes = tridiag_inputs(B, T, d, K)
    D64[bad_lanes, bad_stage] *= -1.0  # back to positive definite
    D, O, b = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (D64, O64, b64))
    S = dense_tridiag(D, O)
    F = dense_factor(*cr.factor_stream_plain(D, O))
    FT = F.mT.contiguous()
    bv = b.reshape(B, T * d, K)
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


def check_batched(tag, cr, dev, B, T, d, errs, kernels=BATCHED_KERNELS):
    """The fused solves (`kernels`) against solve_batched_plain at (B, T,
    d) in float32 and float64, with 8 lanes not positive definite from the
    middle stage on (NaN over all of their x on every path); each
    wrapper's launch counter must move by one."""
    import torch

    D64, O64, b64, bad_stage, bad_lanes = tridiag_inputs(B, T, d, 1)
    shape = f"B={B} T={T} d={d}"
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        D, O, b = (torch.tensor(a, dtype=dtype, device=dev) for a in (D64, O64, b64[..., 0]))
        before = dict(cr.LAUNCHES)
        got = {k: getattr(cr, k)(D, O, b) for k in kernels}
        torch.cuda.synchronize()
        moved = {k: cr.LAUNCHES[k] - before[k] for k in kernels}
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
            rel_check(tag, kname, name, shape, x, xp, ok, errs, (kname, name, B, T, d))
        print(f"{tag} batched solves {name} {shape}: NaN over all of lanes {bad_lanes.tolist()} (stage {bad_stage}), on every path")


def layout_moves(cr, D, O, b, plain=False):
    """solve_batched_lanes' layout moves alone: the batch-last copies of D,
    O' and b and x's way back (here b's), by the transpose kernel or, where
    `plain`, by torch's strided copies (permute(...).contiguous())."""
    if plain:
        D.permute(1, 2, 3, 0).contiguous()
        O.permute(1, 3, 2, 0).contiguous()
        return b.permute(1, 2, 0).contiguous().permute(2, 0, 1).contiguous()
    return cr.batch_first(cr.batch_last(D, O, b)[2])


def transpose_bound(B, T, d, dtype="float32"):
    """bound() of solve_batched_lanes' layout moves: D, O, b and x each read
    once and written once."""
    return bound(2 * (T * d * d + (T - 1) * d * d + 2 * T * d) * WORD[dtype] * B, 0, dtype)


def batched_timed_at(tag, cr, dev, B, T, d, times=None, times64=None):
    """The fused solves, the split factor + solve pair of the route
    ops/riccati.route takes at d (float32), the plain version, and the
    lanes wrapper's parts (its kernel alone and its layout moves by the
    transpose kernel and by torch's strided copies, where the checkout has
    them), timed side by side at (B, T, d), every lane positive definite,
    in float32 and, where `times64` is given, float64. The lanes wrapper's
    time includes its layout moves. Into `times` and `times64`, when given,
    the kernel, plain and bound times of the two fused solves and of the
    layout moves ("transpose")."""
    import torch
    from calipso_tpu_torch.ops.riccati import route

    D64, O64, b64, bad_stage, bad_lanes = tridiag_inputs(B, T, d, 1)
    D64[bad_lanes, bad_stage] *= -1.0  # back to positive definite
    shape = f"B={B} T={T} d={d}"
    for name, dtype, into in (("float32", torch.float32, times), ("float64", torch.float64, times64)):
        if name == "float64" and into is None:
            break
        D, O, b = (torch.tensor(a, dtype=dtype, device=dev) for a in (D64, O64, b64[..., 0]))
        runs = [
            ("solve_batched_fused", lambda: cr.solve_batched_fused(D, O, b)),
            ("solve_batched_lanes", lambda: cr.solve_batched_lanes(D, O, b)),
        ]
        if name == "float32":
            if route(d, torch.float32, T) == "stream":
                split_name, split = "factor_stream + solve_stream", lambda: cr.solve_stream(*cr.factor_stream(D, O), b)
            else:
                split_name, split = "factor_lanes + solve_lanes", lambda: cr.solve_lanes(*cr.factor_lanes(D, O), b)
            runs.append((split_name, split))
        bms, by = batched_bound(B, T, d, name)
        plain_ms = cuda_ms(lambda: cr.solve_batched_plain(D, O, b), 10)
        measured = {}
        for kname, fn in runs:
            measured[kname] = ms = cuda_ms(fn, 50)
            print(
                f"{tag} {kname} {name} {shape}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bms * 1e3:.2f} us ({by}), {100.0 * bms / ms:.2f}% of the bound"
            )
        lanes, fused = measured["solve_batched_lanes"], measured["solve_batched_fused"]
        # the wrapper's parts replayed from a CUDA graph: their device times,
        # which host-launched calls of a few launches each do not show
        moves_plain = graph_ms(lambda: layout_moves(cr, D, O, b, plain=True), 50)
        parts = f"layout moves by torch's strided copies {moves_plain:.4f} ms"
        if hasattr(cr, "batch_first"):  # a checkout from before them has neither
            moves = graph_ms(lambda: layout_moves(cr, D, O, b), 50)
            Dl, OTl, bl = cr.batch_last(D, O, b)
            xl = torch.empty_like(bl)
            alone = graph_ms(lambda: cr._solve_fused("solve_batched_lanes", Dl, OTl, bl, xl, B, T, d), 50)
            tms, tby = transpose_bound(B, T, d, name)
            parts = (
                f"kernel alone {alone:.4f} ms; layout moves by the transpose kernel {moves:.4f} ms "
                f"(bound {tms * 1e3:.2f} us, {100.0 * tms / moves:.1f}% of it), " + parts
            )
            if into is not None:
                into["transpose"] = (moves, moves_plain, None, (tms, tby))
        print(
            f"{tag} solve_batched_lanes {name} {shape}, replayed from a CUDA graph: {parts}; host-launched, "
            f"the wrapper {lanes:.4f} ms, {lanes / fused:.3f}x the time of solve_batched_fused"
        )
        if name == "float32":
            print(
                f"{tag} fused against split at {shape}: solve_batched_fused "
                f"{fused / measured[split_name]:.3f}x the time of {split_name}"
            )
        if into is not None:
            for k in BATCHED_KERNELS:
                into[k] = (measured[k], plain_ms, None, (bms, by))


def check_transpose(tag, cr, dev, B, T, d, errs):
    """The transpose kernel (solve_batched_lanes' layout moves) against its
    plain version at (B, T, d), float32 and float64: batch_last and
    batch_first bit for bit, one launch each."""
    import torch

    D64, O64, b64, _, _ = tridiag_inputs(B, T, d, 1)
    shape = f"B={B} T={T} d={d}"
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        D, O, b = (torch.tensor(a, dtype=dtype, device=dev) for a in (D64, O64, b64[..., 0]))
        before = cr.LAUNCHES["transpose"]
        got = cr.batch_last(D, O, b)
        back = cr.batch_first(got[2])
        torch.cuda.synchronize()
        moved = cr.LAUNCHES["transpose"] - before
        check(moved == 2, f"transpose {name} {shape}: {moved} launches")
        want = cr.batch_last_plain(D, O, b)
        err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want) if w.numel())
        errs[("transpose", name, B, T, d)] = err
        print(f"{tag} transpose {name} {shape}: batch-last copies and the way back, max_abs_err {err:.3e} (must be 0)")
        check(
            all(torch.equal(g, w) for g, w in zip(got, want)) and torch.equal(back, b),
            f"transpose {name} {shape}: a copy differs from its plain version",
        )


def solve_batched_phase(tag, cr, rc, D, O):
    """The solve_batched entry point and its lanes variant on blocks one of
    the rocket batch's riccati factorizations received, with a seeded
    right-hand side, counts zeroed just before: both kernels and the lanes
    wrapper's transposes must launch and nothing else, and both solutions must agree with ops/riccati's
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
    path = BATCHED_KERNELS + ("transpose",)  # the lanes wrapper's layout moves
    check(all(launches[k] > 0 for k in path), f"a kernel of the fused solves never launched: {launches}")
    check(all(v == 0 for k, v in launches.items() if k not in path), f"another kernel launched: {launches}")
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
    default Options on its golden (the rocket_landing example), and the
    batched rocket (B=1024) in float32 with a CPU float64 re-solve of 4
    lanes. Returns the example's summary (example_summary)."""
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

    # the golden solve is the rocket_landing example's (its options are
    # Options(linear_solver="cr")'s, its guess rocket101_solver's)
    from calipso_tpu_torch.examples import rocket_landing

    gold = np.load(GOLDEN_ROCKET101)
    zero_launches(cr)
    ex = rocket_landing.main(dev)
    launches = dict(cr.LAUNCHES)
    gts, gr = ex["solver"], ex["result"]
    gz = gr.variables.cpu().numpy()
    states = np.concatenate(gts._state_indices)
    gap = float(np.abs(gz[states] - gold["variables"][states]).max())
    giters, gref = int(gr.iterations), int(gold["iterations"])
    print(
        f"{tag} rocket101 on cr (float64, the rocket_landing example): solved {bool(gr.solved)}, iterations {giters} "
        f"(golden {gref}, limit +-2), max state gap to the golden {gap:.3e} (limit 1e-3), {ex['seconds']:.2f} s"
    )
    check(gr.variables.dtype == torch.float64 and gts.solver.options.linear_solver == "cr", "rocket101 example: dtype or backend")
    check(bool(gr.solved) and gap <= 1e-3 and abs(giters - gref) <= 2, "rocket101 on cr misses its golden")
    example = example_summary(ex, launches, "9", ("final_position_error", "min_cone_margin"))

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
    return example


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


def hopper_solver(options, device):
    """The hopper gait (bench.py:648-688, T=21) as a TrajOptSolver."""
    from calipso_tpu_torch import TrajOptSolver
    from calipso_tpu_torch.models import hopper

    prob = hopper.gait_problem(horizon=HORIZON_HOPPER)
    kw = {k: v for k, v in prob.items() if k not in ("state_guess", "state_initial", "action_guess")}
    ts = TrajOptSolver(options=options, device=device, **kw)
    ts.initialize_states(prob["state_guess"])
    ts.initialize_actions(prob["action_guess"])
    return ts


def check_route(tag, name, launches):
    """The kernels CONTACT_KERNELS (or WIDE_ROUTE_KERNELS, APP_KERNELS,
    EXAMPLE_KERNELS, PARALLEL_KERNELS) names for the path `name` launched,
    and no other kernel did."""
    want = {**CONTACT_KERNELS, **WIDE_ROUTE_KERNELS, **APP_KERNELS, **EXAMPLE_KERNELS, **PARALLEL_KERNELS}[name]
    print(f"{tag} kernel launches in the {name} run: {launches}")
    check(all(launches[k] > 0 for k in want), f"{name}: a kernel of its route never launched: {launches}")
    off = {k: v for k, v in launches.items() if k not in want and v}
    check(not off, f"{name}: kernels off its route launched: {off}")


def hopper_gait_checks(ts, x):
    """Per lane of x (B, n): the travel x_T[0] - x_1[0] and the least
    friction-cone margin beta_1 - |beta_2| of both contacts over every
    action (what tests/test_contact.py:test_hopper_gait asserts)."""
    import torch

    travel = x[:, ts._state_indices[-1][0]] - x[:, ts._state_indices[0][0]]
    U = torch.stack([x[:, idx] for idx in ts._action_indices], dim=1)
    margin = torch.minimum(U[..., 6] - U[..., 7].abs(), U[..., 8] - U[..., 9].abs()).amin(dim=1)
    return travel, margin


def contract_met(st, opts):
    """tests/test_solver_nlp.py:assert_contract on one solve's state."""
    return (
        bool(st.solved)
        and float(st.residual_violation) < opts.residual_tolerance
        and float(st.slack_violation) < opts.slack_tolerance
        and float(st.equality_violation) <= opts.equality_tolerance
        and float(st.cone_product_violation) <= opts.complementarity_tolerance
    )


def hopper_resolve(tag, name, cpu_ts, x, solved, iters, ref):
    """The branch rule for the hopper's lanes: a lane solved on the card
    either lands within CPU_ATOL_QUAD of its CPU float64 re-solve (`ref`,
    hopper_cpu_reference's arrays over the same lanes), or, on another
    local solution or where the re-solve did not solve, its solution
    evaluated in float64 meets the equality rows and the cones to
    BRANCH_TOL. The hopper's solution depends on the last bits of its
    guess (a float64 reference solve from the guess scaled by 1 + 1e-15
    ends 2.0 away from its golden, PERF.md), so the flags need not
    agree."""
    lanes = x.shape[0]
    states = np.concatenate(cpu_ts._state_indices)
    xd = x.double().cpu()
    eq_viol, cone_margin = contract_in_float64(cpu_ts, xd, np.zeros((lanes, 0)))
    travel, friction = hopper_gait_checks(cpu_ts, xd)
    ref_x, ref_solved, ref_iters = ref
    for lane in range(lanes):
        gap = float(np.abs(xd[lane, states].numpy() - ref_x[lane, states]).max())
        same = bool(ref_solved[lane]) and gap <= CPU_ATOL_QUAD
        print(
            f"{tag} {name} lane {lane}: card solved {bool(solved[lane])} in {int(iters[lane])} iterations, "
            f"CPU float64 re-solve solved {bool(ref_solved[lane])} in {int(ref_iters[lane])}, "
            f"max state gap {gap:.3e} (limit {CPU_ATOL_QUAD:g}); the card's solution in float64: max |g| "
            f"{eq_viol[lane]:.3e}, least cone margin {cone_margin[lane]:.3e} (limits {BRANCH_TOL:g}), travel "
            f"{float(travel[lane]):.6f}, least friction margin {float(friction[lane]):.3e}"
            + ("" if same or not solved[lane] else "; another local solution")
        )
        check(
            not solved[lane] or same or (eq_viol[lane] <= BRANCH_TOL and cone_margin[lane] >= -BRANCH_TOL),
            f"{name} lane {lane}: {gap:.3e} from the CPU re-solve and off the contract in float64",
        )


def hopper_guesses(g0):
    """The hopper batch's B_HOPPER guesses: the bench guess g0 (float32)
    plus 0.01 N(0, 1) (default_rng(0)), as the rocket batch's
    (bench.py:530-596)."""
    return g0[None] + 0.01 * np.random.default_rng(0).normal(size=(B_HOPPER, g0.size)).astype(np.float32)


def hopper_cpu_reference(which):
    """A CPU float64 re-solve of phase 11, run in a background process
    (cpu_references): the bench's single solve from its guess ("single",
    11a) or the batch's first CPU_LANES_HOPPER lanes ("batch", 11b), as
    (x, solved, iterations) numpy arrays."""
    import torch

    from calipso_tpu_torch import Options

    torch.set_num_threads(CPU_REF_THREADS)
    ts = hopper_solver(hopper_tol_options(Options), "cpu")
    g0 = np.asarray(ts._guess, np.float32)
    guess = g0[None] if which == "single" else hopper_guesses(g0)[:CPU_LANES_HOPPER]
    st = ts.batched().solve(guess=torch.tensor(guess, dtype=torch.float64)).state
    return st.p.x.numpy(), st.solved.numpy(), st.total_i.numpy()


def quadruped_cpu_reference():
    """Phase 6's CPU float64 re-solve of the quadruped batch's first
    CPU_LANES_QUAD lanes, run in a background process, as (x, solved,
    iterations) numpy arrays."""
    import torch

    from calipso_tpu_torch import Options

    torch.set_num_threads(CPU_REF_THREADS)
    x0 = quadruped_scenarios(B_QUAD).astype(np.float32)[:CPU_LANES_QUAD]
    ts = quadruped_solver(tol_options(Options, max_iterative_refinement=2), "cpu", np.float64)
    st = ts.batched().solve(parameters=torch.tensor(x0, dtype=torch.float64)).state
    return st.p.x.numpy(), st.solved.numpy(), st.total_i.numpy()


def cpu_references(pool):
    """Start the CPU float64 re-solves of phases 6, 11a and 11b in `pool`
    (spawn_pool(3): one process each); returns their futures by name."""
    return {
        "hopper batch": pool.submit(hopper_cpu_reference, "batch"),
        "quadruped": pool.submit(quadruped_cpu_reference),
        "hopper single": pool.submit(hopper_cpu_reference, "single"),
    }


def spawn_pool(workers=1):
    """A pool of spawned processes (the parent holds a CUDA context)."""
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))


def hopper_tol_options(Options):
    """bench.py:664-668: every tolerance 1e-4, a shorter first central-path
    leg and two refinement trips."""
    return tol_options(Options, central_path_initial=0.1, max_iterative_refinement=2)


def hopper_single_phase(tag, cr, Options, dev):
    """Phase 11a: the bench's hopper gait, a cold and a warm float32 solve
    on the card (the warm one from the guess plus 1e-5, as the bench runs
    it). Returns the cold solve's launches and a function that holds the
    cold solve against its CPU float64 re-solve
    (hopper_cpu_reference("single")'s result)."""
    import torch

    opts = hopper_tol_options(Options)
    ts = hopper_solver(opts, "cuda")
    st = ts.solver.fns.stage_structure
    check(
        ts.solver.options.linear_solver == "riccati" and st.dmax == 26 and st.num_general == 4,
        f"hopper gait: {ts.solver.options.linear_solver}, d={st.dmax}, {st.num_general} border rows",
    )
    dims = ts.dims
    print(
        f"{tag} hopper gait: n={dims.variables}, {dims.equality} equality rows ({st.num_general} on the border), "
        f"{dims.cone} cone rows, stage blocks d={st.dmax}, linear_solver auto -> {ts.solver.options.linear_solver}"
    )
    g0 = np.asarray(ts._guess, np.float32)
    runs = {}
    for label, x0_np in (("cold", g0), ("warm", g0 + np.float32(1e-5))):
        x0 = torch.tensor(x0_np, device=dev)
        zero_launches(cr)
        t0 = time.time()
        r = ts.solver.solve(x0=x0)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(cr.LAUNCHES)
        runs[label] = r, launches
        rs = r.state
        print(
            f"{tag} hopper gait {label} solve (float32, card): solved {bool(r.solved)}, iterations "
            f"{int(r.iterations)} (the reference's, README.md:390, a TPU run: {JAX_HOPPER_ITERATIONS}), "
            f"{wall:.3f} s (host clock); ladder {int(rs.num_ladder)}, refine {int(rs.num_refine)}, "
            f"line-search chunks {int(rs.num_ls_chunks)}, host syncs {ts.solver._run.stats['host_syncs']}"
        )
        check_route(tag, "hopper gait", launches)
        check(tuple(r.variables.shape) == (dims.variables,) and r.variables.dtype == torch.float32, "hopper gait solution")
        check(bool(torch.isfinite(r.variables).all()), f"hopper gait {label}: non-finite solution")
        check(bool(r.solved), f"the hopper gait's {label} solve did not solve on the card")
    r, launches = runs["cold"]
    x = r.variables[None].cpu()
    return launches, lambda ref: hopper_resolve(
        tag, "hopper gait", hopper_solver(opts, "cpu"), x, [bool(r.solved)], [int(r.iterations)], ref
    )


def hopper_batch_phase(tag, cr, Options, dev, phase, settle):
    """Phase 11b: a B=1024 batch of the hopper gait in float32, each lane's
    guess the bench guess plus 0.01 N(0, 1) (hopper_guesses): at least
    MIN_SOLVED_HOPPER lanes solved. Then `settle` is given a function that
    holds the first lanes against their CPU float64 re-solves
    (hopper_cpu_reference("batch")'s result), and waits for whatever ran
    beside the cold batch; then the first PROFILE_ITERS_HOPPER lockstep
    iterations of a batch, once timed with per-layer host timers and once
    profiled (a whole warm batch, ~190 s, no longer runs: phase 16 took
    its time). Returns the cold batch's launches."""
    import torch
    from calipso_tpu_torch.solver import kkt

    opts = hopper_tol_options(Options)
    ts = hopper_solver(opts, "cuda")
    g0 = np.asarray(ts._guess, np.float32)
    guess = torch.tensor(hopper_guesses(g0), device=dev)
    bts = ts.batched()
    zero_launches(cr)
    t0 = time.time()
    res = bts.solve(guess=guess)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    launches = dict(cr.LAUNCHES)
    st = res.state
    print(
        f"{tag} hopper batch cold (first solve, includes one-time set-up; phases 7, 11c, 11d and part of 15 ran on the "
        f"card beside it, in three more processes, and the CPU float64 re-solves in three more): {cold_s:.3f} s; host syncs "
        f"{bts.stats['host_syncs']}; digest of its solution {x_digest(st)}"
    )
    check_route(tag, "hopper gait", launches)
    x = st.p.x
    check(tuple(x.shape) == (B_HOPPER, ts.dims.variables) and x.dtype == torch.float32, f"hopper batch {tuple(x.shape)}")
    check(bool(torch.isfinite(x[st.solved]).all()), "non-finite solution in a solved hopper lane")
    solved, iters = report_solve(f"{tag} hopper batch", B_HOPPER, st)
    travel, friction = hopper_gait_checks(ts, x)
    print(
        f"{tag} hopper batch over solved lanes: least travel {float(travel[st.solved].min()):.6f} (asked 0.5), "
        f"least friction margin {float(friction[st.solved].min()):.3e}; iterations beside the reference's single "
        f"solve (README.md:390, a TPU run): lockstep {int(iters.max())}, median {int(np.median(iters))} vs "
        f"{JAX_HOPPER_ITERATIONS}"
    )
    check(int(solved.sum()) >= MIN_SOLVED_HOPPER, f"only {int(solved.sum())} of {B_HOPPER} hopper lanes solved")
    xc = x[:CPU_LANES_HOPPER].cpu()
    settle(lambda ref: hopper_resolve(tag, "hopper batch", hopper_solver(opts, "cpu"), xc, solved, iters, ref))
    phase(f"11b: hopper batch, its first {PROFILE_ITERS_HOPPER} lockstep iterations timed by layer and profiled")
    popts = hopper_tol_options(Options).replace(max_outer_iterations=1, max_residual_iterations=PROFILE_ITERS_HOPPER)
    pbts = hopper_solver(popts, "cuda").batched()
    pbts.solve(guess=guess)  # its one-time set-up
    layers = [(pbts.fns, a) for a in QUAD_ORACLES] + [(kkt, a) for a in KKT_LAYERS]
    with layer_timers(layers) as spent:
        _, wall = timed(lambda: pbts.solve(guess=guess))
    print(f"{tag} hopper batch, first {PROFILE_ITERS_HOPPER} lockstep iterations (warm): {wall:.3f} s")
    for attr, (sec, calls) in sorted(spent.items(), key=lambda kv: -kv[1][0]):
        print(
            f"{tag}   hopper batch window, host time in {attr}: {sec:.3f} s ({100.0 * sec / wall:.1f}% of the wall) "
            f"over {calls} calls"
        )
    profile(
        tag, f"hopper (first {PROFILE_ITERS_HOPPER} lockstep iterations of a batch)",
        lambda: pbts.solve(guess=guess), host_ops=False,
    )
    return launches


def solve_counting_multi(rc, solve):
    """Run solve() to the card's end with ops/riccati.solve_multi (the
    border's solves) counted; returns (its result, the calls)."""
    import torch

    calls = 0
    inner = rc.solve_multi

    def counted(*a):
        nonlocal calls
        calls += 1
        return inner(*a)

    rc.solve_multi = counted
    try:
        out = solve()
        torch.cuda.synchronize()
    finally:
        rc.solve_multi = inner
    return out, calls


def hopper_golden_phase(tag, cr, rc, Options, dev):
    """Phase 11c: the hopper gait in float64 with default Options on the
    card against tests/golden/hopper_gait.npz, as
    tests/test_golden.py:test_golden_hopper_gait holds it (states within
    1e-2, iterations within +-15%); a solution on another local solution
    passes the branch rule instead: solved, the contract in float64, and
    tests/test_contact.py:test_hopper_gait's travel and friction. The solve
    is the contact_implicit example's hopper_gait (default Options but
    verbose, which changes no iterate). Returns its launches and the
    example's summary."""
    import torch

    from calipso_tpu_torch.examples import contact_implicit

    gold = np.load(GOLDEN_HOPPER)
    zero_launches(cr)
    ex, multi = solve_counting_multi(rc, lambda: contact_implicit.hopper_gait("cuda"))
    launches = dict(cr.LAUNCHES)
    gts, gres, wall = ex["solver"], ex["result"], ex["seconds"]
    check(
        gts.solver.options == Options(linear_solver="riccati", verbose=True, print_frequency=25),
        f"the hopper example's options: {gts.solver.options}",
    )
    check(gres.variables.dtype == torch.float64, f"hopper golden solved in {gres.variables.dtype}")
    gz = gres.variables.cpu()
    states = np.concatenate(gts._state_indices)
    gap = float((gz[states] - torch.tensor(gold["variables"])[states]).abs().max())
    iters, ref = int(gres.iterations), int(gold["iterations"])
    lo, hi = (1 - GOLDEN_BAND) * ref, (1 + GOLDEN_BAND) * ref
    cpu_ts = hopper_solver(Options(), "cpu")
    (eq_viol,), (cone_margin,) = contract_in_float64(cpu_ts, gz[None], np.zeros((1, 0)))
    travel, friction = (float(v[0]) for v in hopper_gait_checks(cpu_ts, gz[None]))
    on_golden = gap <= 1e-2
    print(
        f"{tag} hopper gait (float64, card, the contact_implicit example): solved {bool(gres.solved)}, iterations {iters} (golden {ref}, band "
        f"{lo:.1f}-{hi:.1f}), max state gap to the golden {gap:.3e} (limit 1e-2), {wall:.2f} s; solve_multi calls "
        f"{multi}; in float64: max |g| {eq_viol:.3e}, least cone margin {cone_margin:.3e}, travel "
        f"{travel:.6f}, least friction margin {friction:.3e}"
        + ("" if on_golden else "; another local solution than the golden's")
    )
    check_route(tag, "hopper gait", launches)
    check(multi > 0, "the hopper gait's border never ran through solve_multi")
    check(contract_met(gres.state, Options()), "the hopper gait (float64) did not meet the contract on the card")
    if on_golden:
        check(lo <= iters <= hi, f"hopper golden iterations {iters} outside +-15% of {ref}")
    else:
        check(
            eq_viol <= BRANCH_TOL and cone_margin >= -BRANCH_TOL and travel >= 0.5 - 1e-4 and friction >= -1e-6,
            "the hopper gait's other local solution fails the contract or the reference test's travel and friction",
        )
    return launches, example_summary(ex, launches, "11c", ("travel", "z_range"))


def contact_models_phase(tag, cr, Options, dev, models):
    """Phase 11d: ball-in-cup, the box move, the bunny hop, cyberdrift and
    the state-triggered rocket (of these, `models`) in float64 on the
    card, each with its reference test's options, guess and assertions
    (tests/test_contact.py:28-41, :109-170, tests/test_bunnyhop.py:15-30),
    each on its own route (ball-in-cup through the contact_implicit
    example). Returns {model: launches}, and under "examples" the
    example's summary."""
    import torch
    from calipso_tpu_torch import TrajOptSolver

    skip = ("state_guess", "state_initial", "state_goal", "action_guess", "penalty_initial")

    def trajopt_with(prob, options, actions=None):
        ts = TrajOptSolver(options=options, device="cuda", **{k: v for k, v in prob.items() if k not in skip})
        ts.initialize_states(prob["state_guess"])
        actions = prob.get("action_guess") if actions is None else actions
        if actions is not None:
            ts.initialize_actions(actions)
        return ts

    def trajopt(prob, actions):
        return trajopt_with(prob, Options(), actions)

    def run(name, solve):
        zero_launches(cr)
        t0 = time.time()
        r = solve()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(cr.LAUNCHES)
        print(
            f"{tag} {name} (float64, card): solved {bool(r.solved)}, iterations {int(r.iterations)}, {wall:.2f} s; "
            f"violations: residual {float(r.state.residual_violation):.2e}, equality "
            f"{float(r.state.equality_violation):.2e}, complementarity {float(r.state.cone_product_violation):.2e}"
        )
        check_route(tag, name, launches)
        check(r.variables.dtype == torch.float64 and bool(torch.isfinite(r.variables).all()), f"{name}: solution")
        return r, launches

    out = {}
    if "ball-in-cup" in models:
        ball_in_cup_box_bunny_hop(tag, cr, Options, dev, run, trajopt, models, out)
    if "cyberdrift" in models:
        cyberdrift_solve(tag, Options, run, out)
    if "state-triggered rocket" in models:
        state_triggered_rocket_solve(tag, Options, run, trajopt_with, out)
    return out


def ball_in_cup_box_bunny_hop(tag, cr, Options, dev, run, trajopt, models, out):
    """Phase 11d's first three models (see contact_models_phase)."""
    import torch
    from calipso_tpu_torch import Solver
    from calipso_tpu_torch.models import ball_in_cup, box, bunnyhop

    # ball-in-cup: tests/test_contact.py:test_ball_in_cup, whose problem,
    # options and guess are the contact_implicit example's
    from calipso_tpu_torch.examples import contact_implicit

    ex = {}
    r, out["ball-in-cup"] = run("ball-in-cup", lambda: ex.update(contact_implicit.ball_in_cup("cuda")) or ex["result"])
    ts = ex["solver"]
    check(ts.solver.fns.stage_structure.dmax == 12, f"ball-in-cup d={ts.solver.fns.stage_structure.dmax}")
    out["examples"] = {"contact_implicit ball": example_summary(ex, out["ball-in-cup"], "11d", ("distance",))}
    check(contract_met(r.state, Options()), "ball-in-cup did not meet the contract on the card")
    string = max(float((x[4:6] - x[6:8]) @ (x[4:6] - x[6:8])) for x in ts.get_trajectory(r)[0])
    print(f"{tag} ball-in-cup: longest squared string {string:.6f} (limit {ball_in_cup.STRING_LENGTH**2 + 1e-3:g})")
    check(string <= ball_in_cup.STRING_LENGTH**2 + 1e-3, "ball-in-cup: the string stretched")
    # box move: tests/test_contact.py:test_box_move
    prob = box.move_problem(horizon=11)
    ts = trajopt(prob, prob["action_guess"])
    check(ts.solver.fns.stage_structure.dmax == 33, f"box move d={ts.solver.fns.stage_structure.dmax}")
    r, out["box move"] = run("box move", ts.solve)
    check(contract_met(r.state, Options()), "the box move did not meet the contract on the card")
    states = ts.get_trajectory(r)[0]
    goal_gap = float(np.abs(states[-1][:6] - prob["state_goal"]).max())
    depth = min(float(box.signed_distance(torch.tensor(x[3:6])).min()) for x in states[1:])
    print(f"{tag} box move: final state {goal_gap:.3e} from the goal (limit 1e-3), lowest corner {depth:.3e} (limit -1e-4)")
    check(goal_gap <= 1e-3 and depth > -1e-4, "box move: off the goal or through the ground")
    # bunny hop: tests/test_bunnyhop.py:test_bunnyhop
    opts = Options(penalty_initial=1e2)
    s = Solver(bunnyhop.objective, bunnyhop.equality, bunnyhop.inequality, bunnyhop.NZ, options=opts, device="cuda")
    check(s.options.linear_solver == "schur", f"bunny hop: {s.options.linear_solver}")
    z0 = torch.tensor(bunnyhop.initial_guess(0), dtype=torch.float64, device=dev)
    r, out["bunny hop"] = run("bunny hop", lambda: s.solve(z0))
    check(contract_met(r.state, opts), "the bunny hop did not meet the contract on the card")
    z = r.variables.cpu()
    jump = float((z[bunnyhop.IDX_Q[4][[1, 3]]] - torch.tensor([1.1, 1.15], dtype=torch.float64)).abs().max())
    gaps = float(bunnyhop.gaps(z[: 6 * bunnyhop.N].reshape(bunnyhop.N, 6)).min())
    print(f"{tag} bunny hop: wheels {jump:.3e} from the obstacle heights (limit 1e-3), least contact gap {gaps:.3e} (limit -1e-4)")
    check(jump <= 1e-3 and gaps > -1e-4, "bunny hop: a wheel missed its height or went through the ground")


def cyberdrift_solver(Options, device):
    """tests/test_contact.py:test_cyberdrift's problem, options and initial
    actions as a TrajOptSolver on `device`, each inner step's merit
    appended to its `merits`; (solver, options, problem). The line search
    is the serial one, what "auto" takes on the CPU the reference test
    runs on (the card's "auto" is parallel)."""
    from calipso_tpu_torch import TrajOptSolver
    from calipso_tpu_torch.models import cyberdrift

    opts = Options(
        residual_tolerance=1e-3, optimality_tolerance=1e-3, equality_tolerance=1e-3,
        complementarity_tolerance=1e-3, slack_tolerance=1e-3, penalty_initial=10.0, linear_solver="schur",
        line_search_mode="serial",
    )
    prob = cyberdrift.drift_problem()
    skip = ("state_guess", "state_initial", "state_goal", "action_guess", "penalty_initial")
    ts = TrajOptSolver(options=opts, device=device, **{k: v for k, v in prob.items() if k not in skip})
    ts.initialize_states(prob["state_guess"])
    rng = np.random.default_rng(1)
    ts.initialize_actions([np.concatenate([1e-3 * rng.normal(size=2), np.tile([1.0, 0.1, 0.1], 4)]) for _ in range(14)])
    ts.merits = []
    ts.solver.callbacks(inner=lambda d: ts.merits.append(d["merit"].detach()))
    return ts, opts, prob


@contextlib.contextmanager
def library_backward_errors(rc):
    """Hold every call of ops/riccati's library route (chol_library,
    chol_solve_library) against its inputs in float64 on the card: yields
    {"factor": normwise backward errors |S - L L'|_F / |S|_F of the lanes
    it factored, "not_pd": least eigenvalue over |S|_F of the lanes it
    reported not positive definite (NaN), "solve": |b - L L' x|_inf /
    (|L|_inf |L'|_inf |x|_inf + |b|_inf)}, each a list of per-call
    maxima (device scalars; "factor" and "solve" -inf where a call had no
    such lane)."""
    import torch

    chol, solve = rc.chol_library, rc.chol_solve_library
    out = {"factor": [], "not_pd": [], "solve": []}
    norm_inf = lambda A: A.abs().sum(-1).amax(-1)
    worst = lambda v, m: torch.where(m, v, float("-inf")).amax()

    def factor(S):
        L = chol(S)
        Sd, Ld = S.double(), L.double()
        fro = torch.linalg.matrix_norm(Sd)
        ok = torch.isfinite(Ld).flatten(1).all(1)
        Lz = torch.where(ok[:, None, None], Ld, 0.0)
        out["factor"].append(worst(torch.linalg.matrix_norm(Sd - Lz @ Lz.mT) / fro, ok))
        if not bool(ok.all()):
            out["not_pd"].append((torch.linalg.eigvalsh(Sd[~ok])[:, 0] / fro[~ok]).amax())
        return L

    def chol_solve(L, b):
        x = solve(L, b)
        Ld, bd, xd = L.double(), b.double(), x.double()
        r = bd - (Ld @ (Ld.mT @ xd[..., None]))[..., 0]
        eta = r.abs().amax(-1) / (norm_inf(Ld) * norm_inf(Ld.mT) * xd.abs().amax(-1) + bd.abs().amax(-1))
        out["solve"].append(worst(eta, torch.isfinite(Ld).flatten(1).all(1)))
        return x

    rc.chol_library, rc.chol_solve_library = factor, chol_solve
    try:
        yield out
    finally:
        rc.chol_library, rc.chol_solve_library = chol, solve


def cyberdrift_solve(tag, Options, run, out):
    """Phase 11d's cyberdrift: tests/test_contact.py:test_cyberdrift (schur
    at n = 286, past the T=1 kernels: the library route), one solve on the
    card from the reference test's guess, held to the reference test's
    contract and goal or, where it fails, by cyberdrift_branch_rule to the
    port's float64 solve on the CPU from the same guess."""
    import torch

    ts, opts, prob = cyberdrift_solver(Options, "cuda")
    check(ts.num_variables == 286, f"cyberdrift n={ts.num_variables}")
    goal = lambda ts, r: float(np.abs(ts.get_trajectory(r)[0][-1][0:3] - prob["state_goal"][0:3]).max())
    g0 = torch.tensor(ts._guess, dtype=torch.float64, device=ts.solver.device)

    def card():
        r, out["cyberdrift"] = run("cyberdrift", lambda: ts.solver.solve(g0))
        return r, ts.merits, goal(ts, r)

    def cpu():
        c, _, _ = cyberdrift_solver(Options, "cpu")
        r = c.solver.solve(g0.cpu())
        return r, c.merits, goal(c, r)

    cyberdrift_branch_rule(tag, "cyberdrift", "the reference test", card, cpu, lambda r, gap: contract_met(r.state, opts) and gap <= 1e-2)


def cyberdrift_branch_rule(tag, name, guess, card, cpu, holds):
    """Cyberdrift's outcome moves with the last bit
    (tests/test_torch_models.py: test_cyberdrift_outcome_depends_on_the_last_bit:
    from the guess scaled by 1 + k 1e-15, k = 0..8, 2 of the reference's 9
    float64 solves fail and 3 of the port's). card() and cpu() each solve
    from `guess` (on the card, and on the CPU with one torch thread) and
    return (result, each inner step's merit, final pose gap); holds(result,
    gap) is the assertions the solve answers to. The branch rule: the
    card's solve holds; or it does not, and (1) every call of the library
    route in its run is backward stable (library_backward_errors,
    CYBER_BACKWARD_TOL), (2) its merits follow the CPU solve's within
    CYBER_FOLLOW_RTOL over the first CYBER_FOLLOW_STEPS steps (the same
    arithmetic up to rounding), and (3) the CPU solve holds (the port
    solves the problem from this guess). The step where the two runs part
    is printed either way. Returns (card result, card holds)."""
    import torch
    from calipso_tpu_torch.ops import riccati as rc

    with library_backward_errors(rc) as backward:
        r, card_merits, gap = card()
    met = holds(r, gap)
    worst = {k: max((float(v) for v in vals), default=float("-inf")) for k, vals in backward.items()}
    calls = {k: len(v) for k, v in backward.items() if k != "not_pd"}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.time()
        rcpu, cpu_merits, gap_cpu = cpu()
        wall_cpu = time.time() - t0
    finally:
        torch.set_num_threads(threads)
    met_cpu = holds(rcpu, gap_cpu)
    card_m = torch.stack(card_merits).double().cpu().reshape(-1).numpy()
    cpu_m = torch.stack(cpu_merits).double().reshape(-1).numpy()
    steps = min(len(card_m), len(cpu_m))
    rel = np.abs(card_m[:steps] - cpu_m[:steps]) / np.abs(cpu_m[:steps])
    parted = np.nonzero(rel > CYBER_PART_RTOL)[0]
    follow = float(rel[:CYBER_FOLLOW_STEPS].max())
    print(
        f"{tag} {name} (float64, card, from {guess}'s guess): its assertions hold {met}, final pose "
        f"{gap:.3e} from the goal (limit 1e-2); the library route's calls {calls}, largest backward errors: factor "
        f"{worst['factor']:.3e}, solve {worst['solve']:.3e} (limit {CYBER_BACKWARD_TOL:g}), least eigenvalue over "
        f"|S|_F of a lane reported not positive definite {worst['not_pd']:.3e} (limit {CYBER_BACKWARD_TOL:g})"
    )
    print(
        f"{tag} {name} on the CPU (float64, the port, one thread, same guess): solved {bool(rcpu.solved)} in "
        f"{int(rcpu.iterations)} iterations, {wall_cpu:.2f} s, its assertions hold {met_cpu}, final pose {gap_cpu:.3e} "
        f"from the goal; card against CPU merits: largest relative gap over the first {CYBER_FOLLOW_STEPS} steps "
        f"{follow:.3e} (limit {CYBER_FOLLOW_RTOL:g}), first step apart by more than {CYBER_PART_RTOL:g}: "
        f"{int(parted[0]) if parted.size else None} of {steps}; gaps at steps 0, 10, 20, ...: "
        + ", ".join(f"{v:.1e}" for v in rel[::10])
    )
    if met:
        return r, met
    print(f"{tag} {name}: the card's solve failed; the branch rule holds it to its CPU solve")
    check(
        max(worst["factor"], worst["solve"], worst["not_pd"]) <= CYBER_BACKWARD_TOL,
        f"{name}: a call of the library route on the card is not backward stable",
    )
    check(follow <= CYBER_FOLLOW_RTOL and steps >= CYBER_FOLLOW_STEPS,
          f"{name}: the card's merits leave the CPU solve's within {CYBER_FOLLOW_STEPS} steps")
    check(met_cpu, f"{name}: the port's CPU solve from the same guess fails its assertions")
    return r, met


def state_triggered_rocket_solve(tag, Options, run, trajopt_with, out):
    """Phase 11d's state-triggered rocket:
    tests/test_contact.py:test_state_triggered_rocket (T=51, d=17)."""
    from calipso_tpu_torch.models import rocket

    prob = rocket.state_triggered_problem(horizon=51)
    ts = trajopt_with(prob, Options(penalty_initial=prob["penalty_initial"]))
    check(ts.solver.fns.stage_structure.dmax == 17, f"state-triggered rocket d={ts.solver.fns.stage_structure.dmax}")
    r, out["state-triggered rocket"] = run("state-triggered rocket", ts.solve)
    check(contract_met(r.state, Options()), "the state-triggered rocket did not meet the contract on the card")
    worst = min(
        (float(x[2]) - 3.0 for x in ts.get_trajectory(r)[0] if -float(x[0]) - 0.5 > 1e-4), default=float("inf")
    )
    print(f"{tag} state-triggered rocket: least altitude margin where triggered {worst:.3e} (limit -1e-4)")
    check(worst > -1e-4, "state-triggered rocket: the trigger's constraint is violated")


def float64_phases(tag, t_start, which="goldens"):
    """The float64 single solves, run in three more processes on the card
    beside the hopper batch's cold batch (the card is idle most of a
    host-bound batch), each step with its own launch counts: `which` =
    "goldens", phase 7 (the quadruped gait golden), 11c (the hopper
    golden), 11d's ball-in-cup, box move and bunny hop and phase 15's
    mpc_autotuning example; "models", 11d's cyberdrift and state-triggered
    rocket and phase 15's drifting example; "examples", phase 15's
    quadruped gait v2 and autotuning_acrobot example. Returns {"launches": {path:
    launches}, "examples": {example: example_summary}} (the examples some
    of these phases run for phase 15)."""
    import torch

    from calipso_tpu_torch import Options
    from calipso_tpu_torch.ops import cuda_riccati as cr, riccati as rc

    dev = torch.device("cuda")

    def phase(name):
        print(f"{tag} [{time.time() - t_start:.1f} s] phase {name} ({which} process)", flush=True)

    launches, examples = {}, {}
    if which == "examples":
        examples["contact_implicit quadruped_v2"] = quadruped_gait_v2_example(tag, cr, rc, phase)
        examples["autotuning_acrobot"] = tuning_example(tag, cr, phase, "autotuning_acrobot")
        return {"launches": launches, "examples": examples}
    if which == "goldens":
        launches["quadruped_gait"], examples["contact_implicit quadruped"] = quadruped_gait_phase(
            tag, cr, rc, Options, dev, phase
        )
        phase("11c: hopper gait golden (float64)")
        launches["hopper_golden"], examples["contact_implicit hopper"] = hopper_golden_phase(tag, cr, rc, Options, dev)
        phase("11d: ball-in-cup, box move, bunny hop (float64)")
        models = ("ball-in-cup", "box move", "bunny hop")
    else:
        phase("11d: cyberdrift, state-triggered rocket (float64)")
        models = ("cyberdrift", "state-triggered rocket")
    out = contact_models_phase(tag, cr, Options, dev, models)
    examples.update(out.pop("examples", {}))
    if which == "models":
        phase("15: drifting example (float64)")
        examples["drifting"] = drifting_example(tag, cr)
    else:
        examples["mpc_autotuning"] = tuning_example(tag, cr, phase, "mpc_autotuning")
    for model, counts in out.items():
        launches[model.replace("-", "_").replace(" ", "_")] = counts
    return {"launches": launches, "examples": examples}


def contact_phases(tag, cr, Options, dev, phase, quadruped_against_cpu, t_start, examples):
    """Phase 11 (and phase 7, which runs beside it), each step with the
    launch counts of its process set to 0 just before it and read just
    after. Only the hopper batch's cold batch shares the card and the
    host: phases 7, 11c, 11d and part of 15 run beside it in three more
    processes on the card (float64_phases), and the CPU float64 re-solves
    of phases 6, 11a and 11b in three more, whose results phase 6's
    `quadruped_against_cpu` and 11a's and 11b's checks then read. Returns
    {path: launches}; into `examples` the summaries of the examples those
    processes run (example_summary)."""
    phase("11a: hopper gait (float32, the bench's single solve)")
    launches, single_against_cpu = hopper_single_phase(tag, cr, Options, dev)
    out = {"hopper_gait": launches}
    with spawn_pool(3) as cpu, spawn_pool(3) as card:
        refs = cpu_references(cpu)
        beside = [card.submit(float64_phases, tag, t_start, which) for which in ("goldens", "models", "examples")]
        phase(
            f"11b: hopper gait batch (B={B_HOPPER}, float32); beside it phases 7, 11c, 11d and part of 15 in three "
            "more processes on the card and the CPU float64 re-solves of phases 6, 11a and 11b in three more"
        )

        def settle(batch_against_cpu):
            phase("6: quadruped against its CPU float64 re-solve")
            quadruped_against_cpu(refs["quadruped"].result())
            phase("11a: hopper gait against its CPU float64 re-solve")
            single_against_cpu(refs["hopper single"].result())
            phase("11b: hopper batch against its CPU float64 re-solve")
            batch_against_cpu(refs["hopper batch"].result())
            phase("11b: waiting for the float64 single solves")
            for f in beside:
                done = f.result()
                out.update(done["launches"])
                examples.update(done["examples"])

        out["hopper_batch"] = hopper_batch_phase(tag, cr, Options, dev, phase, settle)
    return out


def quadruped_phase(tag, cr, Options, dev, phase):
    """Phase 6: the bench's batched quadruped on the card (riccati backend,
    stream route), a warm batch with per-layer host timers and a profile.
    Returns the cold batch's launches and a function that holds its first
    lanes against their CPU float64 re-solve (quadruped_cpu_reference's
    result), which contact_phases calls once the re-solve is done."""
    import torch

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
    check(all(qlaunches[k] > 0 for k in QUAD_STREAM_KERNELS), f"a stream kernel never launched: {qlaunches}")
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
    xq = qx[:CPU_LANES_QUAD].double().cpu()

    def against_cpu(ref):
        ref_x, cpu_solved, ref_iters = ref
        check(
            cpu_solved.tolist() == qsolved[:CPU_LANES_QUAD].tolist(),
            f"quadruped: solved flags differ from the CPU float64 re-solve: {cpu_solved.tolist()} vs "
            f"{qsolved[:CPU_LANES_QUAD].tolist()}",
        )
        states = np.concatenate(qts._state_indices)
        eq_viol, cone_margin = contract_in_float64(
            quadruped_solver(qopts, "cpu", np.float64), xq, x0q_np[:CPU_LANES_QUAD]
        )
        for lane in range(CPU_LANES_QUAD):
            gap = float((xq[lane, states] - torch.from_numpy(ref_x[lane, states])).abs().max())
            both = bool(cpu_solved[lane] and qsolved[lane])
            branch = both and gap > CPU_ATOL_QUAD
            print(
                f"{tag} quadruped lane {lane}: CPU float64 re-solve solved {bool(cpu_solved[lane])}, "
                f"iterations {int(ref_iters[lane])} (card {int(qiters[lane])}), max state gap {gap:.3e} "
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
    return qlaunches, against_cpu


def quadruped_gait_phase(tag, cr, rc, Options, dev, phase):
    """Phase 7: the quadruped gait golden in float64 on the card (the
    riccati border through solve_multi on the stream kernels), solved by
    the contact_implicit example (default Options, the problem's guess).
    Returns its launches and the example's summary."""
    phase("7: quadruped gait")
    from calipso_tpu_torch.examples import contact_implicit

    gold = np.load(GOLDEN_GAIT)
    zero_launches(cr)
    ex, multi = solve_counting_multi(rc, lambda: contact_implicit.quadruped_gait("cuda"))
    glaunches = dict(cr.LAUNCHES)
    gts, gres, gwall = ex["solver"], ex["result"], ex["seconds"]
    gst = gts.solver.fns.stage_structure
    check(
        gts.solver.options.linear_solver == "riccati" and len(gst.general_stages) == 2,
        f"gait: {gts.solver.options.linear_solver}, general stages {gst.general_stages}",
    )
    gz = gres.variables.cpu().numpy()
    gstates = lambda z: np.concatenate([z[idx] for idx in gts._state_indices])
    ggap = float(np.abs(gstates(gz) - gstates(gold["variables"])).max())
    giters, gref = int(gres.iterations), int(gold["iterations"])
    print(
        f"{tag} quadruped gait (float64, card, the contact_implicit example): solved {bool(gres.solved)}, iterations {giters} "
        f"(golden {gref}, band {0.85 * gref:.1f}-{1.15 * gref:.1f}), max state gap to the golden {ggap:.3e} "
        f"(limit 1e-2), {gwall:.2f} s; solve_multi calls {multi}; launches {glaunches}"
    )
    check(bool(gres.solved), "the quadruped gait did not solve on the card")
    check(ggap <= 1e-2, f"gait states differ from the golden by {ggap:.3e}")
    check(0.85 * gref <= giters <= 1.15 * gref, f"gait iterations {giters} outside +-15% of {gref}")
    check(
        multi > 0 and all(glaunches[k] > 0 for k in QUAD_STREAM_KERNELS),
        f"the gait's border never ran on the stream kernels: {multi} solve_multi calls, {glaunches}",
    )
    return glaunches, example_summary(ex, glaunches, "7", ("travel",))



def quadruped_gait_v2_example(tag, cr, rc, phase):
    """Phase 15's contact_implicit quadruped_gait_v2 (the mirrored
    half-cycle gait with its stance phase, d = 54 on the stream route, the
    border through solve_multi) in float64 on the card, run beside 11b:
    the example's assertion (solved) and, as
    tests/test_torch_quadruped.py:test_golden_quadruped_gait holds it,
    tests/golden/quadruped_gait_v2.npz (states within 1e-2, iterations
    within +-15%). Returns the example's summary."""
    phase("15: contact_implicit quadruped_gait_v2 (float64)")
    import torch
    from calipso_tpu_torch.examples import contact_implicit

    gold = np.load(GOLDEN_GAIT_V2)
    zero_launches(cr)
    ex, multi = solve_counting_multi(rc, lambda: contact_implicit.quadruped_gait_v2("cuda"))
    launches = dict(cr.LAUNCHES)
    ts, r = ex["solver"], ex["result"]
    states = lambda z: np.concatenate([np.asarray(z)[idx] for idx in ts._state_indices])
    gap = float(np.abs(states(r.variables.cpu().numpy()) - states(gold["variables"])).max())
    iters, ref = int(r.iterations), int(gold["iterations"])
    print(
        f"{tag} quadruped gait v2 (float64, card, the contact_implicit example): solved {bool(r.solved)}, iterations "
        f"{iters} (golden {ref}, band {0.85 * ref:.1f}-{1.15 * ref:.1f}), max state gap to the golden {gap:.3e} (limit "
        f"1e-2), travel {ex['travel']:.3f} m, mirror periodicity error {ex['mirror_periodicity_err']:.2e}, "
        f"{ex['seconds']:.2f} s; solve_multi calls {multi}"
    )
    check(r.variables.dtype == torch.float64, "quadruped gait v2: not solved in float64")
    check(gap <= 1e-2 and 0.85 * ref <= iters <= 1.15 * ref, "quadruped gait v2 misses its golden")
    check(multi > 0, "the gait v2's border never ran through solve_multi")
    return example_summary(ex, launches, "15 (beside 11b)", ("travel", "mirror_periodicity_err"))


def drifting_example(tag, cr):
    """Phase 15's drifting example (examples/drifting.py: cyberdrift on
    schur at n = 286, the T=1 library route) in float64 on the card, run
    beside phase 11d's cyberdrift. Its problem, options and guess are the
    reference test's, which 11d solves with the serial line search; the
    example keeps "auto", the parallel line search on the card, so it runs
    once more. Its assertions (solved, final pose within 1e-2) hold, or
    cyberdrift_branch_rule holds it to the port's CPU float64 solve of the
    example with the same (parallel) line search. Returns the example's
    summary."""
    import torch
    from calipso_tpu_torch.examples import drifting

    ex = {}

    def card():
        merits = []
        zero_launches(cr)
        ex.update(drifting.solve("cuda", inner=lambda d: merits.append(d["merit"].detach())))
        ex["launches"] = dict(cr.LAUNCHES)
        return ex["result"], merits, ex["pose_error"]

    def cpu():
        merits = []
        out = drifting.solve(
            "cpu", inner=lambda d: merits.append(d["merit"].detach()),
            options=drifting.OPTIONS.replace(line_search_mode="parallel"),
        )
        return out["result"], merits, out["pose_error"]

    holds = lambda r, gap: bool(r.solved) and gap < 1e-2
    r, met = cyberdrift_branch_rule(tag, "drifting example", "the example", card, cpu, holds)
    print(
        f"{tag} drifting example (float64, card): solved {bool(r.solved)}, iterations {int(r.iterations)}, "
        f"{ex['seconds']:.2f} s, final pose error {ex['pose_error']:.4f}; its assertions "
        + ("hold" if met else "fail on the card (held by the branch rule)")
    )
    check(r.variables.dtype == torch.float64 and ex["solver"].num_variables == 286, "drifting: dtype or size")
    summary = example_summary(ex, ex["launches"], "15 (beside 11b)", ("pose_error",))
    summary["assertions_hold"] = met
    return summary


def example_run(cr, name, fn, phase):
    """Run an example's entry point fn() to the card's end with the launch
    counts set to 0 just before; (its outcome, {"launches", "phase",
    "seconds"})."""
    import torch

    phase(f"15: {name}")
    zero_launches(cr)
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, {"launches": dict(cr.LAUNCHES), "phase": "15", "seconds": time.time() - t0}


def tuning_example(tag, cr, phase, name):
    """Phase 15's auto-tuning example `name` (mpc_autotuning, or
    autotuning_acrobot's swing-up and tuning), run beside 11b's cold
    batch: host-bound loops of single solves, 52 and 191 s there on an
    H100. Their assertions (the swing-up solves, the loss falls) are the
    examples' own. Returns its summary."""
    from calipso_tpu_torch.examples import autotuning_acrobot, mpc_autotuning

    main = {"mpc_autotuning": mpc_autotuning.main, "autotuning_acrobot": autotuning_acrobot.main}[name]
    out, sm = example_run(cr, name, lambda: main("cuda"), phase)
    sm.update(phase="15 (beside 11b)", history=out["history"], weights=out["weights"].tolist())
    if name == "autotuning_acrobot":
        swing = out["swingup"]
        check(swing["solver"].solver.fns.stage_structure.dmax == 5, "acrobot swing-up: not d = 5")
        sm.update(solved=swing["solved"], iterations=swing["iterations"], swingup_s=swing["seconds"], tuning_s=out["seconds"])
    print(f"{tag} {name} (float64, card): {sm['seconds']:.2f} s, rollout loss {sm['history'][0]:.6f} -> "
          f"{sm['history'][-1]:.6f} in {len(sm['history']) - 1} steps")
    return sm


def examples_phase(tag, cr, dev, phase, reused):
    """Phase 15: every example of calipso_tpu_torch/examples through its
    entry point at its script's size, float64, on the card, each with its
    script's assertions and the launches EXAMPLE_KERNELS predicts (counts
    set to 0 just before each and read just after). `reused` holds the
    summaries of the examples the earlier phases and the processes beside
    11b ran (the rocket landing in 9, the quadruped gait in 7, the hopper
    gait in 11c, ball-in-cup in 11d, the gait v2, drifting and the two
    tunings beside 11b), read here. Prints each example's iterations and
    wall; returns {path: launches}."""
    import torch
    from calipso_tpu_torch.examples import batched_scenarios, nonconvex

    summaries = {}
    for name, problem in nonconvex.PROBLEMS.items():
        out, sm = example_run(cr, f"nonconvex {name}", lambda: problem("cuda"), phase)
        check(out["variables"].dtype == np.float64 and out["solver"].options.linear_solver == "schur", f"nonconvex {name}")
        summaries[f"nonconvex {name}"] = {**sm, "solved": out["solved"], "iterations": out["iterations"]}
    out, sm = example_run(cr, "batched_scenarios", lambda: batched_scenarios.main(B_SCENARIOS, "cuda"), phase)
    st = out["result"].state
    check(
        out["solved"] == B_SCENARIOS and st.p.x.dtype == torch.float64 and bool(torch.isfinite(st.p.x).all()),
        f"batched_scenarios: {out['solved']} of {B_SCENARIOS} solved",
    )
    summaries["batched_scenarios"] = {
        **sm, "solved": out["solved"], "iterations": int(st.total_i.max()), "solves_per_s": out["solves_per_s"],
        "timed_batch_s": out["seconds"],
    }
    summaries.update(reused)
    launches = {}
    for name in EXAMPLE_KERNELS:
        check(name in summaries, f"example {name} never ran")
        sm = summaries[name]
        check_route(tag, name, sm["launches"])
        rest = {k: v for k, v in sm.items() if k not in ("launches", "phase", "seconds")}
        print(f"{tag} example {name} (phase {sm['phase']}): {sm['seconds']:.2f} s; {rest}")
        launches[f"example {name}"] = sm["launches"]
    return launches

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
    register_kernels_fit(tag, _build.build_log, "".join(src.read_text() for src in _build.SOURCES))


def sass_loops(tag, stem="riccati_fused", kernel="solve_batched_reg_kernel"):
    """--sass: compile csrc/<stem>.cu to a cubin for sm_90a (the build's
    target and optimization), disassemble it with cuobjdump, and print for
    each instantiation of `kernel` its static instructions and its
    outermost loops (a branch back to an earlier address closes one): each
    loop's instructions, cp.async copies (LDGSTS), shuffles (SHFL),
    floating-point FMAs, shared-memory (LDS, STS) and global (LDG, STG)
    accesses. The full listing goes beside the cubin, under build/."""
    import re

    from calipso_tpu_torch.ops import _build

    src = _build.PACKAGE_DIR / "csrc" / f"{stem}.cu"
    out = _build.BUILD_ROOT / "sass"
    out.mkdir(parents=True, exist_ok=True)
    cubin, listing = out / f"{stem}.cubin", out / f"{stem}.sass"
    nvcc = _build._nvcc()
    subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin", "-o", str(cubin), str(src)],
        check=True, timeout=600,
    )
    text = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", str(cubin)],
        capture_output=True, text=True, check=True, timeout=300,
    ).stdout
    listing.write_text(text)
    classes = {"LDGSTS": ("LDGSTS",), "SHFL": ("SHFL",), "FMA": ("FFMA", "DFMA"), "LDS/STS": ("LDS", "STS"),
               "LDG/STG": ("LDG", "STG")}
    funcs, name = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name] = ([], {})
            continue
        if name is None:
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if label:
            funcs[name][1][label.group(1)] = len(funcs[name][0])
        elif ins:
            funcs[name][0].append((int(ins.group(1), 16), ins.group(2).strip()))
    for fname, (code, labels) in funcs.items():
        if kernel not in fname:
            continue
        at = {addr: i for i, (addr, _) in enumerate(code)}
        ops = [re.sub(r"^@!?U?P\w+\s+", "", op).split()[0].split(".")[0] for _, op in code]
        loops = []
        for i, (_, op) in enumerate(code):
            if not ops[i].endswith("BRA"):
                continue
            target = re.search(r"`\((\.L_x_\d+)\)", op)
            j = labels.get(target.group(1)) if target else at.get(int(op.split("0x")[-1].split()[0], 16)) if "0x" in op else None
            if j is not None and j < i:  # not the self-branch that pads a function's end
                loops.append((j, i))
        outer = []
        for j, i in sorted(loops, key=lambda ji: (ji[0], -ji[1])):
            if not outer or i > outer[-1][1]:
                outer.append((j, i))
        desc = []
        for j, i in outer:
            body = ops[j:i + 1]
            counts = ", ".join(f"{sum(op in names for op in body)} {c}" for c, names in classes.items())
            inner = sum(1 for a, z in loops if j <= a and z <= i and (a, z) != (j, i))
            desc.append(f"[{i - j + 1} instructions: {counts}; {inner} inner loops]")
        print(f"{tag} sass {fname}: {len(code)} instructions; outermost loops " + " ".join(desc))


# kernels whose rows live in registers, indexed at compile time, and
# their instantiations: ptxas must give each no stack frame and no spill
# (factor_lanes at widths 12, 16 and 32; solve_t1 and factor_t1 at 32, and
# their panel kernels for n in 33..128; the fused solve at 12, 16 and 32
# with its factor on chip and in the workspace, batch-first and
# batch-last; each in float32 and float64)
REGISTER_KERNELS = {
    "factor_lanes_reg_kernel": 6, "solve_t1_reg_kernel": 2, "factor_t1_reg_kernel": 2,
    "solve_batched_reg_kernel": 24, "factor_t1_panel_kernel": 4, "solve_t1_panel_kernel": 4,
    # the wide sweeps: ceil(d / 32) rows a thread, 3..6 in float32, 3..4 in
    # float64; the wide stream factor, its 8 x 8 panel in registers
    "solve_fwd_stream_wide_kernel": 6, "solve_bwd_stream_wide_kernel": 6, "factor_stream_wide_kernel": 2,
}
# an older checkout's register kernel without a later template parameter,
# and its instantiations there (the batch-first fused solve alone; the
# T=1 panel kernels up to n = 128 alone)
OLDER_REGISTER_KERNELS = {
    "solve_batched_reg_kernel": ("kBatchLast", 12),
    "factor_t1_panel_kernel": ("kMaxP", 2),
    "solve_t1_panel_kernel": ("kWideWarps", 2),
}


def register_kernels_fit(tag, log, sources):
    """Check ptxas's -v report of the REGISTER_KERNELS: every
    instantiation with 0 bytes of stack frame and of spill; print each
    one's registers. A library built by an earlier process leaves no
    report, and a checkout's `sources` are checked for the register
    kernels they have (an older checkout has fewer)."""
    props, regs, current = {}, {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1]
        elif "Function properties for" in line:
            current = line.split("Function properties for")[1].strip()
        elif "bytes stack frame" in line and current:
            props[current] = line.strip()
        elif "Used" in line and "registers" in line and current:
            regs[current] = line.split("Used")[1].split("registers")[0].strip()
    present = {r: n for r, n in REGISTER_KERNELS.items() if r in sources}
    for r, (param, n) in OLDER_REGISTER_KERNELS.items():
        if r in present and param not in sources:
            present[r] = n
    if not log or not present:
        print(f"{tag} ptxas: no build in this process or no register kernel, none reported")
        return
    found = [k for k in props if any(r in k for r in present)]
    check(
        len(found) == sum(present.values()),
        f"ptxas reported {len(found)} register-kernel instantiations of {sorted(present)}: {found}",
    )
    for k in sorted(found):
        print(f"{tag} register kernel {k}: {regs.get(k, '?')} registers, {props[k]}")
        check(
            props[k].startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
            f"{k} has a stack frame or spills: {props[k]}",
        )


def non_pd_lanes(B):
    """The 8 lanes made not positive definite in a T=1 check of B lanes
    (none below 8 lanes)."""
    if B < 8:
        return ()
    return NON_PD if B == B_FLAG else tuple(int(i) for i in np.linspace(0, B - 1, 8).astype(int))


def t1_inputs(n, B=B_FLAG):
    """T=1 inputs: B SPD (n, n) matrices, the lanes non_pd_lanes(B)
    negated (past n=32 the first of them only at its last pivot, in the
    panel kernels' last panel), and right-hand sides (B, n)."""
    rng = np.random.default_rng(0 if (B, n) == (B_FLAG, 32) else B + n)
    A = rng.normal(size=(B, n, n))
    S64 = A @ np.swapaxes(A, 1, 2) + n * np.eye(n)
    bad = list(non_pd_lanes(B))
    S64[bad] *= -1.0
    if bad and n > 32:
        S64[bad[0]] *= -1.0
        S64[bad[0], n - 1, n - 1] = -5.0
    return S64, rng.normal(size=(B, n))


def check_t1(tag, cr, dev, errs, times, times64, B=B_FLAG, n=32, dtypes=("float32", "float64")):
    """factor_t1 and solve_t1 against their plain versions at (B, n), the
    flagship's shape unless given, in float32 and float64 (those of them
    in `dtypes`), with the lanes non_pd_lanes(B) not positive definite
    (NaN on both paths); into `times` and `times64` the kernel, plain,
    library and bound times."""
    import torch

    S64, b64 = t1_inputs(n, B)
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        if name not in dtypes:
            continue
        S = torch.tensor(S64, dtype=dtype, device=dev)
        b = torch.tensor(b64, dtype=dtype, device=dev)
        L, Lp = cr.factor_t1(S), cr.factor_t1_plain(S)
        x, xp = cr.solve_t1(L, b), cr.solve_t1_plain(Lp, b)
        torch.cuda.synchronize()
        bad = torch.isnan(L).any(-1).any(-1)
        check(
            torch.equal(bad, torch.isnan(Lp).any(-1).any(-1))
            and sorted(torch.nonzero(bad)[:, 0].tolist()) == list(non_pd_lanes(B)),
            f"{name} B={B} n={n}: NaN lanes differ between kernel and plain",
        )
        lower = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
        check(bool(torch.isnan(L[bad][:, lower]).all()), f"{name} B={B} n={n}: partial NaN factor")
        ok = ~bad
        for kname, got, want in (("factor_t1", L, Lp), ("solve_t1", x, xp)):
            abs_err = float((got[ok].double() - want[ok].double()).abs().max())
            rel_err = abs_err / float(want[ok].double().abs().max())
            errs[(kname, name, B, n)] = abs_err
            print(f"{tag} {kname} {name} B={B} n={n}: max_abs_err {abs_err:.3e} max_rel_err {rel_err:.3e} (limit {RTOL[name]:g})")
            check(rel_err <= RTOL[name], f"{kname} {name} B={B} n={n}: relative error {rel_err:.3e}")
        into = times if name == "float32" else times64
        Sg, Lg, bg = S[ok].contiguous(), L[ok].contiguous(), b[ok].contiguous()
        into["factor_t1"] = (
            cuda_ms(lambda: cr.factor_t1(S), 50), cuda_ms(lambda: cr.factor_t1_plain(S), 50),
            cuda_ms(lambda: torch.linalg.cholesky_ex(Sg), 50),
            bound((tri(n) + n * n) * WORD[name] * B, n**3 / 3 * B, name),
        )
        into["solve_t1"] = (
            cuda_ms(lambda: cr.solve_t1(L, b), 50), cuda_ms(lambda: cr.solve_t1_plain(L, b), 50),
            cuda_ms(lambda: torch.cholesky_solve(bg[..., None], Lg), 50),
            bound((tri(n) + 2 * n) * WORD[name] * B, 2 * n * n * B, name),
        )
        for kname in ("factor_t1", "solve_t1"):
            if hasattr(cr, f"{kname}_layout"):  # a checkout from before it reports nothing
                warps, blocks = getattr(cr, f"{kname}_layout")(dtype, n)
                print(f"{tag} {kname} {name} n={n}: {warps} warps a block, {blocks} resident blocks an SM")
        if B == 1 and n > 32:  # a system failing only at its last pivot, alone
            S1 = S.clone()
            S1[0, n - 1, n - 1] = -5.0
            L1, L1p = cr.factor_t1(S1), cr.factor_t1_plain(S1)
            x1 = cr.solve_t1(L1, b)
            torch.cuda.synchronize()
            lower = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
            check(
                bool(torch.isnan(L1[0][lower]).all()) and bool(torch.isnan(L1p[0][lower]).all())
                and not bool(L1[0][~lower].any()) and bool(torch.isnan(x1).all()),
                f"{name} B=1 n={n}: a system failing at its last pivot is not NaN over its lower triangle and x",
            )


# the shapes phases 2e and 5 hold and time the kernels at, beside the
# main paths': (lanes, stream, T=1), and phase 12's past the narrow
# kernels' widths, each with the dtypes it is timed in
OTHER_SHAPES = (
    CONTACT_LANES_SHAPES + EXAMPLE_LANES_SHAPES + SPIKE_LANES_SHAPES,
    CONTACT_STREAM_SHAPES + EXAMPLE_STREAM_SHAPES + SPIKE_STREAM_SHAPES,
    WIDE_T1_SHAPES + APP_T1_SHAPES + EXAMPLE_T1_SHAPES,
)
BOTH = ("float32", "float64")
WIDE_KERNEL_SHAPES = (
    tuple(((B, T, d, 1), only) for (B, T, d), only in WIDE_STREAM_SHAPES),
    (((1, 2 * HORIZON_WIDE + HORIZON_WIDE - 1), BOTH),)
    + tuple(((B, 3 * H - 1), ("float32",)) for H, B in WIDE_SCHUR_BATCHES),
)


def contact_kernel_checks(tag, cr, dev, errs):
    """Phase 2e: the kernels against their plain versions at the contact
    paths' shapes and those of phases 11d, 13 and 14 (CONTACT_*_SHAPES)
    and the T=1 pair at WIDE_T1_SHAPES and APP_T1_SHAPES, float32 and
    float64, 8 lanes not positive definite where B >= 8. Returns {shape
    label: (float32 times, float64 times)} of kernel, plain and bound
    times, which phase 5 completes."""
    lanes, stream, t1 = OTHER_SHAPES
    out = {}
    for B, T, d in lanes:
        times, times64 = {}, {}
        check_lanes(tag, cr, dev, B, T, d, errs, times, times64)
        out[f"B={B} T={T} d={d}"] = times, times64
    for B, T, d, K in stream:
        times, times64 = {}, {}
        check_stream(tag, cr, dev, B, T, d, K, errs, times, times64)
        out[f"B={B} T={T} d={d} K={K}"] = times, times64
    for B, n in t1:
        times, times64 = {}, {}
        check_t1(tag, cr, dev, errs, times, times64, B, n)
        out[f"B={B} n={n}"] = times, times64
    wide_stream, wide_t1 = WIDE_KERNEL_SHAPES
    for (B, T, d, K), only in wide_stream:
        times, times64 = {}, {}
        check_stream(tag, cr, dev, B, T, d, K, errs, times, times64, dtypes=only)
        out[f"B={B} T={T} d={d} K={K}"] = times, times64
    for (B, n), only in wide_t1:
        times, times64 = {}, {}
        check_t1(tag, cr, dev, errs, times, times64, B, n, dtypes=only)
        out[f"B={B} n={n}"] = times, times64
    return out


def print_shape_times(tag, kname, name, shape, ms, gms, plain_ms, lib_ms, bms, by):
    print(
        f"{tag} {kname} {name} {shape} (contact, phase 11d, 12, 13, 14, 15 or wide T=1 path): kernel {ms:.4f} ms host-launched, "
        f"{gms:.4f} ms replayed, plain {plain_ms:.4f} ms, library "
        + ("none" if lib_ms is None else f"{lib_ms:.4f} ms")
        + f", bound {bms * 1e3:.2f} us ({by}), {100.0 * bms / gms:.1f}% of the bound replayed"
    )


def contact_kernel_times(tag, cr, dev, ctimes):
    """Phase 5 at phase 2e's shapes (OTHER_SHAPES): each kernel
    host-launched (phase 2e's times), replayed
    from a CUDA graph, its plain version, its library call (float32: on
    the dense matrices for the block-tridiagonal kernels, as
    LIBRARY_CALLS pairs them; cholesky_ex and cholesky_solve for T=1) and
    its bound, float32 and float64. Returns {(kernel, dtype name, shape):
    (ms, graph ms, plain ms, library ms or None, (bound ms, bound by))}."""
    lanes, stream, t1 = OTHER_SHAPES
    wide_stream, wide_t1 = WIDE_KERNEL_SHAPES
    cases = [("lanes", f"B={B} T={T} d={d}", tridiag_inputs(B, T, d, 1)) for B, T, d in lanes]
    cases += [("stream", f"B={B} T={T} d={d} K={K}", tridiag_inputs(B, T, d, K)) for B, T, d, K in stream]
    cases += [("T=1", f"B={B} n={n}", t1_inputs(n, B)) for B, n in t1]
    cases += [("stream", f"B={B} T={T} d={d} K={K}", tridiag_inputs(B, T, d, K), only) for (B, T, d, K), only in wide_stream]
    cases += [("T=1", f"B={B} n={n}", t1_inputs(n, B), only) for (B, n), only in wide_t1]
    graphs = graph_times(tag, cr, dev, cases=cases)
    library = {f"B={B} T={T} d={d}": library_times(cr, dev, B, T, d) for B, T, d in lanes}
    stream_all = list(stream) + [shape for shape, _ in wide_stream]
    library.update({f"B={B} T={T} d={d} K={K}": library_times(cr, dev, B, T, d, K) for B, T, d, K in stream_all})
    out = {}
    for shape, pair in ctimes.items():
        for name, into in zip(("float32", "float64"), pair):
            for kname, (ms, plain_ms, lib_ms, (bms, by)) in into.items():
                if kname in LIBRARY_CALLS:
                    lib_ms = library[shape][LIBRARY_CALLS[kname][1]] if name == "float32" else None
                gms = graphs[(kname, name, shape)][0]
                out[(kname, name, shape)] = ms, gms, plain_ms, lib_ms, (bms, by)
                print_shape_times(tag, kname, name, shape, ms, gms, plain_ms, lib_ms, bms, by)
    return out


def t1_times(tag, cr, dev):
    """--t1-times: the T=1 pair against its plain version and timed at
    WIDE_T1_SHAPES and at phase 12's wide shapes (phase 2e's and phase 5's
    T=1 part alone)."""
    shapes = [((B, n), BOTH) for B, n in WIDE_T1_SHAPES] + list(WIDE_KERNEL_SHAPES[1])
    graphs = graph_times(tag, cr, dev, cases=[("T=1", f"B={B} n={n}", t1_inputs(n, B), only) for (B, n), only in shapes])
    for (B, n), only in shapes:
        times, times64 = {}, {}
        check_t1(tag, cr, dev, {}, times, times64, B, n, dtypes=only)
        for name, into in (("float32", times), ("float64", times64)):
            for kname, (ms, plain_ms, lib_ms, (bms, by)) in into.items():
                gms = graphs[(kname, name, f"B={B} n={n}")][0]
                print_shape_times(tag, kname, name, f"B={B} n={n}", ms, gms, plain_ms, lib_ms, bms, by)


def wide_routes_phase(tag, cr, rc, Options, dev):
    """Phase 12: past the narrow kernels' widths (n = 128, d = 64). (a) The
    pendulum swing-up at horizon 44 (n = 131) on schur in float64, the
    serial line search, from its state guess: the wide T=1 kernels and no
    library call, held to the same solve on the CPU (the same solved flag,
    iterations within GOLDEN_BAND, states within 1e-3). (b) float32 schur
    batches at WIDE_SCHUR_BATCHES (the flagship's options and parameter):
    the T=1 kernels and no library call, at least B - WIDE_SOLVED_MARGIN
    solved, a CPU float64 re-solve of CPU_LANES_RESOLVE lanes with the same
    solved flags and states within WIDE_CPU_ATOL. (c) ops/riccati's
    factor, solve, solve_multi (K=2) and cuda_riccati.solve_batched at
    WIDE_STREAM_SHAPES on the stream kernels, held to their plain
    versions. (d) The same calls one past each dtype's MAX_D on the scan
    route, held to the same calls on the CPU. Returns {path: launches} of
    (a) and (b)."""
    import torch
    from calipso_tpu_torch import TrajOptSolver
    from calipso_tpu_torch.models import pendulum

    def solve(device):
        prob = pendulum.swingup_problem(HORIZON_WIDE)
        ts = TrajOptSolver(
            prob["objective"], prob["dynamics"], prob["num_states"], prob["num_actions"],
            equality=prob["equality"], options=Options(linear_solver="schur", line_search_mode="serial"), device=device,
        )
        ts.initialize_states(prob["state_guess"])
        check(rc.t1_route(ts.num_variables, torch.float64) == "kernel", f"n={ts.num_variables} takes the library route")
        t0 = time.time()
        r = ts.solve()
        if device == "cuda":
            torch.cuda.synchronize()
        return ts, r, time.time() - t0

    ts_cpu, r_cpu, wall_cpu = solve("cpu")
    zero_launches(cr)
    ts, r, wall = solve("cuda")
    out = {"pendulum_n131": dict(cr.LAUNCHES)}
    n = ts.num_variables
    print(
        f"{tag} pendulum n={n} (schur, float64): card solved {bool(r.solved)} in {int(r.iterations)} iterations, "
        f"{wall:.2f} s; CPU solved {bool(r_cpu.solved)} in {int(r_cpu.iterations)}, {wall_cpu:.2f} s"
    )
    check_route(tag, "pendulum n=131", out["pendulum_n131"])
    check(r.variables.dtype == torch.float64 and bool(r.solved) == bool(r_cpu.solved) is True, "pendulum n=131: not solved")
    band = GOLDEN_BAND * int(r_cpu.iterations)
    check(abs(int(r.iterations) - int(r_cpu.iterations)) <= band, "pendulum n=131: iterations out of the band")
    x, x_cpu = r.variables.cpu(), r_cpu.variables
    gap = max(float((x[idx] - x_cpu[idx]).abs().max()) for idx in ts._state_indices)
    print(f"{tag} pendulum n={n}: states {gap:.3e} from the CPU solve's (limit 1e-3)")
    check(gap <= 1e-3, "pendulum n=131: states off the CPU solve's")

    for horizon, B in WIDE_SCHUR_BATCHES:
        out.update(wide_schur_batch(tag, cr, rc, Options, dev, horizon, B))
    for (B, T, d), only in WIDE_STREAM_SHAPES:
        for name in only:
            wide_block_calls(tag, cr, rc, dev, B, T, d, name, "stream")
    for name in ("float32", "float64"):
        wide_block_calls(tag, cr, rc, dev, SCAN_B, SCAN_T, cr.MAX_D[getattr(torch, name)] + 1, name, "scan")
    return out


def wide_schur_batch(tag, cr, rc, Options, dev, horizon, B):
    """Phase 12b: the flagship's pendulum at `horizon` (n = 3 horizon - 1)
    as a float32 schur batch of B lanes on the card (the flagship's
    options, its initial states 0.2 N(0, 1) from default_rng(horizon) as
    the parameter), counts zeroed just before: the T=1 kernels and no
    library call, at least B - WIDE_SOLVED_MARGIN lanes solved, and a CPU
    float64 re-solve of the first CPU_LANES_RESOLVE lanes with the same
    solved flags and states within WIDE_CPU_ATOL. Returns {path: launches}."""
    import torch
    from calipso_tpu_torch import TrajOptSolver
    from calipso_tpu_torch.models import pendulum

    def batched(device):
        prob = pendulum.swingup_problem(horizon, parametric_initial_state=True)
        ts = TrajOptSolver(
            prob["objective"], prob["dynamics"], prob["num_states"], prob["num_actions"],
            equality=prob["equality"], parameters=prob["parameters"],
            options=tol_options(Options, linear_solver="schur"), device=device,
        )
        ts.initialize_states(prob["state_guess"])
        return ts, ts.batched()

    x0_np = 0.2 * np.random.default_rng(horizon).normal(size=(B, 2))
    ts, bts = batched(dev)
    n = ts.num_variables
    name = f"pendulum n={n} batch"
    check(rc.t1_route(n, torch.float32) == "kernel", f"{name}: n={n} takes the library route in float32")
    zero_launches(cr)
    t0 = time.time()
    res = bts.solve(parameters=torch.tensor(x0_np, dtype=torch.float32, device=dev))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(cr.LAUNCHES)
    st = res.state
    print(f"{tag} {name} (schur, float32, B={B}): cold batch {wall:.3f} s")
    check_route(tag, name, launches)
    check(st.p.x.dtype == torch.float32 and bool(torch.isfinite(st.p.x[st.solved]).all()), f"{name}: non-finite solution")
    solved, _ = report_solve(f"{tag} {name}", B, st)
    check(int(solved.sum()) >= B - WIDE_SOLVED_MARGIN, f"{name}: only {int(solved.sum())} of {B} lanes solved")
    _, cpu_bts = batched("cpu")
    ref = cpu_bts.solve(parameters=torch.tensor(x0_np[:CPU_LANES_RESOLVE]))
    cpu_resolve(tag, name, st, ref, CPU_LANES_RESOLVE, WIDE_CPU_ATOL)
    return {f"pendulum_n{n}_batch": launches}


def wide_block_calls(tag, cr, rc, dev, B, T, d, name, route):
    """Phase 12c and 12d: ops/riccati.factor, solve, solve_multi (K=2) and
    cuda_riccati.solve_batched at (B, T, d) in `name` on `route` ("stream":
    the stream kernels, held to their plain versions on the card; "scan":
    the scan, held to the same calls on the CPU), the launch counts zeroed
    just before: the route's kernels (or library calls) and no other. Lane
    1 is not positive definite from stage 2 on: NaN from there on, on both
    paths, and over all of its x."""
    import torch

    dtype = getattr(torch, name)
    check(rc.route(d, dtype, T) == route, f"d={d} {name} takes the {rc.route(d, dtype, T)} route, not the {route}")
    rng = np.random.default_rng(B + T + d)
    A = rng.normal(size=(B, T, d, d))
    D64 = A @ np.swapaxes(A, -1, -2) + d * np.eye(d)
    D64[1, 2] *= -1.0
    O64, b64, bk64 = 0.3 * rng.normal(size=(B, T - 1, d, d)), rng.normal(size=(B, T, d)), rng.normal(size=(B, T, d, 2))
    D, O, b, bk = (torch.tensor(a, dtype=dtype, device=dev) for a in (D64, O64, b64, bk64))
    zero_launches(cr)
    L, M = rc.factor(D, O)
    got = (L, M, rc.solve(L, M, b), rc.solve_multi(L, M, bk), cr.solve_batched(D, O, b))
    torch.cuda.synchronize()
    launches = {k: v for k, v in cr.LAUNCHES.items() if v}
    shape = f"B={B} T={T} d={d} ({name})"
    print(f"{tag} {route} route {shape}: launches {launches}")
    if route == "stream":
        want = {"factor_stream": 2, "solve_fwd_stream": 3, "solve_bwd_stream": 3}
        Lp, Mp = cr.factor_stream_plain(D, O)
        ref = (Lp, Mp, cr.solve_lanes_plain(Lp, Mp, b),
               cr.solve_bwd_stream_plain(Lp, Mp, cr.solve_fwd_stream_plain(Lp, Mp, bk)), cr.solve_batched_plain(D, O, b))
    else:
        want = {"factor_scan": 2, "solve_scan": 3}
        Dc, Oc, bc, bkc = (a.cpu() for a in (D, O, b, bk))
        Lc, Mc = rc.factor(Dc, Oc)
        ref = (Lc, Mc, rc.solve(Lc, Mc, bc), rc.solve_multi(Lc, Mc, bkc), cr.solve_batched(Dc, Oc, bc))
    check(launches == want, f"{route} route {shape}: launches {launches}, want {want}")
    for label, g, w in zip(("L", "M", "x", "X", "solve_batched x"), got, ref):
        g, w = g.cpu(), w.cpu()
        check(torch.equal(torch.isnan(g), torch.isnan(w)), f"{route} route {shape} {label}: NaN entries differ")
        ok = ~torch.isnan(w)
        rel = float((g[ok].double() - w[ok].double()).abs().max() / w[ok].double().abs().max())
        print(f"{tag} {route} route {shape} {label}: max_rel_err {rel:.3e} against {'plain' if route == 'stream' else 'the CPU'} (limit {RTOL[name]:g})")
        check(rel <= RTOL[name], f"{route} route {shape} {label}: relative error {rel:.3e}")
    for x in (got[2], got[4]):
        check(bool(torch.isnan(x[1]).all()) and bool(torch.isfinite(x[[0] + list(range(2, B))]).all()),
              f"{route} route {shape}: lane 1's x is not NaN, or another lane's is")


def pendulum_solver(options, device, horizon):
    """The flagship's pendulum swing-up (initial state as the stage-0
    parameter) at `horizon` as a TrajOptSolver."""
    from calipso_tpu_torch import TrajOptSolver
    from calipso_tpu_torch.models import pendulum

    prob = pendulum.swingup_problem(horizon, parametric_initial_state=True)
    ts = TrajOptSolver(
        prob["objective"], prob["dynamics"], prob["num_states"], prob["num_actions"],
        equality=prob["equality"], parameters=prob["parameters"], options=options, device=device,
    )
    ts.initialize_states(prob["state_guess"])
    return ts


def timed(fn):
    """(fn()'s result, seconds to the card's synchronize after it)."""
    import torch

    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def sensitivity_against_float64(tag, name, ts64, res, stats, thetas):
    """Phase 13's lane check on the first DIFF_LANES lanes: (1) their
    float32 sensitivity against the float64 sensitivity at the same
    points (each lane's state, regularization and penalty cast to
    float64): the float32 arithmetic's error, relative to each lane's
    largest entry, within DIFF_RTOL on the median lane and on every lane
    whose error estimate (res.sensitivity_error) is at most DIFF_TRUST;
    (2) against the float64 sensitivity of the same lanes solved again in
    float64 on the card by ts64 (a differentiating solver): the median
    lane within DIFF_SOLVE_RTOL. `stats` is the batch's solver stats.
    Every lane past DIFF_RTOL or DIFF_TRUST is printed with its estimate,
    iterations, parameter and largest entries."""
    import torch
    from calipso_tpu_torch.solver.differentiate import solution_sensitivity

    lanes = slice(0, DIFF_LANES)
    s32 = res.sensitivity[lanes].double()
    est = res.sensitivity_error[lanes].double()
    check(bool(torch.isfinite(s32).all()), f"{name}: a checked float32 lane's sensitivity is not finite")
    rel = lambda a, b: (a - b).abs().amax(dim=(1, 2)) / b.abs().amax(dim=(1, 2))
    st = type(res.state)(*(
        type(f)(*(a[lanes].double() for a in f)) if isinstance(f, tuple)
        else (f[lanes].double() if f.is_floating_point() else f[lanes])
        for f in res.state
    ))
    s64 = solution_sensitivity(ts64.solver.fns, ts64.solver.layout, ts64.solver.options, st, thetas[lanes].double())
    at_point = rel(s32, s64)
    r64 = ts64.batched().solve(parameters=thetas[lanes].double())
    check(bool(r64.solved.all()), f"{name}: a float64 lane of the check did not solve")
    solved64 = rel(s32, r64.sensitivity)
    untrusted = [i for i in range(DIFF_LANES) if float(est[i]) > DIFF_TRUST]
    off = [i for i in range(DIFF_LANES) if float(at_point[i]) > DIFF_RTOL or i in untrusted]
    far = [i for i in off if i not in untrusted and float(at_point[i]) > DIFF_RTOL]
    print(
        f"{tag} {name}: float32 sensitivity of {DIFF_LANES} lanes against float64 at the same points: median "
        f"max_rel_err {float(at_point.median()):.3e} (limit {DIFF_RTOL:g}), {DIFF_LANES - len(off)} lanes within "
        f"{DIFF_RTOL:g} and trusted; lanes whose error estimate is over {DIFF_TRUST:g} {untrusted}; error "
        f"estimates median {float(est.median()):.3e}, max {float(est.max()):.3e}; refinement trips "
        f"{stats['sensitivity_refine_trips']}; lanes of the batch whose factor at the solution took the inertia "
        f"ladder {stats['sensitivity_ladder_lanes'][:16]}; against the same lanes' float64 solve: median "
        f"{float(solved64.median()):.3e} (limit {DIFF_SOLVE_RTOL:g}), max {float(solved64.max()):.3e}"
    )
    for i in off:
        print(
            f"{tag} {name}: lane {i}: max_rel_err {float(at_point[i]):.3e} at its point, error estimate "
            f"{float(est[i]):.3e}{' (untrusted)' if i in untrusted else ''}, {float(solved64[i]):.3e} against its "
            f"float64 solve; iterations {int(res.iterations[i])} / {int(r64.iterations[i])} (float32 / float64), "
            f"parameter {thetas[i].tolist()}, largest entry {float(s32[i].abs().max()):.3e} / "
            f"{float(s64[i].abs().max()):.3e} (float32 / float64 at the point)"
        )
    check(not far and float(at_point.median()) <= DIFF_RTOL,
          f"{name}: float32 sensitivity off the float64 one at its point on trusted lanes {far}")
    check(float(solved64.median()) <= DIFF_SOLVE_RTOL, f"{name}: float32 sensitivity off the float64 solve's")


def differentiation_phase(tag, cr, Options, dev, phase):
    """Phase 13: implicit differentiation on the card, each path with the
    launch counts set to 0 just before it and read just after. (a) the
    flagship (B_FLAG, float32, schur) with differentiate=True: sensitivity
    (B, 80, 2), at least one more factor_t1 launch than the same batch
    undifferentiated, the same lanes solved in the same iterations, the
    wall a warm differentiated batch adds, and the lane check; (b) the
    pendulum at horizon 44 (n = 131, "auto" -> riccati, d = 3, B_DIFF,
    float32): the lanes pair and the stream sweeps (the K=2 solve) and no
    T=1 kernel, and the lane check; (c) the differentiable solve in
    float64 on DIFF_FD_LANES flagship lanes: backward() of a scalar
    function of the solution equals sens' w_bar, and central differences
    of float64 solves to 1e-10. Returns {path: launches}."""
    import torch
    from calipso_tpu_torch.solver.diffable import make_differentiable_solve
    from calipso_tpu_torch.solver.differentiate import solution_sensitivity

    out = {}
    phase("13a: flagship differentiated (float32)")
    x0s = torch.tensor((0.2 * np.random.default_rng(0).normal(size=(B_FLAG, 2))).astype(np.float32), device=dev)
    plain = flagship(tol_options(Options), "cuda")
    diff = flagship(tol_options(Options, differentiate=True), "cuda")
    zero_launches(cr)
    r0, _ = timed(lambda: plain.solve(parameters=x0s))
    plain_launches = dict(cr.LAUNCHES)
    zero_launches(cr)
    r, _ = timed(lambda: diff.solve(parameters=x0s))
    out["flagship_differentiated"] = launches = dict(cr.LAUNCHES)
    check_route(tag, "flagship differentiated", launches)
    check(
        launches["factor_t1"] >= plain_launches["factor_t1"] + 1,
        f"flagship differentiated: {launches['factor_t1']} factor_t1 launches, undifferentiated {plain_launches['factor_t1']}",
    )
    total = diff.fns.dims.total
    check(tuple(r.sensitivity.shape) == (B_FLAG, total, 2) and total == 80, f"sensitivity {tuple(r.sensitivity.shape)}")
    check(torch.equal(r.solved, r0.solved) and torch.equal(r.iterations, r0.iterations),
          "flagship differentiated: the solve differs from the undifferentiated one")
    check(bool(torch.isfinite(r.sensitivity[r.solved]).all()), "flagship differentiated: a solved lane's sensitivity is not finite")
    solved, _ = report_solve(f"{tag} flagship differentiated", B_FLAG, r.state)
    check(int(solved.sum()) >= MIN_SOLVED_FLAG, "flagship differentiated: too few lanes solved")
    _, wall0 = timed(lambda: plain.solve(parameters=x0s))
    _, wall1 = timed(lambda: diff.solve(parameters=x0s))
    print(
        f"{tag} flagship differentiated: lanes whose factor at the solution took the inertia ladder "
        f"{diff.stats['sensitivity_ladder_lanes'][:16]}; factor_t1 launches {launches['factor_t1']} (undifferentiated "
        f"{plain_launches['factor_t1']}); warm batch {wall1:.4f} s against {wall0:.4f} s undifferentiated: "
        f"differentiation adds {wall1 - wall0:.4f} s"
    )
    sensitivity_against_float64(
        tag, "flagship differentiated", pendulum_solver(tol_options(Options, differentiate=True), "cuda", HORIZON_FLAG),
        r, diff.stats, x0s,
    )

    phase(f"13b: pendulum horizon {HORIZON_DIFF} differentiated (riccati, d=3, B={B_DIFF}, float32)")
    ts = pendulum_solver(tol_options(Options, differentiate=True), "cuda", HORIZON_DIFF)
    check(ts.solver.options.linear_solver == "riccati" and ts.solver.fns.stage_structure.dmax == 3,
          f"pendulum n={ts.num_variables}: {ts.solver.options.linear_solver}, d={ts.solver.fns.stage_structure.dmax}")
    th = torch.tensor((0.2 * np.random.default_rng(1).normal(size=(B_DIFF, 2))).astype(np.float32), device=dev)
    bts = ts.batched()
    zero_launches(cr)
    r, wall = timed(lambda: bts.solve(parameters=th))
    out["pendulum_n131_differentiated"] = launches = dict(cr.LAUNCHES)
    check_route(tag, "pendulum n=131 differentiated", launches)
    solved, _ = report_solve(f"{tag} pendulum n={ts.num_variables} differentiated", B_DIFF, r.state)
    nan_lanes = torch.nonzero(~torch.isfinite(r.sensitivity).flatten(1).all(1))[:, 0].tolist()
    print(
        f"{tag} pendulum n={ts.num_variables} differentiated: cold batch {wall:.3f} s, sensitivity "
        f"{tuple(r.sensitivity.shape)}; lanes whose factor at the solution took the inertia ladder: "
        f"{bts.stats['sensitivity_ladder_lanes'][:16]}; lanes with a non-finite sensitivity {nan_lanes[:16]} (solved: "
        f"{r.solved[nan_lanes[:16]].tolist()}, eps_p {r.state.eps_p_used[nan_lanes[:16]].tolist()})"
    )
    check(int(solved.sum()) >= B_DIFF - 8, "pendulum n=131 differentiated: too few lanes solved")
    check(tuple(r.sensitivity.shape) == (B_DIFF, ts.solver.fns.dims.total, 2), "pendulum n=131: sensitivity shape")
    check(bool(torch.isfinite(r.sensitivity[r.solved]).all()), "pendulum n=131: a solved lane's sensitivity is not finite")
    sensitivity_against_float64(
        tag, "pendulum n=131 differentiated",
        pendulum_solver(tol_options(Options, differentiate=True), "cuda", HORIZON_DIFF), r, bts.stats, th,
    )

    phase(f"13c: the differentiable solve (float64, {DIFF_FD_LANES} lanes, against central differences)")
    tight = Options(
        residual_tolerance=1e-10, equality_tolerance=1e-8, complementarity_tolerance=1e-8,
        optimality_tolerance=1e-8, slack_tolerance=1e-8,
    )
    ts = pendulum_solver(tight, "cuda", HORIZON_FLAG)
    solve_w = make_differentiable_solve(ts.solver.fns, ts.solver.layout, ts.solver.options)
    th0 = torch.tensor(0.2 * np.random.default_rng(2).normal(size=(DIFF_FD_LANES, 2)), device=dev)
    c = torch.tensor(np.random.default_rng(3).normal(size=ts.solver.fns.dims.total), device=dev)
    guess = torch.tensor(ts._guess, device=dev)
    loss = lambda w: (torch.sin(w) * c).sum(-1)
    zero_launches(cr)
    th = th0.clone().requires_grad_(True)
    w = solve_w(th, guess)
    loss(w).sum().backward()
    torch.cuda.synchronize()
    out["differentiable_solve"] = launches = dict(cr.LAUNCHES)
    check_route(tag, "differentiable solve", launches)
    check(bool(solve_w.state.solved.all()), "differentiable solve: a lane did not solve")
    sens = solution_sensitivity(ts.solver.fns, ts.solver.layout, ts.solver.options, solve_w.state, th0)
    want = torch.einsum("bkp,bk->bp", sens, torch.cos(w.detach()) * c)
    err_bwd = float((th.grad - want).abs().max() / want.abs().max())
    fd = torch.zeros_like(th0)
    with torch.no_grad():
        for j in range(th0.shape[1]):
            e = torch.zeros(th0.shape[1], dtype=th0.dtype, device=dev)
            e[j] = DIFF_FD_EPS
            fd[:, j] = (loss(solve_w(th0 + e, guess)) - loss(solve_w(th0 - e, guess))) / (2 * DIFF_FD_EPS)
    err_fd = float(((fd - th.grad).abs() / th.grad.abs().clamp(min=1.0)).max())
    print(
        f"{tag} differentiable solve: iterations {solve_w.state.total_i.tolist()}; backward against sens' w_bar "
        f"{err_bwd:.3e} (limit 1e-12), against central differences {err_fd:.3e} (limit {DIFF_FD_RTOL:g})"
    )
    check(err_bwd <= 1e-12, "differentiable solve: backward is not sens' w_bar")
    check(err_fd <= DIFF_FD_RTOL, "differentiable solve: gradient off the central differences")
    return out


def pendulum_mpc_solver(Options, device, horizon=11):
    """tests/test_mpc.py:_pendulum_mpc in the port: (TrajOptSolver, flat
    guess, the plant for one lane)."""
    import math

    import torch
    from calipso_tpu_torch import TrajOptSolver

    def pend_c(x, u):
        return torch.stack([x[1], u[0] / 0.25 - 9.81 * torch.sin(x[0]) / 0.5 - 0.1 * x[1] / 0.25])

    def pend_d(y, x, u):
        return y - (x + 0.05 * pend_c(0.5 * (x + y), u))

    def goal(x):
        return torch.stack([x[0] - math.pi, x[1]])

    objective = [
        *[(lambda x, u, w: goal(x) @ goal(x) + 0.01 * u @ u)] * (horizon - 1),
        lambda x, u, w: 10.0 * goal(x) @ goal(x),
    ]
    ts = TrajOptSolver(
        objective, [pend_d] * (horizon - 1), [2] * horizon, [1] * (horizon - 1),
        equality=[lambda x, u, w: x - w, *[None] * (horizon - 1)],
        parameters=[np.zeros(2)] + [np.zeros(0)] * (horizon - 1), options=Options(), device=device,
    )
    guess = np.zeros(ts.num_variables)
    for t, idx in enumerate(ts._state_indices):
        guess[idx] = np.array([math.pi, 0.0]) * t / (horizon - 1)

    def simulate(x, u):
        return x + 0.05 * pend_c(0.5 * (2 * x + 0.05 * pend_c(x, u)), u)

    return ts, guess, simulate


def cartpole_tuning(Options, device, B):
    """tests/test_autotuning.py:106-183 in the port over B initial states:
    (loss, w0, x0 (B, 4), the policy)."""
    import torch
    from calipso_tpu_torch import TrajOptSolver
    from calipso_tpu_torch.apps import autotuning
    from calipso_tpu_torch.models import cartpole

    T = 4

    def stage_cost(x, u, w):
        return 0.5 * x @ (w[:4] * x) + 0.05 * (u @ u)

    def final_cost(x, u, w):
        return 0.5 * x @ (w[:4] * x)

    ts = TrajOptSolver(
        [stage_cost] * (T - 1) + [final_cost], [cartpole.discrete] * (T - 1), [4] * T, [1] * (T - 1),
        equality=[lambda x, u, w: x - w[4:8], *[None] * (T - 1)],
        parameters=[np.concatenate([np.ones(4), np.zeros(4)])] + [np.ones(4)] * (T - 2) + [10.0 * np.ones(4)],
        options=Options(residual_tolerance=1e-6, equality_tolerance=1e-6, complementarity_tolerance=1e-6),
        device=device,
    )

    def theta_builder(weights, state):
        ten = torch.full((4,), 10.0, dtype=weights.dtype, device=weights.device)
        return torch.cat([weights, state] + [weights] * (T - 2) + [ten])

    pol = autotuning.make_mpc_policy(ts, np.zeros(ts.num_variables), theta_builder, ts._action_indices[0], 4)

    def sim(x, u):
        y = x + 0.05 * cartpole.continuous(x, u)
        for _ in range(3):
            y = x + 0.05 * cartpole.continuous(0.5 * (x + y), u)
        return y

    loss = autotuning.rollout_loss(
        pol.policy, sim, 5, np.diag([1.0, 5.0, 0.1, 0.1]), 0.01 * np.eye(1), np.array([0.0, np.pi, 0.0, 0.0]),
        np.zeros(1),
    )
    x0 = np.array([0.1, np.pi - 0.2, 0.0, 0.0]) + 0.05 * np.random.default_rng(0).normal(size=(B, 4))
    w0 = torch.ones(4, dtype=torch.float64, device=ts.solver.device)
    return loss, w0, torch.tensor(x0, device=ts.solver.device), pol, ts


def apps_phase(tag, cr, Options, dev, phase):
    """Phase 14: the applications on the card, each with the launch counts
    set to 0 just before it and read just after: (a) the pendulum MPC
    (apps/mpc.py) for B_MPC scenarios, MPC_STEPS warm-started steps,
    float32: every lane solved at every step, every final state inside
    the test's bounds, the mean iterations after step 0 not above step
    0's; (b) the cart-pole tuning (apps/autotuning.py) over B_TUNE
    initial states, float64, TUNE_ITERATIONS steps: the loss falls.
    Returns {path: launches}."""
    import math

    import torch
    from calipso_tpu_torch.apps import autotuning
    from calipso_tpu_torch.apps.mpc import make_mpc_controller, mpc_rollout

    out = {}
    phase(f"14a: pendulum MPC (B={B_MPC}, {MPC_STEPS} steps, float32)")
    ts, guess, simulate = pendulum_mpc_solver(Options, "cuda")
    rng = np.random.default_rng(0)
    x0 = np.array([math.pi, 0.0]) + 0.3 * rng.uniform(-1.0, 1.0, size=(B_MPC, 2))
    ctrl = make_mpc_controller(ts, guess, lambda x: x)
    zero_launches(cr)
    roll, wall = timed(lambda: mpc_rollout(ctrl, simulate, torch.tensor(x0, dtype=torch.float32, device=dev), MPC_STEPS))
    out["pendulum_mpc"] = launches = dict(cr.LAUNCHES)
    check_route(tag, "pendulum MPC", launches)
    its = roll.iterations.float()
    final = roll.states[:, -1].double()
    gap = ((final[:, 0] - math.pi).abs().max().item(), final[:, 1].abs().max().item())
    print(
        f"{tag} pendulum MPC: {MPC_STEPS} steps of {B_MPC} lanes in {wall:.2f} s ({1e3 * wall / MPC_STEPS:.1f} ms a "
        f"step); unsolved lane-steps {int((~roll.solved).sum())}; mean iterations step 0 {float(its[:, 0].mean()):.3f}, "
        f"after {float(its[:, 1:].mean()):.3f} (lanes whose warm mean exceeds their cold step: "
        f"{int((its[:, 1:].mean(1) > its[:, 0]).sum())}); final |theta - pi| <= {gap[0]:.3e} (limit "
        f"{MPC_BOUNDS[0]:g}), |omega| <= {gap[1]:.3e} (limit {MPC_BOUNDS[1]:g})"
    )
    check(roll.states.dtype == torch.float32 and bool(torch.isfinite(roll.states).all()), "MPC: states")
    check(bool(roll.solved.all()), "MPC: a lane did not solve at some step")
    check(gap[0] < MPC_BOUNDS[0] and gap[1] < MPC_BOUNDS[1], "MPC: a final state outside the test's bounds")
    check(float(its[:, 1:].mean()) <= float(its[:, 0].mean()), "MPC: warm steps cost more than the cold one")

    phase(f"14b: cart-pole auto-tuning (B={B_TUNE}, float64, max_iterations={TUNE_ITERATIONS})")
    loss, w0, x0t, pol, ts = cartpole_tuning(Options, "cuda", B_TUNE)
    check(ts.solver.options.linear_solver == "schur" and ts.num_variables == 19, f"tuning n={ts.num_variables}")
    zero_launches(cr)
    (w, history), wall = timed(lambda: autotuning.autotune(loss, w0, x0t, max_iterations=TUNE_ITERATIONS))
    out["cartpole_tuning"] = launches = dict(cr.LAUNCHES)
    check_route(tag, "cart-pole tuning", launches)
    print(
        f"{tag} cart-pole tuning: loss history {history} in {wall:.2f} s; weights {w.tolist()}; the last "
        f"solve's lanes solved {int(pol.solve.state.solved.sum())}/{B_TUNE}"
    )
    check(all(math.isfinite(v) for v in history) and history[-1] < history[0], "tuning: the loss did not fall")
    check(bool(pol.solve.state.solved.all()), "tuning: a lane of the last solve did not solve")
    return out


def rank_numbers(res, wall, cr, bts, collectives):
    """What a rank of 16a or 16b sends back: its state, wall and launches,
    its loop tests (host syncs) and its collectives, each of which is a
    device-to-host sync as well (gloo stages through host memory)."""
    return {
        "state": res.state, "wall": wall, "launches": dict(cr.LAUNCHES), "host_syncs": bts.stats["host_syncs"],
        "collectives": collectives,
    }


def sharded_flagship_rank(mesh):
    """16a on one rank: the flagship batch through mesh=, this rank's
    launches counted from 0 just before."""
    import torch
    from calipso_tpu_torch import Options
    from calipso_tpu_torch.ops import cuda_riccati as cr

    bts = flagship(tol_options(Options), mesh.device)
    x0s = torch.tensor(flagship_scenarios(), device=mesh.device)
    zero_launches(cr)
    collectives = mesh.collectives
    t0 = time.time()
    res = bts.solve(parameters=x0s, mesh=mesh)
    torch.cuda.synchronize(mesh.device)
    wall = time.time() - t0
    return rank_numbers(res, wall, cr, bts, mesh.collectives - collectives)


def dryrun_rank(mesh):
    """16c on one rank: parallel/dryrun's parts in float32, each with this
    rank's launches counted from 0 just before it and its wall."""
    import torch
    from calipso_tpu_torch.ops import cuda_riccati as cr
    from calipso_tpu_torch.parallel import dryrun

    out, launches, walls = {}, {}, {}
    for name, part in zip(("batch", "spike", "contact"), dryrun.PARTS):
        zero_launches(cr)
        t0 = time.time()
        out.update(part(mesh, torch.float32))
        torch.cuda.synchronize(mesh.device)
        walls[name] = time.time() - t0
        launches[name] = dict(cr.LAUNCHES)
    return {"out": out, "launches": launches, "walls": walls}


def flagship_and_dryrun_rank(mesh):
    """16a, then 16c, on one rank of the same group."""
    return {"16a": sharded_flagship_rank(mesh), "16c": dryrun_rank(mesh)}


def spike_scenarios():
    """16b's initial states (B_SPIKE, 2), float64."""
    return 0.2 * np.random.default_rng(1).normal(size=(B_SPIKE, 2))


def spike_rank(mesh):
    """16b on one rank: the pendulum at horizon 44 on spike in float64 over
    the ranks of `mesh`, this rank's launches counted from 0 just before."""
    import torch
    from calipso_tpu_torch import Options
    from calipso_tpu_torch.ops import cuda_riccati as cr

    bts = pendulum_solver(tol_options(Options, linear_solver="spike", spike_mesh=mesh), mesh.device, HORIZON_DIFF).batched()
    th = torch.tensor(spike_scenarios(), device=mesh.device)
    zero_launches(cr)
    collectives = mesh.collectives
    t0 = time.time()
    res = bts.solve(parameters=th)
    torch.cuda.synchronize(mesh.device)
    wall = time.time() - t0
    return rank_numbers(res, wall, cr, bts, mesh.collectives - collectives)


def same_bits_on_every_rank(name, trees):
    """Every rank's result tree holds the same bits (NaN where rank 0 has)."""
    import torch
    import torch.utils._pytree as pytree

    tensors = lambda tree: [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]
    for rank, tree in enumerate(trees[1:], 1):
        for a, b in zip(tensors(trees[0]), tensors(tree), strict=True):
            check(
                a.shape == b.shape and bool(torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())),
                f"{name}: rank {rank}'s result differs from rank 0's",
            )


def rank_report(tag, name, ranks, path_launches):
    """Each rank's wall, host syncs (loop tests, and the collectives apart)
    and launches; its route checked."""
    for rank, r in enumerate(ranks):
        print(
            f"{tag} {name} rank {rank}: {r['wall']:.3f} s, host syncs {r['host_syncs']} loop tests "
            f"+ {r['collectives']} collectives"
        )
        check_route(tag, name, r["launches"])
        path_launches[f"{name} rank {rank}"] = r["launches"]


def parallel_phase(tag, cr, Options, dev, phase, flagship_state):
    """Phase 16: more than one rank on the one card (parallel/mesh.launch,
    every rank on cuda:0, gloo). Returns {path rank r: launches}."""
    import torch
    from calipso_tpu_torch.parallel import dryrun, mesh as pm

    device = str(torch.device(dev.type, dev.index or 0))  # cuda:0
    paths = {}
    phase(f"16a: the flagship sharded over {SHARD_RANKS} ranks (mesh=), then 16c: the dry run (float32)")
    t0 = time.time()
    ranks = pm.launch(flagship_and_dryrun_rank, SHARD_RANKS, axis="batch", device=device)
    print(f"{tag} 16a+16c: {SHARD_RANKS} ranks spawned, solved and joined in {time.time() - t0:.1f} s")
    sharded = [r["16a"] for r in ranks]
    same_bits_on_every_rank("16a flagship sharded", [r["state"] for r in sharded])
    rank_report(tag, "flagship sharded", sharded, paths)
    st, ref = sharded[0]["state"], flagship_state
    solved, _ = report_solve(f"{tag} flagship sharded over {SHARD_RANKS} ranks", B_FLAG, st)
    ref_solved = ref.solved.cpu()
    both = st.solved & ref_solved
    moved = int((st.solved ^ ref_solved).sum())
    gap = float((st.p.x[both] - ref.p.x.cpu()[both]).abs().max())
    print(
        f"{tag} flagship sharded against phase 3's batch: {int(both.sum())} lanes solved in both, {moved} "
        f"solved in one only; states {gap:.3e} apart (limit {CPU_ATOL_FLAG:g})"
    )
    check(int(solved.sum()) >= MIN_SOLVED_FLAG, f"16a: only {int(solved.sum())} of {B_FLAG} lanes solved")
    check(moved <= B_FLAG - MIN_SOLVED_FLAG and gap <= CPU_ATOL_FLAG, "16a: the sharded batch is not phase 3's")

    runs = [r["16c"] for r in ranks]
    outs = [r["out"] for r in runs]
    same_bits_on_every_rank("16c dry run", [(o["loss"], o["grad"], o["spike_x"], o["riccati_x"]) for o in outs])
    for o in outs:
        dryrun.check(o)
    for rank, r in enumerate(runs):
        for part, launches in r["launches"].items():
            check_route(tag, f"dryrun {part}", launches)
            paths[f"dryrun {part} rank {rank}"] = launches
        print(f"{tag} 16c rank {rank}: walls {r['walls']}")
    print(f"{tag} 16c: {dryrun.summary(SHARD_RANKS, outs[0])}")

    phase(f"16b: pendulum horizon {HORIZON_DIFF} on spike over {SPIKE_RANKS} ranks (float64, B={B_SPIKE})")
    t0 = time.time()
    ranks = pm.launch(spike_rank, SPIKE_RANKS, axis="horizon", device=device)
    print(f"{tag} 16b: {SPIKE_RANKS} ranks spawned, solved and joined in {time.time() - t0:.1f} s")
    same_bits_on_every_rank("16b spike", [r["state"] for r in ranks])
    rank_report(tag, "pendulum n=131 spike", ranks, paths)
    st = ranks[0]["state"]
    report_solve(f"{tag} pendulum n=131 spike", B_SPIKE, st)
    th = torch.tensor(spike_scenarios(), device=dev)
    bts = pendulum_solver(tol_options(Options, linear_solver="riccati"), dev, HORIZON_DIFF).batched()
    ref, wall = timed(lambda: bts.solve(parameters=th))
    ref = ref.state
    print(f"{tag} pendulum n=131 riccati, the same batch in this process: {wall:.3f} s, host syncs {bts.stats['host_syncs']}")
    report_solve(f"{tag} pendulum n=131 riccati", B_SPIKE, ref)
    solved = ref.solved.cpu()
    gap = float((st.p.x[solved] - ref.p.x.cpu()[solved]).abs().max())
    iters_differ = int((st.total_i != ref.total_i.cpu()).sum())
    print(f"{tag} 16b spike against riccati: lanes whose iterations differ {iters_differ}; states {gap:.3e} apart")
    check(torch.equal(st.solved, solved), "16b: spike and riccati solved other lanes")
    check(iters_differ == 0 and gap <= SPIKE_ATOL, "16b: spike is not riccati's solve")
    return paths


def kernel_phases(tag, cr, dev, phase):
    """Phases 2 and 5: every kernel against its plain version, then the
    kernel times. Returns (errs, times, contact times), which the kernels
    line reads."""
    errs, times, times64 = {}, {}, {}
    # 2a. T=1 kernels against their plain versions at the flagship shape
    phase("2: kernels against their plain versions")
    check_t1(tag, cr, dev, errs, times, times64)

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
    for B, T, d in FUSED_WORKSPACE_SHAPES:
        check_batched(tag, cr, dev, B, T, d, errs)
    for B, T, d in BATCHED_SHAPES:
        check_transpose(tag, cr, dev, B, T, d, errs)
    # 2e. the kernels at the contact models' shapes (phase 11)
    phase("2e: kernels at the contact models' shapes")
    ctimes = contact_kernel_checks(tag, cr, dev, errs)

    # 5. kernel times at the main-path shapes, and the two block-tridiagonal
    # routes side by side at the quadruped's and the rocket's shapes and at
    # the widths between them
    phase("5: kernel times")
    for B, T, d in ((B_QUAD, HORIZON_QUAD, 54), (B_ROCKET, HORIZON_ROCKET, 9)) + ROUTE_SHAPES:
        routes_timed_at(tag, cr, dev, B, T, d)
    for B, T, d in BATCHED_SHAPES:
        main_path = (B, T, d) == BATCHED_SHAPES[0]
        batched_timed_at(tag, cr, dev, B, T, d, times if main_path else None, times64 if main_path else None)
    graph_times(tag, cr, dev, routes=("fused",))
    library = {
        "rocket": library_times(cr, dev, B_ROCKET, HORIZON_ROCKET, 9),
        "quadruped": library_times(cr, dev, B_QUAD, HORIZON_QUAD, 54),
    }
    for kname, (cell, call) in LIBRARY_CALLS.items():
        ms, plain_ms, _, bnd = times[kname]
        times[kname] = (ms, plain_ms, library[cell][call], bnd)
        print(f"{tag} {kname}: library yardstick {LIBRARY_NAMES[call]} on the dense {cell} matrices")
    for kname, (ms, plain_ms, lib_ms, (bms, by)) in times.items():
        library = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(
            f"{tag} {kname} float32 main-path shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library}, bound {bms * 1e3:.2f} us ({by}), {100.0 * bms / ms:.1f}% of the bound"
        )
    print_times(tag, times64, "float64")
    contact = contact_kernel_times(tag, cr, dev, ctimes)
    return errs, times, contact


def flagship_scenarios():
    """The flagship's initial states, float32 (bench.py: a fresh
    default_rng(0))."""
    return (0.2 * np.random.default_rng(0).normal(size=(B_FLAG, 2))).astype(np.float32)


def flagship_phase(tag, cr, Options, dev):
    """Phase 3: the flagship batch on the card; returns its launches and
    its state."""
    import torch

    bts = flagship(tol_options(Options), "cuda")
    x0_np = flagship_scenarios()
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
    return launches, st


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


def full_run(tag, card, cr, rc, Options, dev, phase, t_start):
    """Every phase after the build, in order, then the kernels line and
    the result."""
    import torch

    errs, times, contact_times = kernel_phases(tag, cr, dev, phase)

    # 3. the flagship on the card (schur backend), counting kernel launches
    phase("3: flagship")
    launches, flagship_state = flagship_phase(tag, cr, Options, dev)

    # 4. the batched rocket landing on the card (riccati backend)
    phase("4: rocket")
    rlaunches, captured = rocket_phase(tag, cr, rc, Options, dev)

    # 8. the solve_batched entry point on the rocket batch's own blocks
    phase(f"8: solve_batched (the blocks of riccati factorization {min(CAPTURE_CALL, captured['calls'])} of the rocket batch)")
    blaunches = solve_batched_phase(tag, cr, rc, *captured["blocks"])
    # 9. the cr backend
    phase("9: cr backend (rocket101, its golden, the rocket batch)")
    examples = {"rocket_landing": cr_phase(tag, cr, Options, dev)}
    # 10. the ldl and lu backends and the refinement fallback
    phase("10: ldl, lu and refinement_fallback (pendulum B=1024, float64)")
    dense_phase(tag, cr, Options, dev)
    phase("10: refinement_fallback firing (every 4th lane's schur factor broken)")
    fallback_fires_phase(tag, cr, Options, dev)
    # 12. the routes past the kernels' widths
    phase("12: past n=128 and d=64: schur at n=131 (float64), 221 and 155 (float32 batches), the stream kernels and the scan")
    path_launches_wide = wide_routes_phase(tag, cr, rc, Options, dev)

    # 13. implicit differentiation; 14. MPC and auto-tuning
    app_launches = differentiation_phase(tag, cr, Options, dev, phase)
    app_launches.update(apps_phase(tag, cr, Options, dev, phase))

    # 6. the batched quadruped on the card (riccati backend, stream route)
    qlaunches, quadruped_against_cpu = quadruped_phase(tag, cr, Options, dev, phase)

    # 11. the contact models on the card; 7. the quadruped gait golden and
    # the CPU float64 re-solves, beside the hopper batch's cold batch
    path_launches = contact_phases(tag, cr, Options, dev, phase, quadruped_against_cpu, t_start, examples)
    path_launches.update(path_launches_wide)
    path_launches.update(app_launches)

    # 15. the examples, those earlier phases ran read from their summaries
    path_launches.update(examples_phase(tag, cr, dev, phase, examples))

    # 16. more than one rank on the one card
    path_launches.update(parallel_phase(tag, cr, Options, dev, phase, flagship_state))

    sources = {
        "t1": "calipso_tpu_torch/csrc/riccati_t1.cu",
        "lanes": "calipso_tpu_torch/csrc/riccati_lanes.cu",
        "stream": "calipso_tpu_torch/csrc/riccati_stream.cu",
        "fused": "calipso_tpu_torch/csrc/riccati_fused.cu",
    }
    rocket = (B_ROCKET, HORIZON_ROCKET, 9)  # the lanes and fused kernels' main-path shape
    quad = STREAM_SHAPES[0]  # the stream kernels'
    meta = {
        "factor_t1": ("t1", "calipso_tpu/ops/pallas_riccati.py:633", launches, ("factor_t1", "float32", B_FLAG, 32)),
        "solve_t1": ("t1", "calipso_tpu/ops/pallas_riccati.py:661", launches, ("solve_t1", "float32", B_FLAG, 32)),
        "factor_lanes": ("lanes", "calipso_tpu/ops/pallas_riccati.py:489", rlaunches, ("factor_lanes", "float32", *rocket)),
        "solve_lanes": ("lanes", "calipso_tpu/ops/pallas_riccati.py:583", rlaunches, ("solve_lanes", "float32", *rocket)),
        "factor_stream": ("stream", "calipso_tpu/ops/pallas_riccati.py:813", qlaunches, ("factor_stream", "float32", *quad)),
        "solve_fwd_stream": ("stream", "calipso_tpu/ops/pallas_riccati.py:1081", qlaunches, ("solve_fwd_stream", "float32", *quad)),
        "solve_bwd_stream": ("stream", "calipso_tpu/ops/pallas_riccati.py:1169", qlaunches, ("solve_bwd_stream", "float32", *quad)),
        "solve_batched_fused": ("fused", "calipso_tpu/ops/pallas_riccati.py:117", blaunches, ("solve_batched_fused", "float32", *rocket)),
        "solve_batched_lanes": ("fused", "calipso_tpu/ops/pallas_riccati.py:245", blaunches, ("solve_batched_lanes", "float32", *rocket)),
        # the layout moves the reference leaves to XLA around _riccati_lanes_kernel
        "transpose": ("fused", "calipso_tpu/ops/pallas_riccati.py:295", blaunches, ("transpose", "float32", *rocket)),
    }
    errs[("factor_lanes", "float32", *rocket)] = max(
        errs[("factor_lanes", "float32", *rocket)], errs[("factor_lanes M", "float32", *rocket)]
    )
    errs[("factor_stream", "float32", *quad)] = max(
        errs[("factor_stream", "float32", *quad)], errs[("factor_stream M", "float32", *quad)]
    )
    kernels = []
    for k, (src, replaces, counts, err_key) in meta.items():
        ms, plain_ms, lib_ms, (bms, by) = times[k]
        kernels.append({
            "name": k, "route": "cuda", "source": sources[src], "replaces": replaces,
            "launches": counts[k], "max_abs_err": errs[err_key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_us": bms * 1e3, "bound_by": by, "library_ms": lib_ms,
            "launches_by_path": {path: on_path[k] for path, on_path in path_launches.items()},
            "at_other_shapes": [
                {"shape": shape, "dtype": name, "ms": ms_c, "graph_ms": gms, "plain_ms": pms, "library_ms": lms,
                 "bound_ms": bnd[0], "bound_by": bnd[1]}
                for (kn, name, shape), (ms_c, gms, pms, lms, bnd) in contact_times.items() if kn == k
            ],
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


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port's main paths on one NVIDIA GPU (no arguments: every phase).")
    ap.add_argument(
        "--stream-times", action="store_true",
        help="only build, then check and time the T=1 kernels at the flagship's shape, the stream kernels at "
        "the quadruped's, the lanes kernels at the rocket's (B=1024 and 128) and the fused solves at both, "
        "float32 and float64",
    )
    ap.add_argument(
        "--t1-times", action="store_true",
        help="only build, then check and time the T=1 kernels at n = 33, 64, 65, 96, 110 and 128, B = 1024 and 1, "
        "float32 and float64, and at phase 12's wide shapes, host-launched and replayed from a CUDA graph, beside "
        "their plain versions and cholesky_ex / cholesky_solve",
    )
    ap.add_argument(
        "--batched-times", action="store_true",
        help="only build, then time the two fused solves (and the lanes wrapper's layout copies) at the rocket's "
        "and the quadruped's shapes, float32 and float64, and replayed from a CUDA graph at the rocket's",
    )
    ap.add_argument(
        "--sass", action="store_true",
        help="only compile csrc/riccati_fused.cu to a cubin and print its register kernel's static instructions "
        "and stage loops (no card needed)",
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
    if args.sass:  # the compiler alone: no card needed
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sass_loops("[sass]")
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
    if args.t1_times:
        t1_times(tag, cr, dev)
        return 0
    if args.batched_times:
        for B, T, d in BATCHED_SHAPES:
            times, times64 = {}, {}
            batched_timed_at(tag, cr, dev, B, T, d, times, times64)
        graph_times(tag, cr, dev, routes=("fused",))
        return 0
    if args.history is not None:
        history_probe(tag, cr, rc, Options, dev, groups, phase, args.ops_out, args.linalg)
        return 0
    return full_run(tag, card, cr, rc, Options, dev, phase, t_start)


if __name__ == "__main__":
    sys.exit(main())
