"""The port's contact models (hopper, ball-in-cup, box, bunny hop) against
the JAX package on the CPU in float64.

- Every stage function of every model (objective, dynamics, the hopper's
  carried variants too, equality, nonnegative, second-order cones and
  `equality_general`; the bunny hop's flat objective, equality and
  inequality): value and Jacobian at seeded points, one parametrised
  test over (model, function).
- The hopper's structured oracles (g, h, gx, hx and the stage-block
  Lagrangian Hessian) at a short horizon, the JAX side jitted.
- A ball-in-cup solve at the reference test's size and a short-horizon
  hopper gait in both packages: the same solved flag, iterations within
  the +-15% band of `tests/test_golden.py`, states within 1e-2.
- A B=2 batched hopper gait at a short horizon in the port: each lane
  gives its single solve's iterations and solution to 1e-9 (the border
  is carried lane by lane through the inertia ladder).
- The reference's `slow` tests in the port (`slow` here too): the
  full-size hopper gait and its golden, the box move and the bunny hop.
  The hopper's golden pins the reference's exact bits: from a guess
  scaled by 1 + k 1e-15 the reference itself ends on other local
  solutions, and the port, whose arithmetic differs in the last bits,
  follows the reference's path until the gait's sensitivity parts them
  (two more `slow` tests show both); so the port is held to the golden's
  iteration band only where it lands on the golden.

A single reference solve never reaches a Pallas kernel (`_use_pallas`
asks for a TPU and a batch of at least 32), so the JAX side solves
through XLA's scan and Cholesky, as the reference's own tests do.
"""

import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev, vmap

import calipso_tpu
import calipso_tpu_torch
from calipso_tpu.models import ball_in_cup as jball
from calipso_tpu.models import box as jbox
from calipso_tpu.models import bunnyhop as jbh
from calipso_tpu.models import hopper as jhop
from calipso_tpu_torch.models import ball_in_cup as tball
from calipso_tpu_torch.models import box as tbox
from calipso_tpu_torch.models import bunnyhop as tbh
from calipso_tpu_torch.models import hopper as thop
from calipso_tpu_torch.utils.convert import options_from_jax

from tests.test_solver_nlp import assert_contract

# Tier-1 runs several pytest workers on few CPUs: one torch thread each
torch.set_num_threads(1)

MODEL_ATOL = 1e-10  # the same float64 arithmetic, up to summation order
ORACLE_ATOL = 1e-9
POINTS = 4
SPREAD = 0.1  # seeded points: the model's guess plus SPREAD * N(0, 1)
STATE_ATOL = 1e-2  # tests/test_golden.py's contact states
BAND = 0.15  # tests/test_golden.py's iteration band
LANE_ATOL = 1e-9
GUESS_KEYS = ("state_guess", "state_initial", "state_goal", "action_guess", "penalty_initial")

# model -> (JAX module, port module, builder, its arguments); the short
# horizons keep the JAX problems small, and each stage function is the
# same at any horizon (ball-in-cup's waypoints need 17 stages)
TRAJOPT_MODELS = {
    "hopper": (jhop, thop, "gait_problem", dict(horizon=4)),
    "hopper_carried": (jhop, thop, "gait_problem", dict(horizon=4, carry_first_state=True)),
    "ball_in_cup": (jball, tball, "problem", dict(horizon=21)),
    "box": (jbox, tbox, "move_problem", dict(horizon=4)),
}
STAGE_KINDS = ("objective", "dynamics", "equality", "nonnegative", "second_order")


def _distinct(fns):
    """(stage, index in the stage, function) of the first appearance of
    each distinct function of a per-stage list (second-order: a list of
    lists)."""
    seen, out = set(), []
    for t, f in enumerate(fns):
        for k, g in enumerate(f if isinstance(f, list) else [f]):
            if g is not None and id(g) not in seen:
                seen.add(id(g))
                out.append((t, k))
    return out


def _cases():
    cases = []
    for model, (jm, _, build, kw) in TRAJOPT_MODELS.items():
        prob = getattr(jm, build)(**kw)
        for kind in STAGE_KINDS:
            cases += [(model, kind, t, k) for t, k in _distinct(prob.get(kind) or [])]
        if prob.get("equality_general") is not None:
            cases.append((model, "equality_general", 0, 0))
    return cases + [("bunnyhop", kind, 0, 0) for kind in ("objective", "equality", "inequality")]


def _pick(prob, kind, t, k):
    f = prob[kind] if kind == "equality_general" else prob[kind][t]
    return f[k] if isinstance(f, list) else f


def _flat_guess(prob):
    """The interleaved [x_1, u_1, ..., x_T] guess of a trajopt problem."""
    T = len(prob["num_states"])
    acts = prob.get("action_guess") or [np.zeros(n) for n in prob["num_actions"]]
    parts = []
    for t in range(T):
        parts.append(np.asarray(prob["state_guess"][t], float))
        if t < T - 1:
            parts.append(np.asarray(acts[t], float))
    return np.concatenate(parts)


def _case_inputs(model, kind, t, k, rng):
    """(JAX function, port function, seeded argument arrays, the argument
    numbers to differentiate by)."""
    if model == "bunnyhop":
        z = jbh.initial_guess(0)[None] + SPREAD * rng.normal(size=(POINTS, jbh.NZ))
        return getattr(jbh, kind), getattr(tbh, kind), [z], (0,)
    jm, tm, build, kw = TRAJOPT_MODELS[model]
    jprob, tprob = getattr(jm, build)(**kw), getattr(tm, build)(**kw)
    jf, tf = _pick(jprob, kind, t, k), _pick(tprob, kind, t, k)
    ns, na = jprob["num_states"], jprob["num_actions"]
    acts = jprob.get("action_guess") or [np.zeros(n) for n in na]

    def near(base):
        base = np.asarray(base, float)
        return base[None] + SPREAD * rng.normal(size=(POINTS, base.size))

    if kind == "equality_general":
        z = near(_flat_guess(jprob))
        return jf, tf, [z, np.zeros((POINTS, 0))], (0,)
    x = near(jprob["state_guess"][t])
    u = near(acts[t]) if t < len(na) else np.zeros((POINTS, 0))
    if kind == "dynamics":
        return jf, tf, [near(jprob["state_guess"][t + 1]), x, u], (0, 1, 2)
    return jf, tf, [x, u], (0, 1)


@pytest.mark.parametrize("model,kind,t,k", _cases())
def test_stage_function_and_jacobian_match_jax(model, kind, t, k):
    rng = np.random.default_rng(zlib.crc32(f"{model} {kind} {t} {k}".encode()))
    jf, tf, args, argnums = _case_inputs(model, kind, t, k, rng)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.tensor(a) for a in args]
    vj, Jj = jax.jit(jax.vmap(lambda *a: (jf(*a), jax.jacrev(jf, argnums=argnums)(*a))))(*jargs)
    np.testing.assert_allclose(vmap(tf)(*targs).numpy(), np.asarray(vj), atol=MODEL_ATOL, rtol=0)
    Jt = vmap(jacrev(tf, argnums=argnums))(*targs)
    for a, b in zip(Jt, Jj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=MODEL_ATOL, rtol=0)


# ---- the hopper's structured oracles ---------------------------------------


def _trajopt(pkg, prob, options, actions=None):
    """A TrajOptSolver of `pkg` (calipso_tpu or calipso_tpu_torch) on the
    problem dict `prob`, the port's on the CPU."""
    extra = {}
    if pkg is calipso_tpu_torch:
        options, extra = options_from_jax(options), dict(device="cpu")
    ts = pkg.TrajOptSolver(options=options, **extra, **{k: v for k, v in prob.items() if k not in GUESS_KEYS})
    ts.initialize_states(prob["state_guess"])
    if actions is not None or "action_guess" in prob:
        ts.initialize_actions(actions if actions is not None else prob["action_guess"])
    return ts


def test_hopper_structured_oracles_match_jax():
    """gait_problem(horizon=3): g, h, gx, hx and the stage-block Hessian
    blocks (D, O and the border's general-equality Hessian) at one seeded
    primal-dual point of two lanes, the JAX side jitted."""
    tj, tt = (_trajopt(pkg, m.gait_problem(horizon=3), calipso_tpu.Options(linear_solver="riccati"))
              for pkg, m in ((calipso_tpu, jhop), (calipso_tpu_torch, thop)))
    js, ts = tj.solver, tt.solver
    assert ts.options.linear_solver == "riccati" and ts.fns.stage_structure.dmax == 26
    dims = ts.dims
    assert dims == js.dims
    rng = np.random.default_rng(2)
    B = 2
    x = np.asarray(tt._guess)[None] + 0.05 * rng.normal(size=(B, dims.variables))
    th = rng.normal(size=(B, dims.parameters))
    y = rng.normal(size=(B, dims.equality))
    z = rng.normal(size=(B, dims.cone))
    jf, tf = js.fns, ts.fns
    names = ("g", "h", "gx", "hx")

    def oracles(x, th, y, z):
        return tuple(getattr(jf, k)(x, th) for k in names) + tuple(jf.lagrangian_hessian_blocks(x, th, y, z, True))

    want = jax.jit(jax.vmap(oracles))(x, th, y, z)
    T = lambda a: torch.tensor(a)
    got = tuple(getattr(tf, k)(T(x), T(th)) for k in names) + tuple(
        tf.lagrangian_hessian_blocks(T(x), T(th), T(y), T(z))
    )
    assert len(got) == len(want) == 7
    for name, g, w in zip(names + ("D", "O", "general"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ORACLE_ATOL, rtol=0, err_msg=name)


# ---- solves in both packages ---------------------------------------------------


def _states(ts, z):
    return np.concatenate([np.asarray(z)[idx] for idx in ts._state_indices])


def _same_solve(tj, tt, rj, rt):
    """The port's solve `rt` against the reference's `rj`: the same solved
    flag, iterations within the band, states within STATE_ATOL."""
    assert bool(rt.solved) == bool(rj.solved)
    ref = int(rj.iterations)
    assert (1 - BAND) * ref <= int(rt.iterations) <= (1 + BAND) * ref, (int(rt.iterations), ref)
    np.testing.assert_allclose(_states(tt, rt.variables.numpy()), _states(tj, rj.variables), atol=STATE_ATOL)


def _ball_actions():
    """tests/test_contact.py:test_ball_in_cup's action guess."""
    rng = np.random.default_rng(0)
    return [np.concatenate([1e-3 * rng.normal(size=2), 1e-3 * np.ones(1)]) for _ in range(20)]


def test_ball_in_cup_matches_jax():
    """tests/test_contact.py:test_ball_in_cup (T=21, default Options, lanes
    route at d=12) in both packages; the port's solve also meets the
    reference test's assertions (the contract and the string length)."""
    tj, tt = (_trajopt(pkg, m.problem(), calipso_tpu.Options(), _ball_actions())
              for pkg, m in ((calipso_tpu, jball), (calipso_tpu_torch, tball)))
    assert tt.solver.options.linear_solver == "riccati" and tt.solver.fns.stage_structure.dmax == 12
    rj, rt = tj.solve(), tt.solve()
    _same_solve(tj, tt, rj, rt)
    assert_contract(rt)
    for x in tt.get_trajectory(rt)[0]:
        d = x[4:6] - x[6:8]
        assert d @ d <= tball.STRING_LENGTH**2 + 1e-3


def test_short_hopper_gait_matches_jax():
    """gait_problem(horizon=6) with default Options in both packages: the
    riccati backend at d=26 with the 4-row general-equality border."""
    tj, tt = (_trajopt(pkg, m.gait_problem(horizon=6), calipso_tpu.Options())
              for pkg, m in ((calipso_tpu, jhop), (calipso_tpu_torch, thop)))
    st = tt.solver.fns.stage_structure
    assert tt.solver.options.linear_solver == "riccati" and st.dmax == 26 and st.num_general == 4
    rj, rt = tj.solve(), tt.solve()
    _same_solve(tj, tt, rj, rt)
    assert bool(rt.solved)


def test_hopper_batch_matches_single_solves():
    """A B=2 batch of gait_problem(horizon=4) on riccati in the port, each
    lane's guess the problem's guess plus 0.01 N(0, 1): every lane gives
    its single solve's solved flag, iterations and solution (to 1e-9)."""
    opts = calipso_tpu.Options(linear_solver="riccati", line_search_mode="serial")
    ts = _trajopt(calipso_tpu_torch, thop.gait_problem(horizon=4), opts)
    assert ts.solver.fns.stage_structure.num_general == 4
    g0 = np.asarray(ts._guess)
    guesses = torch.tensor(g0[None] + 0.01 * np.random.default_rng(0).normal(size=(2, g0.size)))
    st = ts.batched().solve(guess=guesses).state
    for lane in range(2):
        r = ts.solver.solve(x0=guesses[lane])
        assert bool(r.solved) and bool(st.solved[lane])
        assert int(r.iterations) == int(st.total_i[lane])
        np.testing.assert_allclose(st.p.x[lane].numpy(), r.variables.numpy(), atol=LANE_ATOL, rtol=0)


# ---- the reference's slow tests, in the port -----------------------------------


def _hopper_gait_asserts(ts, res):
    """tests/test_contact.py:test_hopper_gait's assertions."""
    assert_contract(res)
    states, actions = ts.get_trajectory(res)
    assert states[-1][0] - states[0][0] >= 0.5 - 1e-4
    for u in actions:
        assert abs(u[7]) <= u[6] + 1e-6
        assert abs(u[9]) <= u[8] + 1e-6


@pytest.mark.slow
def test_hopper_gait():
    """tests/test_contact.py:test_hopper_gait in the port."""
    ts = _trajopt(calipso_tpu_torch, thop.gait_problem(horizon=21), calipso_tpu.Options())
    _hopper_gait_asserts(ts, ts.solve())


@pytest.mark.slow
def test_reference_hopper_golden_depends_on_the_last_bit():
    """The reference's own hopper gait, from its guess scaled by
    1 + (-1)^k k 1e-15 for k = 1..24, ends on local solutions other than
    its golden: the golden pins the reference's exact bits, not the
    problem's solution. Prints each solve and the distinct solutions
    (states more than 1e-2 apart); run with -s to read them."""
    gold = np.load(os.path.join(os.path.dirname(__file__), "golden", "hopper_gait.npz"))
    ts = _trajopt(calipso_tpu, jhop.gait_problem(), calipso_tpu.Options())
    g0 = np.asarray(ts._guess)
    found = [_states(ts, gold["variables"])]
    off = 0
    for k in range(1, 25):
        r = ts.solver.solve(x0=jnp.asarray(g0 * (1 + (-1) ** k * k * 1e-15)))
        x = _states(ts, r.variables)
        gaps = [np.abs(x - f).max() for f in found]
        off += bool(r.solved) and gaps[0] > STATE_ATOL
        if min(gaps) > STATE_ATOL:
            found.append(x)
        print(f"k={k}: solved {bool(r.solved)}, {int(r.iterations)} iterations, {gaps[0]:.3e} from the golden")
    print(f"{len(found)} distinct solutions (the golden's included)")
    assert off >= 12
@pytest.mark.slow
def test_hopper_gait_follows_the_reference_until_it_branches():
    """The full hopper gait (default Options) in both packages, each inner
    step's merit recorded: the two agree to 1e-10 (relative) over the
    first 40 steps, the port's float64 arithmetic differing from the
    reference's only in the last bits; prints the first step at which
    they part by more than 1e-6, where the gait's sensitivity has
    amplified those bits into another path (run with -s)."""
    merits = []
    for pkg, m in ((calipso_tpu, jhop), (calipso_tpu_torch, thop)):
        ts = _trajopt(pkg, m.gait_problem(), calipso_tpu.Options())
        rec = []
        ts.solver.callbacks(inner=lambda d, rec=rec: rec.append(float(np.asarray(d["merit"]).reshape(-1)[0])))
        r = ts.solve()
        merits.append(np.array(rec))
        print(f"{pkg.__name__}: solved {bool(r.solved)} in {int(r.iterations)} iterations")
    n = min(map(len, merits))
    rel = np.abs(merits[0][:n] - merits[1][:n]) / np.abs(merits[0][:n])
    apart = np.nonzero(rel > 1e-6)[0]
    print(f"largest relative merit gap over the first 40 steps {rel[:40].max():.3e}; first step apart by "
          f"more than 1e-6: {apart[0] if apart.size else None}")
    assert rel[:40].max() <= 1e-10


@pytest.mark.slow
def test_golden_hopper_gait():
    """tests/test_golden.py:test_golden_hopper_gait in the port: on the
    golden (states within 1e-2) the iterations are held to its band; the
    port's float64 arithmetic differs from the reference's in the last
    bits, and the gait then lands on another local solution (as the
    reference does from a guess 1e-15 away), which must meet the contract
    and test_hopper_gait's travel and friction."""
    gold = np.load(os.path.join(os.path.dirname(__file__), "golden", "hopper_gait.npz"))
    ts = _trajopt(calipso_tpu_torch, thop.gait_problem(), calipso_tpu.Options())
    r = ts.solve()
    _hopper_gait_asserts(ts, r)
    gap = np.abs(_states(ts, r.variables.numpy()) - _states(ts, gold["variables"])).max()
    print(f"the port's hopper gait: {int(r.iterations)} iterations, {gap:.3e} from the golden")
    if gap <= STATE_ATOL:
        ref = int(gold["iterations"])
        assert (1 - BAND) * ref <= int(r.iterations) <= (1 + BAND) * ref


@pytest.mark.slow
def test_box_move():
    """tests/test_contact.py:test_box_move in the port (T=11, the stream
    route at d=33)."""
    prob = tbox.move_problem(horizon=11)
    ts = _trajopt(calipso_tpu_torch, prob, calipso_tpu.Options())
    assert ts.solver.fns.stage_structure.dmax == 33
    res = ts.solve()
    assert_contract(res)
    states, _ = ts.get_trajectory(res)
    np.testing.assert_allclose(states[-1][:6], prob["state_goal"], atol=1e-3)
    for x in states[1:]:
        assert float(tbox.signed_distance(torch.tensor(x[3:6])).min()) > -1e-4


@pytest.mark.slow
def test_bunnyhop():
    """tests/test_bunnyhop.py:test_bunnyhop in the port (a flat NLP, n=110,
    on schur)."""
    opts = calipso_tpu_torch.Options(penalty_initial=1e2)
    s = calipso_tpu_torch.Solver(tbh.objective, tbh.equality, tbh.inequality, tbh.NZ, options=opts, device="cpu")
    assert s.options.linear_solver == "schur"
    res = s.solve(torch.tensor(tbh.initial_guess(0)))
    assert_contract(res, opts)
    z = res.variables.numpy()
    np.testing.assert_allclose(z[tbh.IDX_Q[4]][[1, 3]], [1.1, 1.15], atol=1e-3)
    for i in range(tbh.N):
        assert float(tbh.gaps(torch.tensor(z[tbh.IDX_Q[i]])).min()) > -1e-4
