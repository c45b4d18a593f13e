"""The system under test: `calipso_tpu_torch`'s batched trajectory solver,
built from a configuration file, fed with scenarios made from the seed,
and the benchmark's own spans and call records around calls into it.

From the program the benchmark takes only the solver (its public
`TrajOptSolver(...).batched()` entry), its counters
(`stats["host_syncs"]`, the state's iteration counts) and the names of
its kernels and layers.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

# the TrajOptSolver arguments a model's problem dictionary may carry
TRAJOPT_KEYS = (
    "objective", "dynamics", "num_states", "num_actions", "equality", "equality_general",
    "nonnegative", "second_order", "parameters",
)
# the oracles the solve loop and differentiation call on the problem
# functions, the KKT functions of `solver/kkt.py` the issue's layer names,
# and the kernel wrappers whose launches the rooflines count
ORACLES = (
    "f", "g", "h", "fx", "gx", "hx", "gty_x", "htz_x", "lagrangian_hessian_xx", "lagrangian_hessian_blocks",
    "fxt", "gt", "ht", "gty_xt", "htz_xt",
)
KKT = ("factorize", "solve_with", "matvec")
KERNELS = ("factor_t1", "solve_t1", "factor_lanes", "solve_lanes")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def base_guess(config):
    """The interleaved [x_0, u_0, ..., x_{T-1}] guess of the configuration:
    states on the straight line from `initial_state` to `goal_state`,
    actions 0 (float64, on the host)."""
    T, nx, nu = config["horizon"], config["num_states"], config["num_actions"]
    a = torch.tensor(config["guess"]["initial_state"], dtype=torch.float64)
    b = torch.tensor(config["guess"]["goal_state"], dtype=torch.float64)
    s = torch.linspace(0.0, 1.0, T, dtype=torch.float64)[:, None]
    states = (1.0 - s) * a + s * b
    rows = [torch.cat([states[t], torch.zeros(nu if t < T - 1 else 0, dtype=torch.float64)]) for t in range(T)]
    return torch.cat(rows)


class Scenarios:
    """Each batch's inputs, drawn in turn from one generator on the device
    seeded with the run's seed: parameters scale * N(0, I) (B, p) where the
    traffic varies them, and the base guess plus scale * N(0, I) where it
    varies the guess, else the base guess for every lane. The same seed
    gives the same batches, every seed the same sizes."""

    def __init__(self, config, traffic, seed, device):
        self.B = traffic["batch"]
        self.p = config["num_parameters"]
        self.dtype = DTYPES[config["dtype"]]
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.param_scale = traffic.get("parameters", {}).get("scale", 0.0)
        self.guess_scale = traffic.get("guess", {}).get("scale", 0.0)
        self.guess0 = base_guess(config).to(device=self.device, dtype=self.dtype)

    def _normal(self, *shape):
        return torch.randn(shape, generator=self.gen, device=self.device, dtype=self.dtype)

    def next(self):
        """(theta (B, p), guess (B, n)) of the next batch."""
        theta = self.param_scale * self._normal(self.B, self.p)
        if self.guess_scale:
            guess = self.guess0 + self.guess_scale * self._normal(self.B, self.guess0.numel())
        else:
            guess = self.guess0.expand(self.B, -1).contiguous()
        return theta, guess


class System:
    """The port's batched solver for one configuration and traffic."""

    def __init__(self, config, traffic, device, overrides=None):
        from calipso_tpu_torch import Options, TrajOptSolver

        program = config["program"]
        model = importlib.import_module(f"calipso_tpu_torch.models.{program['model']}")
        problem = getattr(model, program["problem"])(**program["arguments"])
        options = Options(**{**config["options"], "differentiate": traffic.get("differentiate", False), **(overrides or {})})
        ts = TrajOptSolver(options=options, device=device, **{k: problem[k] for k in TRAJOPT_KEYS if k in problem})
        dims = ts.dims
        got = (dims.variables, dims.equality, dims.cone, dims.parameters)
        want = (config["num_variables"], config["equality_rows"], config["cone_rows"], config["num_parameters"])
        if got != want:
            raise ValueError(f"{config['name']}: the port builds (n, m_e, m_c, p) = {got}, the configuration states {want}")
        if ts.solver.options.linear_solver != config["linear_solver"]:
            raise ValueError(
                f"{config['name']}: linear_solver auto resolved to {ts.solver.options.linear_solver}, "
                f"the configuration states {config['linear_solver']}"
            )
        self.bts = ts.batched()
        self.differentiate = options.differentiate

    def solve(self, theta, guess):
        return self.bts.solve(parameters=theta if theta.shape[1] else None, guess=guess)

    @property
    def host_syncs(self):
        return self.bts.stats["host_syncs"]


_MISSING = object()


def _patch(saved, owner, attr, make):
    """Replace owner.attr by make(owner.attr), remembering how to undo it
    (an instance whose class holds the method gets an attribute of its
    own, deleted afterwards)."""
    saved.append((owner, attr, vars(owner).get(attr, _MISSING)))
    setattr(owner, attr, make(getattr(owner, attr)))


@contextlib.contextmanager
def instrument(system, spans=False, calls=None):
    """Wrap calls into the port for one traced batch. With `spans`, each
    oracle, KKT function and the sensitivity computation runs inside a
    `torch.profiler.record_function` named "oracle.<name>", "kkt.<name>",
    "differentiation.sensitivity". With a list `calls`, every call of a
    kernel wrapper appends (name, shape of its first argument, dtype)."""
    from calipso_tpu_torch.ops import cuda_riccati
    from calipso_tpu_torch.solver import differentiate, kkt

    saved = []

    def span(label):
        def make(fn):
            def wrapped(*a, **k):
                with torch.profiler.record_function(label):
                    return fn(*a, **k)

            return wrapped

        return make

    def record(name):
        def make(fn):
            def wrapped(first, *a, **k):
                calls.append((name, tuple(first.shape), str(first.dtype).removeprefix("torch.")))
                return fn(first, *a, **k)

            return wrapped

        return make

    try:
        if spans:
            fns = system.bts.fns
            for name in ORACLES:
                if hasattr(fns, name):
                    _patch(saved, fns, name, span(f"oracle.{name}"))
            for name in KKT:
                _patch(saved, kkt, name, span(f"kkt.{name}"))
            _patch(saved, differentiate, "sensitivity", span("differentiation.sensitivity"))
        if calls is not None:
            for name in KERNELS:
                _patch(saved, cuda_riccati, name, record(name))
        yield
    finally:
        for owner, attr, old in reversed(saved):
            if old is _MISSING:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
