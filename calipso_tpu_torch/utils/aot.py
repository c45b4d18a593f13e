"""Ahead-of-time program cache for batched solves: the counterpart of
`calipso_tpu/utils/aot.py`, and the body of the batched solvers'
`aot_save` / `aot_load` (`parallel/batch.py`).

The reference serializes its traced program (`jax.export`), so that a
later process skips tracing. The port traces nothing: its solve loop runs
eagerly. The one cold-start step whose result a file can carry across
processes is the nvcc build of the kernel libraries (`ops/_build.py`), so
the cache is a JSON manifest that names those libraries:

- `aot_save` builds, or finds in the build cache, every library the
  solver's routes use at the saved shape and writes the manifest: the
  shapes, the dtype, the device, the resolved options, the routes, the
  libraries' build keys, a hash of the package's sources (its `.py` files
  and `csrc/`), the torch and CUDA versions and the environment that
  chooses what runs (`CUDA_HOME`, every `CALIPSO_*` variable, torch's
  preferred linalg library on the card).
- `aot_load` recomputes the manifest in this process and raises
  `ValueError` naming the first field that differs (stale sources,
  another dtype, another torch), or the first library that is missing;
  else it loads the libraries.

The reference's key misses its environment toggles; this one holds every
input that changes what runs. On the CPU the routes are the kernels'
plain versions, so the manifest names no library and is still checked on
load.

`cached_batched` is the keyed variant, as the reference's is: the
caller's fingerprint (the problem and its shapes), `source_hash()` and
the environment key a manifest file under `$XDG_CACHE_HOME/calipso_tpu_torch/aot`;
a hit loads its libraries and skips the build, a miss writes it.
`CALIPSO_AOT_CACHE=0` turns it off.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path

import torch

FORMAT = 1
# the order in which aot_load compares, and names the first that differs
FIELDS = (
    "format", "solver", "device", "dtype", "shapes", "options", "routes",
    "sources", "torch", "cuda", "environment", "libraries",
)
PACKAGE_DIR = Path(__file__).resolve().parents[1]


def source_hash() -> str:
    """sha256 over the package's `.py` files and `csrc/` sources, by path
    relative to the package and content."""
    h = hashlib.sha256()
    files = [p for p in PACKAGE_DIR.rglob("*.py") if "__pycache__" not in p.parts]
    files += [p for p in (PACKAGE_DIR / "csrc").iterdir() if p.is_file()]
    for p in sorted(set(files)):
        h.update(str(p.relative_to(PACKAGE_DIR)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _environment(device):
    env = {k: v for k, v in sorted(os.environ.items()) if k.startswith("CALIPSO_")}
    env["CUDA_HOME"] = os.environ.get("CUDA_HOME")
    if device.type == "cuda":
        env["preferred_linalg_library"] = str(torch.backends.cuda.preferred_linalg_library())
    return env


def routes(fns, options, num_parameters, dtype):
    """{"linear_solver": ..., plus each route it takes}: what
    `solver/kkt.py` and `ops/riccati.py` dispatch to for this problem in
    `dtype`, and the kernel sources (`csrc/<stem>.cu`) behind them."""
    from calipso_tpu_torch.ops import riccati as rc
    from calipso_tpu_torch.solver import kkt

    method = options.linear_solver
    out = {"linear_solver": method}
    stems = set()
    if method in ("schur", "lu"):  # lu's inertia ladder runs on the schur factor
        out["t1"] = rc.t1_route(fns.dims.variables, dtype)
        if out["t1"] == "kernel":
            stems.add("riccati_t1")
    elif method in ("riccati", "cr"):
        structure = fns.stage_structure
        if method == "riccati":
            out["block"] = rc.route(structure.dmax, dtype, structure.horizon)
            stems.update(
                {"lanes": ("riccati_lanes",), "stream": ("riccati_stream",), "t1": ("riccati_t1",)}.get(out["block"], ())
            )
        if method == "riccati" and (kkt._has_border(structure) or (options.differentiate and num_parameters > 0)):
            # K right-hand sides at once: ops/riccati.solve_multi
            out["multi"] = out["block"] if out["block"] in ("scan", "t1") else "stream"
            if out["multi"] == "stream":
                stems.add("riccati_stream")
    out["kernel_sources"] = sorted(stems)
    return out


def manifest(batched, batch_size, num_parameters, dtype):
    """The manifest of a batched solver at (batch_size, num_parameters,
    dtype), with the build keys of its libraries (no build)."""
    from calipso_tpu_torch.ops import _build
    from calipso_tpu_torch.solver.solve import resolve_options

    device = torch.device(batched.device)
    fns = batched.fns
    p = fns.dims.parameters if num_parameters is None else int(num_parameters)
    options = resolve_options(batched.options, fns, device)
    r = routes(fns, options, p, dtype)
    structure = getattr(fns, "stage_structure", None)
    libraries = {}
    if device.type == "cuda":
        for stem in r["kernel_sources"]:
            lib = _build.library_path(_build.PACKAGE_DIR / "csrc" / f"{stem}.cu")
            libraries[stem] = str(lib.relative_to(_build.BUILD_ROOT))
    return {
        "format": FORMAT,
        "solver": type(batched).__name__,
        "device": device.type,
        "dtype": str(dtype).replace("torch.", ""),
        "shapes": {
            "batch": int(batch_size),
            "variables": fns.dims.variables,
            "parameters": p,
            "equality": fns.dims.equality,
            "cone": fns.dims.cone,
            "horizon": None if structure is None else structure.horizon,
            "stage_width": None if structure is None else structure.dmax,
        },
        "options": {k: repr(v) for k, v in dataclasses.asdict(options).items()},
        "routes": r,
        "sources": source_hash(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "environment": _environment(device),
        "libraries": libraries,
    }


def save(batched, path, batch_size, num_parameters, dtype):
    """aot_save: build (or find built) the libraries the routes use, then
    write the manifest to `path`. Returns `path`."""
    from calipso_tpu_torch.ops import _build

    m = manifest(batched, batch_size, num_parameters, dtype)
    if m["libraries"]:
        _build.build()
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(m, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def cache_path(tag: str, fingerprint: str, device) -> Path:
    """The manifest file of `cached_batched`, keyed by sha1 over the
    fingerprint, `source_hash()` and the environment on `device` (so a
    changed `CALIPSO_*` variable misses, which the reference's key does
    not)."""
    base = Path(os.path.expanduser(os.environ.get("XDG_CACHE_HOME", "~/.cache"))) / "calipso_tpu_torch" / "aot"
    base.mkdir(parents=True, exist_ok=True)
    key = json.dumps([fingerprint, source_hash(), _environment(torch.device(device))], sort_keys=True)
    return base / f"{tag}-{hashlib.sha1(key.encode()).hexdigest()[:16]}.json"


def cached_batched(batched, tag: str, fingerprint: str, batch_size, num_parameters=None, dtype=None):
    """`calipso_tpu/utils/aot.py:cached_batched` for a batched solver of
    the port: `(batched.solve, was_cached)`. A manifest at the key's path
    that this process accepts (`aot_load`) is a hit: its libraries are
    loaded and nothing is built. Anything else is a miss: `aot_save` at
    (batch_size, num_parameters, dtype) writes it anew, atomically.
    `CALIPSO_AOT_CACHE=0` gives `(batched.solve, False)` and touches no
    file."""
    if os.environ.get("CALIPSO_AOT_CACHE", "1") != "1":
        return batched.solve, False
    path = cache_path(tag, fingerprint, batched.device)
    if path.exists():
        try:
            batched.aot_load(str(path), dtype)
            return batched.solve, True
        except ValueError:
            pass  # stale (a library gone, another torch): written anew below
    batched.aot_save(str(path), batch_size, num_parameters, dtype)
    return batched.solve, False


def load(batched, path, dtype):
    """aot_load: the manifest at `path` against this process's (raising
    ValueError at the first field that differs or library that is
    missing), then load its libraries. `dtype` None takes the manifest's."""
    from calipso_tpu_torch.ops import _build

    with open(path) as f:
        saved = json.load(f)
    if dtype is None:
        dtype = getattr(torch, str(saved.get("dtype")), None)
    shapes = saved.get("shapes", {})
    here = json.loads(json.dumps(manifest(batched, shapes.get("batch", 0), shapes.get("parameters"), dtype)))
    for field in FIELDS:
        if saved.get(field) != here[field]:
            raise ValueError(
                f"aot_load({path}): {field} differs from this process's: saved {saved.get(field)!r}, "
                f"here {here[field]!r}"
            )
    for stem, rel in here["libraries"].items():
        if not (_build.BUILD_ROOT / rel).exists():
            raise ValueError(f"aot_load({path}): library {stem} missing: {_build.BUILD_ROOT / rel}")
        _build.load(stem)
    return saved
