"""Build and load the package's CUDA kernels.

Each source under `calipso_tpu_torch/csrc/` is compiled by its own `nvcc`
for Hopper (`sm_90a`) into a shared library with a plain C interface,
loaded with `ctypes`. The builds run in parallel, at first use, into
`build/calipso_tpu_torch/<hash>/` at the root of the checkout, keyed by a
hash of the source and the flags, so an edited source builds anew and an
unchanged one is loaded as it is. A failed build raises with nvcc's
output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "calipso_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# source stem -> {C entry point: argument types}; every entry point
# returns a CUDA error code (int), except the fused solve's workspace
# query (words per lane, or a negated CUDA error code)
SIGNATURES = {
    "riccati_t1": {
        **{f"calipso_factor_t1_{dt}": [_P, _P, _I, _I, _P] for dt in ("f32", "f64")},
        **{f"calipso_solve_t1_{dt}": [_P, _P, _P, _I, _I, _P] for dt in ("f32", "f64")},
    },
    "riccati_lanes": {
        **{f"calipso_factor_lanes_{dt}": [_P, _P, _P, _P, _I, _I, _I, _P] for dt in ("f32", "f64")},
        **{f"calipso_solve_lanes_{dt}": [_P, _P, _P, _P, _I, _I, _I, _P] for dt in ("f32", "f64")},
    },
    "riccati_stream": {
        **{f"calipso_factor_stream_{dt}": [_P, _P, _P, _P, _I, _I, _I, _P] for dt in ("f32", "f64")},
        **{
            f"calipso_solve_{sweep}_stream_{dt}": [_P, _P, _P, _P, _I, _I, _I, _I, _P]
            for sweep in ("fwd", "bwd")
            for dt in ("f32", "f64")
        },
    },
    "riccati_fused": {
        **{f"calipso_solve_batched_fused_workspace_{dt}": [_I, _I] for dt in ("f32", "f64")},
        **{f"calipso_solve_batched_fused_{dt}": [_P, _P, _P, _P, _P, _I, _I, _I, _P] for dt in ("f32", "f64")},
        **{f"calipso_solve_batched_lanes_{dt}": [_P, _P, _P, _P, _I, _I, _I, _P] for dt in ("f32", "f64")},
    },
}
SOURCES = tuple(PACKAGE_DIR / "csrc" / f"{stem}.cu" for stem in SIGNATURES)

_libs = {}
# nvcc's output of the builds this process made (register and
# shared-memory use per kernel, from -Xptxas -v); empty when cached
build_log = ""


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(src.name.encode())
    h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{src.stem}.so"


def build() -> dict:
    """Compile every source that has no library yet, one nvcc each, all
    started together. Returns {source stem: library path}."""
    global build_log
    out = {src.stem: library_path(src) for src in SOURCES}
    procs = []
    for src in SOURCES:
        lib = out[src.stem]
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        procs.append((cmd, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures, logs = [], []
    for cmd, tmp, lib, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
            continue
        logs.append(text)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    build_log += "".join(logs)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load(stem: str):
    """The kernel library built from `csrc/<stem>.cu`, loaded once per
    process (the first call builds every source)."""
    if stem not in _libs:
        lib = ctypes.CDLL(str(build()[stem]))
        for name, argtypes in SIGNATURES[stem].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
        _libs[stem] = lib
    return _libs[stem]
