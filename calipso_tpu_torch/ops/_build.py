"""Build and load the package's CUDA kernels.

The sources under `calipso_tpu_torch/csrc/` are compiled by `nvcc` for
Hopper (`sm_90a`) into a shared library with a plain C interface and
loaded with `ctypes`. The build happens at first use, into
`build/calipso_tpu_torch/<hash>/` at the root of the checkout, keyed by a
hash of the sources and the flags, so an edited source builds anew and an
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
SOURCES = (PACKAGE_DIR / "csrc" / "riccati_t1.cu",)
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "calipso_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LIB_NAME = "libcalipso_kernels.so"

_lib = None
# nvcc's output of the build this process made (register and shared-memory
# use per kernel, from -Xptxas -v); empty when the library was cached
build_log = ""


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the kernels unless a library of these sources exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    build_log = proc.stdout + proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load():
    """The kernel library, built and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"calipso_factor_t1_{dt}")
            fn.argtypes = [ptr, ptr, i32, i32, ptr]
            fn.restype = i32
            fn = getattr(lib, f"calipso_solve_t1_{dt}")
            fn.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
            fn.restype = i32
        _lib = lib
    return _lib
