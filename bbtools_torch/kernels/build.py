"""Builds and loads the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`) into
one shared library with a plain C interface, loaded with ctypes. The
build runs at the first CUDA use of a kernel, into `bbtools_torch/_build/`
(git-ignored), under a name keyed by a hash of the sources and flags, so
a changed source rebuilds and an unchanged one loads at once.

There is no substitute when the build fails: a missing `nvcc` or a
compile error raises, and so does a launch that returns a CUDA error.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
#: C entry points and their argument types (pointers and the stream as
#: void*, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    # query, out, n, tlo, thi, tid, rows, slots, nb, shift, salt, packed, stream
    "lane_lookup": (_P, _P, _I64, _P, _P, _P, _I, _I, _I, _I, ctypes.c_uint,
                    _I, _P),
    # in, out, n, tile_max, stream
    "cummax_i64": (_P, _P, _I64, _P, _P),
    "cummax_i64_tile": (),
}

_LIB: ctypes.CDLL | None = None
#: seconds the last build of this process took (0.0 when it loaded a
#: library already built from the same sources)
build_seconds: float | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, CUDA_PATH); the CUDA kernels "
        "cannot be built"
    )


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    """The library's path under BUILD_DIR, named by a hash of the
    sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libbbtools_torch_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu unless a library of the same sources exists;
    returns its path. The compiler's report (ptxas register and
    shared-memory use) is kept beside it as `<name>.log`."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        build_seconds = 0.0
        return path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *sources()]
    res = subprocess.run(cmd, capture_output=True, text=True)
    with open(path[:-3] + ".log", "w") as fh:
        fh.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(rc: int, name: str):
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
