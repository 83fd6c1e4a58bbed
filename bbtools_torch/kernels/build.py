"""Builds and loads the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` for Hopper
(`sm_90a`), all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ctypes. The
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
#: C entry points and their argument types (pointers and the stream as
#: void*, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    # query, out, n, tlo, thi, tid, rows, slots, nb, shift, salt, packed,
    # variant, stream
    "lane_lookup": (_P, _P, _I64, _P, _P, _P, _I, _I, _I, _I, ctypes.c_uint,
                    _I, _I, _P),
    # rows, nb, packed, &need, &limit
    "lane_lookup_shared_bytes": (_I, _I, _I, _P, _P),
    # in, out, n, scratch, stream
    "cummax_i64": (_P, _P, _I64, _P, _P),
    # the same, then variant, stream
    "cummax_i64_variant": (_P, _P, _I64, _P, _I, _P),
    # n, variant (returns int64 words)
    "cummax_i64_scratch": (_I64, _I),
    # (returns elements)
    "cummax_i64_tile": (),
    # stream (returns the capture's id, 0 where none)
    "cummax_i64_capture_id": (_P,),
    # idx, out, n, table, n_table, stream
    "lane_table": (_P, _P, _I64, _P, _I, _P),
    # the same, then variant, stream
    "lane_table_variant": (_P, _P, _I64, _P, _I, _I, _P),
    # a, b_rc, alens, blens, good, bad, olen, B, L, min0, D, stream
    "overlap_scan": (_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _P),
    # the same, then variant, stream
    "overlap_scan_variant": (_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P),
    # keys, out, n, keyT, prio, Dp, k, mink, nc, Kp, stream
    "mm_lookup": (_P, _P, _I64, _P, _P, _I, _I, _I, _I, _I, _P),
    "mm_best": (_P, _P, _I64, _P, _P, _I, _I, _I, _I, _I, _P),
    # the same, then variant, stream
    "mm_lookup_variant": (_P, _P, _I64, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # reads, lens, refs, col0, out_s, out_c, out_st, planes, S, R, ldr, Cc,
    # variant, stream
    "msa_fill": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P),
    # reads, lens, refs, col0, task_ids, band_start, n_tasks, n_tickets, K,
    # G, sync, edges, out_s, out_c, out_st, planes, S, R, ldr, Cc, stream
    "msa_fill_band": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _P, _P, _P, _P, _P,
                      _P, _I64, _I, _I, _I, _P),
}

#: entry points that return something else than a cudaError_t (int)
RESTYPES = {"cummax_i64_scratch": _I64, "cummax_i64_capture_id": ctypes.c_uint64}

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
    returns its path. One nvcc per source, run in parallel, then one
    link. The compilers' report (ptxas register and shared-memory use)
    is kept beside the library as `<name>.log`."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        build_seconds = 0.0
        return path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(sources(), objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    reports = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode, r) for c, p, r in zip(cmds, procs, reports)
              if p.returncode != 0]
    link = [nvcc, "-shared", "-o", tmp, *objs]
    if not failed:
        res = subprocess.run(link, capture_output=True, text=True)
        reports.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append((link, res.returncode, reports[-1]))
    with open(path[:-3] + ".log", "w") as fh:
        for c, r in zip(cmds + [link], reports):
            fh.write(" ".join(c) + "\n" + r)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        c, rc, r = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(c)}\n{r}")
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
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        _LIB = lib
    return _LIB


def check(rc: int, name: str):
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
