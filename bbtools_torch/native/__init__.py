"""Native runtime components (C, ctypes-loaded).

Compiled on first use with the system compiler into a per-version cache;
every entry point has a numpy fallback so the framework works without a
toolchain. This is the TPU framework's analog of the reference's JNI
kernels (jni/, SURVEY.md §2.4) — host-side hot loops in C, device compute
in XLA/Pallas.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile

import numpy as np

_LIB = None
_TRIED = False


SOURCES = ("fastq_codec.c", "radix_count.c")


def _build() -> str | None:
    here = os.path.dirname(__file__)
    srcs = [os.path.join(here, s) for s in SOURCES]
    h = hashlib.sha256()
    for src in srcs:
        with open(src, "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()[:16]
    cache = os.path.join(
        tempfile.gettempdir(), f"bbtools_torch_native_{digest}.so"
    )
    if os.path.exists(cache):
        return cache
    cc = os.environ.get("CC", "cc")
    tmp = f"{cache}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [cc, "-O3", "-shared", "-fPIC", "-pthread", "-o",
             tmp, *srcs],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, cache)
        return cache
    except Exception as e:  # no compiler / failed build -> fallback
        print(f"bbtools_torch: native build unavailable ({e})", file=sys.stderr)
        return None


def get_lib():
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        path = _build()
        if path:
            lib = ctypes.CDLL(path)
            lib.scan_newlines.restype = ctypes.c_long
            lib.scan_lines_mt.restype = ctypes.c_long
            lib.count_newlines_mt.restype = ctypes.c_long
            lib.fill_records.restype = ctypes.c_int
            lib.fill_records_mt.restype = ctypes.c_int
            lib.emit_fastq.restype = ctypes.c_long
            lib.radix_count.restype = ctypes.c_long
            lib.radix_count_w.restype = ctypes.c_long
            _LIB = lib
    return _LIB


def scan_lines_native(buf: np.ndarray):
    """MT memchr line scan: (starts, ends) int64 arrays with \\r
    stripping — the numpy flatnonzero path runs ~2.3 GB/s single-pass;
    this is memchr across up to 16 threads. None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(buf)
    buf = np.ascontiguousarray(buf)
    nt = ctypes.c_int(_nthreads())
    cap = int(lib.count_newlines_mt(_ptr(buf), ctypes.c_long(n), nt))
    starts = np.empty(max(cap, 1), np.int64)
    ends = np.empty(max(cap, 1), np.int64)
    cnt = lib.scan_lines_mt(
        _ptr(buf), ctypes.c_long(n), _ptr(starts), _ptr(ends), nt
    )
    return starts[:cnt], ends[:cnt]


def radix_count_native(keys: np.ndarray):
    """Sorted unique (values, counts) of a uint64/int64 key array via the
    native LSD radix sorter; None when the library is unavailable. The
    input array is clobbered (sort scratch)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(keys)
    if n == 0:
        return keys.astype(np.uint64), np.zeros(0, np.int64)
    k = np.ascontiguousarray(keys, dtype=np.uint64)
    scratch = np.empty(n, np.uint64)
    vals = np.empty(n, np.uint64)
    counts = np.empty(n, np.int64)
    nu = lib.radix_count(
        _ptr(k), ctypes.c_long(n), _ptr(scratch), _ptr(vals), _ptr(counts)
    )
    return vals[:nu], counts[:nu]


def radix_count_w_native(rows: np.ndarray):
    """Lexicographic sort+count of [n, W] uint64 rows (big-k keys); None
    when unavailable. Input clobbered."""
    lib = get_lib()
    if lib is None:
        return None
    n, w = rows.shape
    if n == 0:
        return rows.astype(np.uint64), np.zeros(0, np.int64)
    r = np.ascontiguousarray(rows, dtype=np.uint64)
    scratch = np.empty((n, w), np.uint64)
    vals = np.empty((n, w), np.uint64)
    counts = np.empty(n, np.int64)
    nu = lib.radix_count_w(
        _ptr(r), ctypes.c_long(n), ctypes.c_int(w), _ptr(scratch),
        _ptr(vals), _ptr(counts)
    )
    return vals[:nu], counts[:nu]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def fill_records_native(buf: np.ndarray, line_starts: np.ndarray,
                        line_ends: np.ndarray, pad: int, qual_offset: int,
                        with_ascii: bool = True, with_quals: bool = True):
    """Native record gather; returns (bases, quals|None, ascii|None,
    lengths) or None when the native library is unavailable.
    with_ascii=False skips the raw-byte plane; with_quals=False also
    skips the quality plane (count-only readers — kmer spectra — write
    just bases+lengths)."""
    lib = get_lib()
    if lib is None:
        return None
    nrec = len(line_starts) // 4
    bases = np.empty((nrec, pad), dtype=np.uint8)
    quals = (
        np.empty((nrec, pad), dtype=np.uint8) if with_quals else None
    )
    ascii_b = np.empty((nrec, pad), dtype=np.uint8) if with_ascii else None
    lengths = np.empty(nrec, dtype=np.int32)
    ls = np.ascontiguousarray(line_starts, dtype=np.int64)
    le = np.ascontiguousarray(line_ends, dtype=np.int64)
    bufc = np.ascontiguousarray(buf)
    lib.fill_records_mt(
        _ptr(bufc), _ptr(ls), _ptr(le),
        ctypes.c_long(nrec), ctypes.c_long(pad), ctypes.c_int(qual_offset),
        _ptr(bases),
        ctypes.c_void_p(0) if quals is None else _ptr(quals),
        ctypes.c_void_p(0) if ascii_b is None else _ptr(ascii_b),
        _ptr(lengths),
        ctypes.c_int(_nthreads()),
    )
    return bases, quals, ascii_b, lengths


def pack_2bit_native(bases: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    n, pad = bases.shape
    pb = -(-pad // 4)
    nb = -(-pad // 8)
    packed = np.empty((n, pb), dtype=np.uint8)
    nmask = np.empty((n, nb), dtype=np.uint8)
    b = np.ascontiguousarray(bases)
    lib.pack_2bit_mt(_ptr(b), ctypes.c_long(n), ctypes.c_long(pad),
                     _ptr(packed), _ptr(nmask), ctypes.c_int(_nthreads()))
    return packed, nmask


def emit_fastq_native(idblob: bytes, idstart: np.ndarray,
                      idend: np.ndarray, ascii_b: np.ndarray,
                      quals: np.ndarray, lengths: np.ndarray,
                      keep: np.ndarray | None, qual_offset: int):
    """Serialize records to FASTQ bytes in C; None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n, pad = ascii_b.shape
    ids_ = np.ascontiguousarray(idstart, dtype=np.int64)
    ide_ = np.ascontiguousarray(idend, dtype=np.int64)
    lens = np.ascontiguousarray(lengths, dtype=np.int32)
    if keep is None:
        m = np.minimum(lens, pad).astype(np.int64)
        idl = ide_ - ids_
        nrec = n
        keep_arr = None
    else:
        keep_arr = np.ascontiguousarray(keep.astype(np.uint8))
        km = keep.astype(bool)
        m = np.minimum(lens, pad).astype(np.int64) * km
        idl = (ide_ - ids_) * km
        nrec = int(np.count_nonzero(km))
    cap = int((2 * m + idl).sum()) + 6 * nrec
    out = np.empty(max(cap, 1), np.uint8)
    if isinstance(idblob, np.ndarray):
        blob = idblob if len(idblob) else np.zeros(1, np.uint8)
    else:
        blob = (
            np.frombuffer(idblob, np.uint8)
            if len(idblob) else np.zeros(1, np.uint8)
        )
    w = lib.emit_fastq(
        _ptr(np.ascontiguousarray(blob)), _ptr(ids_), _ptr(ide_),
        _ptr(np.ascontiguousarray(ascii_b)),
        _ptr(np.ascontiguousarray(quals)), _ptr(lens),
        ctypes.c_void_p(0) if keep_arr is None else _ptr(keep_arr),
        ctypes.c_long(n), ctypes.c_long(pad), ctypes.c_int(qual_offset),
        _ptr(out), ctypes.c_long(len(out)),
    )
    if w < 0:
        return None
    return out[:w].tobytes()


def _nthreads() -> int:
    try:
        return max(1, min(os.cpu_count() or 1, 16))
    except Exception:
        return 1
