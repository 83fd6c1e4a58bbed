"""Transparent-compression file open, with subprocess offload.

Design parity with fileIO/ReadWrite.java (pigz :819, bgzip :770, samtools
:583): the reference gets pipeline parallelism by running (de)compression in
separate processes. We do the same — `pigz`/`gzip` subprocesses when
available keep the Python process free to parse and feed the TPU — with a
pure-Python zlib fallback so nothing external is required.
"""

from __future__ import annotations

import gzip
import io
import os
import shutil
import subprocess
import sys

from .fileformat import Compression, test_input

USE_SUBPROCESS = True
_PIGZ = shutil.which("pigz")
_GZIP = shutil.which("gzip")
_BGZIP = shutil.which("bgzip")

#: default gzip level, matching the reference's ziplevel default of 2 for
#: pigz-era fast output (ReadWrite.ZIPLEVEL)
ZIPLEVEL = 2


def open_input(path: str) -> io.BufferedReader | io.BufferedIOBase:
    """Open a (possibly compressed) file for binary reading."""
    if path in ("stdin", "-", "/dev/stdin"):
        return sys.stdin.buffer
    ff = test_input(path, allow_content=True)
    if ff.compression in (Compression.GZIP, Compression.BGZF):
        if USE_SUBPROCESS and (_PIGZ or _GZIP):
            exe = _PIGZ or _GZIP
            proc = subprocess.Popen(
                [exe, "-dc", path],
                stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL,
                bufsize=1 << 20,
            )
            return _ProcStream(proc, proc.stdout)
        return gzip.open(path, "rb")  # type: ignore[return-value]
    if ff.compression is Compression.BZIP2:
        import bz2

        return bz2.open(path, "rb")  # type: ignore[return-value]
    if ff.compression is Compression.ZSTD:
        raise NotImplementedError("zstd input requires a zstd binary (not baked in)")
    return open(path, "rb", buffering=1 << 20)


def open_output(path: str, ziplevel: int | None = None, bgzf: bool = False):
    """Open a (possibly compressed) file for binary writing."""
    if path in ("stdout", "-", "/dev/stdout"):
        return sys.stdout.buffer
    level = ZIPLEVEL if ziplevel is None else ziplevel
    if path.endswith((".gz", ".bgz")) or bgzf:
        if bgzf or path.endswith(".bgz"):
            from .bgzf import BgzfWriter

            return BgzfWriter(open(path, "wb", buffering=1 << 20), level=level)
        if USE_SUBPROCESS and (_PIGZ or _GZIP):
            exe = _PIGZ or _GZIP
            out = open(path, "wb")
            proc = subprocess.Popen(
                [exe, f"-{max(1, level)}", "-c"],
                stdin=subprocess.PIPE,
                stdout=out,
                stderr=subprocess.DEVNULL,
                bufsize=1 << 20,
            )
            return _ProcStream(proc, proc.stdin, close_file=out)
        return gzip.open(path, "wb", compresslevel=max(1, level))
    if path.endswith(".bz2"):
        import bz2

        return bz2.open(path, "wb")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return open(path, "wb", buffering=1 << 20)


def read_bytes(path: str) -> bytes:
    """Slurp a whole (possibly compressed) file."""
    with open_input(path) as fh:
        return fh.read()


class _ProcStream:
    """Wraps a subprocess pipe so it closes (and reaps) cleanly."""

    def __init__(self, proc: subprocess.Popen, pipe, close_file=None):
        self._proc = proc
        self._pipe = pipe
        self._close_file = close_file

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return iter(self._pipe)

    def close(self):
        try:
            self._pipe.close()
        finally:
            self._proc.wait()
            if self._close_file is not None:
                self._close_file.close()
