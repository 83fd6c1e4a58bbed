"""BGZF blocked-gzip codec — multithreaded, pure (no bgzip/samtools).

BGZF (SAM spec §4.1) is a sequence of gzip members, each <= 64 KiB of
uncompressed payload, carrying the compressed block size in a BC extra
field, terminated by a fixed 28-byte empty-block EOF marker. Any gzip
reader can decompress the concatenation; a BGZF reader can random-access
blocks.

The reference shells out to `bgzip`/`samtools` for this path
(fileIO/ReadWrite.java getOutputStreamFromProcess, stream/SamReadStreamer);
here it is implemented in-process. Compression is parallelized with a
thread pool: zlib's deflate releases the GIL, so Python threads give real
multicore scaling, preserving block order on write (the MT design of
bgzip -@N without the subprocess).
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

BLOCK_SIZE = 0xFF00  # uncompressed payload per block (bgzip's default)
EOF_MARKER = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HDR = struct.Struct("<4BI2BH2B2H")  # gzip header + XLEN + BC subfield


def compress_block(data: bytes, level: int = 6) -> bytes:
    """One BGZF block: gzip member with BC extra field."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = co.compress(data) + co.flush()
    bsize = len(payload) + 25 + 1  # header(12)+extra(6)+payload+crc(4)+isize(4)
    header = _HDR.pack(
        0x1F, 0x8B, 8, 4,  # magic, deflate, FEXTRA
        0, 0, 0xFF,  # mtime, xfl, os
        6,  # XLEN
        0x42, 0x43, 2,  # 'B','C', subfield len
        bsize - 1,
    )
    tail = struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)
    return header + payload + tail


class BgzfWriter:
    """Order-preserving multithreaded BGZF writer (file-like, bytes)."""

    def __init__(self, fh, level: int = 6, threads: int = 4):
        self._fh = fh
        self._level = level
        self._buf = bytearray()
        self._pool = ThreadPoolExecutor(max_workers=max(1, threads))
        self._pending = []  # futures in submission order
        self._max_pending = max(8, threads * 4)
        self._closed = False

    def write(self, data: bytes) -> int:
        self._buf += data
        while len(self._buf) >= BLOCK_SIZE:
            chunk = bytes(self._buf[:BLOCK_SIZE])
            del self._buf[:BLOCK_SIZE]
            self._submit(chunk)
        return len(data)

    def _submit(self, chunk: bytes) -> None:
        self._pending.append(
            self._pool.submit(compress_block, chunk, self._level)
        )
        if len(self._pending) >= self._max_pending:
            self._drain(self._max_pending // 2)

    def _drain(self, keep: int = 0) -> None:
        while len(self._pending) > keep:
            self._fh.write(self._pending.pop(0).result())

    def flush(self) -> None:
        if self._buf:
            self._submit(bytes(self._buf))
            self._buf.clear()
        self._drain(0)
        self._fh.flush()

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._fh.write(EOF_MARKER)
        self._pool.shutdown()
        self._fh.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def tell_virtual(self) -> int:
        """Virtual file offset (coffset<<16 | uoffset) of the next write."""
        self._drain(0)
        return (self._fh.tell() << 16) | len(self._buf)


class BgzfReader:
    """Streaming BGZF/gzip reader (file-like, bytes).

    Accepts plain multi-member gzip too (BGZF is a subset); stops at the
    EOF marker or end of file.
    """

    def __init__(self, fh, threads: int = 4):
        self._fh = fh
        self._chunks = []
        self._pos = 0
        self._decomp = zlib.decompressobj(zlib.MAX_WBITS | 16)
        self._eof = False

    def _fill(self) -> bool:
        while True:
            raw = self._fh.read(1 << 16)
            if not raw:
                self._eof = True
                return False
            out = bytearray()
            data = raw
            while data:
                out += self._decomp.decompress(data)
                data = b""
                if self._decomp.eof:
                    rest = self._decomp.unused_data
                    self._decomp = zlib.decompressobj(zlib.MAX_WBITS | 16)
                    data = rest
            if out:
                self._chunks.append(bytes(out))
                return True

    def read(self, n: int = -1) -> bytes:
        out = []
        need = n
        while need != 0:
            if not self._chunks:
                if not self._fill():
                    break
            chunk = self._chunks[0]
            if need < 0 or need >= len(chunk) - self._pos:
                out.append(chunk[self._pos :])
                if need > 0:
                    need -= len(chunk) - self._pos
                self._chunks.pop(0)
                self._pos = 0
            else:
                out.append(chunk[self._pos : self._pos + need])
                self._pos += need
                need = 0
        return b"".join(out)

    def readline(self) -> bytes:
        out = []
        while True:
            if not self._chunks:
                if not self._fill():
                    break
            chunk = self._chunks[0]
            i = chunk.find(b"\n", self._pos)
            if i >= 0:
                out.append(chunk[self._pos : i + 1])
                self._pos = i + 1
                if self._pos >= len(chunk):
                    self._chunks.pop(0)
                    self._pos = 0
                break
            out.append(chunk[self._pos :])
            self._chunks.pop(0)
            self._pos = 0
        return b"".join(out)

    def __iter__(self):
        while True:
            line = self.readline()
            if not line:
                return
            yield line

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
