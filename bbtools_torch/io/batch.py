"""ReadBatch — the structure-of-arrays unit of work.

The reference's unit of inter-thread batching is `ListNum<Read>` (~200
array-of-struct Read objects, stream/Read.java:99, shared/Shared.java:115).
The TPU-native equivalent is a fixed-shape SoA batch: padded 2-bit base
codes + phred quals + lengths as device-transferable tensors, with names
kept host-side. The batch ordinal plays the role of ListNum.id and drives
ordered output (Appendix A.9 of SURVEY.md).

Padding: bases pad with N_CODE, quals with 0; `lengths` is the source of
truth. Row length is bucketed (powers-of-two-ish ladder) so jitted kernels
see a small, stable set of shapes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.dna import BASE_TO_CODE, CODE_TO_BASE, N_CODE

#: shape ladder for the padded length dimension; each value is a multiple of
#: 128 beyond 128 so device rows are lane-aligned
LENGTH_BUCKETS = (32, 64, 128, 256, 384, 512, 1024, 2048, 4096, 8192, 16384)


def bucket_length(max_len: int) -> int:
    for b in LENGTH_BUCKETS:
        if max_len <= b:
            return b
    # beyond the ladder: round up to a multiple of 1024
    return -(-max_len // 1024) * 1024


class IdView:
    """Lazy read-id sequence over one raw buffer: (blob, starts, ends)
    instead of materialized per-read bytes objects (32k python slices
    per batch dominated the reader). Behaves like a list of bytes for
    the access patterns tools use (len/iter/int-index/slice); the
    native FASTQ emitter consumes blob+offsets directly with no python
    loop at all."""

    __slots__ = ("blob", "starts", "ends", "_list", "_raw")

    def __init__(self, blob, starts: np.ndarray, ends: np.ndarray):
        # blob may be bytes OR a uint8 ndarray (zero-copy from the
        # reader's chunk buffer: bytes-ifying a 32 MB chunk per batch
        # was 60% of reader time); ndarray slices convert per id.
        self.blob = blob
        self._raw = not isinstance(blob, (bytes, bytearray))
        self.starts = starts
        self.ends = ends
        self._list: list[bytes] | None = None

    def __len__(self) -> int:
        if self._list is not None:
            return len(self._list)
        return len(self.starts)

    def __bool__(self) -> bool:
        return len(self) > 0

    def __getitem__(self, i):
        if self._list is not None:
            return self._list[i]
        if isinstance(i, slice):
            return IdView(self.blob, self.starts[i], self.ends[i])
        s = self.starts[i]
        out = self.blob[s : self.ends[i]]
        return out.tobytes() if self._raw else out

    def __setitem__(self, i, v):
        # mutation (renaming tools): fall back to materialized list
        if self._list is None:
            self._list = self.tolist()
        self._list[i] = v

    def __iter__(self):
        if self._list is not None:
            return iter(self._list)
        b = self.blob
        if self._raw and len(self.starts):
            # one bytes copy of just the id region (ids are contiguous
            # header spans; seq/qual bytes between them come along but
            # one memcpy beats 32k per-slice conversions)
            lo = int(self.starts[0])
            b = self.blob[lo : int(self.ends[-1])].tobytes()
            starts = (self.starts - lo).tolist()
            ends = (self.ends - lo).tolist()
        else:
            starts = self.starts.tolist()
            ends = self.ends.tolist()

        def gen():
            for s, e in zip(starts, ends):
                yield b[s:e]

        return gen()

    def tolist(self) -> list[bytes]:
        if self._list is not None:
            return list(self._list)
        return list(self)

    @property
    def materialized(self) -> list[bytes] | None:
        return self._list


class LazyAscii:
    """Deferred raw-ASCII plane: (chunk buffer, row starts, row lengths)
    segments gathered into the padded [B, L] matrix only when a consumer
    actually touches `ascii_bases`. Filter/counting paths that never
    re-emit the raw bytes skip the plane fill entirely — the remaining
    ~15% of full-plane ingest cost (NEXT.md lazy-ascii plan)."""

    __slots__ = ("segs", "L")

    def __init__(self, segs, L: int):
        self.segs = segs  # list[(buf uint8[], starts i64[], lengths i32[])]
        self.L = L

    def rows(self) -> int:
        return sum(len(s[1]) for s in self.segs)

    def slice(self, off: int, n: int) -> "LazyAscii":
        out = []
        for buf, starts, lengths in self.segs:
            m = len(starts)
            if off >= m:
                off -= m
                continue
            take = min(n, m - off)
            out.append((buf, starts[off : off + take],
                        lengths[off : off + take]))
            n -= take
            off = 0
            if n == 0:
                break
        return LazyAscii(out, self.L)

    def widened(self, L: int) -> "LazyAscii":
        return LazyAscii(self.segs, max(self.L, L))

    def row(self, i: int) -> bytes | None:
        for buf, starts, lengths in self.segs:
            if i < len(starts):
                s = int(starts[i])
                return buf[s : s + int(lengths[i])].tobytes()
            i -= len(starts)
        return None

    def materialize(self) -> np.ndarray:
        parts = []
        for buf, starts, lengths in self.segs:
            idx = starts[:, None] + np.arange(
                self.L, dtype=starts.dtype
            )[None, :]
            np.minimum(idx, len(buf) - 1, out=idx)
            rows = buf[idx]
            rows[np.arange(self.L)[None, :] >= lengths[:, None]] = ord("N")
            parts.append(rows)
        if not parts:
            return np.zeros((0, self.L), np.uint8)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)


@dataclass
class ReadBatch:
    """A batch of reads as padded SoA arrays (host numpy; device-ready)."""

    bases: np.ndarray  # uint8 [B, L] 2-bit codes, N_CODE padded
    quals: np.ndarray | None  # uint8 [B, L] phred (offset removed) or None (fasta)
    lengths: np.ndarray  # int32 [B]
    ids: list[bytes] = field(default_factory=list)  # read headers (no '@'/'>')
    ordinal: int = 0  # input-order batch id (ListNum.id analog)
    numeric_id0: int = 0  # numericID of first read in the batch
    #: raw ASCII bases as read from the file (the reference preserves case
    #: and IUPAC letters in output by default, stream/Read.java:4459
    #: IUPAC_TO_N=false) — kept host-side for byte-exact emission; None
    #: means emit from codes. default_factory (not a plain default) so no
    #: class-level attribute shadows the __getattr__ lazy-materialize hook
    ascii_bases: np.ndarray | None = field(default_factory=lambda: None)

    def set_lazy_ascii(self, src: "LazyAscii | None"):
        """Install a deferred ascii plane: the `ascii_bases` attribute
        materializes it on first touch (via __getattr__); code that never
        reads it never pays the gather."""
        self.__dict__.pop("ascii_bases", None)
        self.__dict__["_lazy_ascii"] = src

    def __getattr__(self, name):
        # only called when normal lookup fails — i.e. after
        # set_lazy_ascii removed the eager plane
        if name == "ascii_bases":
            src = self.__dict__.get("_lazy_ascii")
            plane = None if src is None else src.materialize()
            self.__dict__["ascii_bases"] = plane
            return plane
        raise AttributeError(name)

    @property
    def n(self) -> int:
        return int(self.bases.shape[0])

    @property
    def padded_len(self) -> int:
        return int(self.bases.shape[1])

    def valid_mask(self) -> np.ndarray:
        """bool [B, L]: True within each read's length."""
        return np.arange(self.padded_len)[None, :] < self.lengths[:, None]

    def sequence(self, i: int) -> bytes:
        if "ascii_bases" not in self.__dict__:
            src = self.__dict__.get("_lazy_ascii")
            if src is not None:  # single row: skip whole-plane gather
                row = src.row(i)
                if row is not None:
                    return row[: int(self.lengths[i])]
        if self.ascii_bases is not None:
            return self.ascii_bases[i, : self.lengths[i]].tobytes()
        return CODE_TO_BASE[
            np.minimum(self.bases[i, : self.lengths[i]], N_CODE)
        ].tobytes()

    def quality_string(self, i: int, offset: int = 33) -> bytes:
        if self.quals is None:
            return b""
        return (self.quals[i, : self.lengths[i]] + offset).astype(np.uint8).tobytes()

    @staticmethod
    def from_sequences(
        seqs: list[bytes],
        quals: list[bytes] | None = None,
        ids: list[bytes] | None = None,
        qual_offset: int = 33,
        pad_to: int | None = None,
        ordinal: int = 0,
    ) -> "ReadBatch":
        """Build a batch from ASCII sequences (and optional ASCII quals)."""
        n = len(seqs)
        lengths = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=n)
        L = pad_to or bucket_length(int(lengths.max(initial=1)))
        bases = np.full((n, L), N_CODE, dtype=np.uint8)
        qarr = None
        if quals is not None:
            qarr = np.zeros((n, L), dtype=np.uint8)
        for i, s in enumerate(seqs):
            m = len(s)
            bases[i, :m] = BASE_TO_CODE[np.frombuffer(s, dtype=np.uint8)]
            if quals is not None:
                qarr[i, :m] = (
                    np.frombuffer(quals[i], dtype=np.uint8) - qual_offset
                )
        return ReadBatch(
            bases=bases,
            quals=qarr,
            lengths=lengths,
            ids=list(ids) if ids is not None else [b"r%d" % i for i in range(n)],
            ordinal=ordinal,
        )
