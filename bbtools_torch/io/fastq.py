"""Vectorized FASTQ codec producing/consuming ReadBatch.

Behavior parity targets (stream/FASTQ.java):
  - quality-offset autodetection 33 vs 64 from a sample of reads
    (FASTQ.java:217-266 heuristics; we use the byte-range rule)
  - interleaved-pair detection from /1 /2 or ' 1:' ' 2:' header suffixes
  - 4-line records; '+' line content ignored

The parser is numpy-vectorized: one pass finds newlines, then padded base
and qual matrices are gathered with a single fancy index — no per-base
Python. Files are streamed in large chunks so memory stays bounded.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from ..core.dna import BASE_TO_CODE, CODE_TO_BASE, N_CODE
from .batch import ReadBatch, bucket_length
from .readwrite import open_input, open_output

DEFAULT_BATCH_READS = 16384
CHUNK_BYTES = 16 << 20  # best pipeline granularity measured on 4 cores


def detect_quality_offset(sample_quals: np.ndarray) -> int:
    """33 vs 64 from raw quality bytes (FASTQ.java:217-266 rule of thumb).

    Bytes below 59 can only occur with offset 33; with all bytes >= 64 and
    some above 74 ('J', the top of the offset-33 Illumina range) the file is
    almost certainly offset 64.
    """
    if sample_quals.size == 0:
        return 33
    lo = int(sample_quals.min())
    hi = int(sample_quals.max())
    if lo < 59:
        return 33
    if lo >= 64 and hi > 74:
        return 64
    return 33


def _split_lines(buf: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (starts, ends) of lines in a uint8 buffer ending with \\n.
    Native MT memchr scan when available; numpy single-pass fallback."""
    try:
        from ..native import scan_lines_native
    except Exception:
        scan_lines_native = None
    if scan_lines_native is not None and len(buf) >= (1 << 16):
        res = scan_lines_native(buf)
        if res is not None:
            return res
    ends = np.flatnonzero(buf == 10)
    starts = np.empty_like(ends)
    if len(ends):
        starts[0] = 0
        starts[1:] = ends[:-1] + 1
    # tolerate \r\n
    if len(ends) and buf[max(0, ends[0] - 1)] == 13:
        ends = ends - (buf[np.maximum(ends - 1, 0)] == 13).astype(ends.dtype)
    return starts, ends


def _gather_rows(
    buf: np.ndarray, starts: np.ndarray, lengths: np.ndarray, pad: int, fill: int
) -> np.ndarray:
    """Gather variable-length rows into a padded [B, pad] uint8 matrix."""
    idx = starts[:, None] + np.arange(pad, dtype=starts.dtype)[None, :]
    np.minimum(idx, len(buf) - 1, out=idx)
    out = buf[idx]
    mask = np.arange(pad)[None, :] >= lengths[:, None]
    out[mask] = fill
    return out


class FastqReader:
    """Chunked, vectorized FASTQ reader yielding ReadBatch objects."""

    def __init__(
        self,
        path: str,
        batch_reads: int = DEFAULT_BATCH_READS,
        qual_offset: int | None = None,
        pad_to: int | None = None,
        with_ascii: bool = True,
        with_quals: bool = True,
    ):
        self.path = path
        self.batch_reads = batch_reads
        self.qual_offset = qual_offset
        self.pad_to = pad_to
        #: with_ascii=False skips the raw-byte plane (compute-only
        #: tools that never re-emit reads save a third of fill writes);
        #: with_quals=False also skips the quality plane (kmer-spectrum
        #: readers touch only bases+lengths)
        self.with_ascii = with_ascii
        self.with_quals = with_quals
        self.reads_in = 0
        self.bases_in = 0

    def _chunks(self, fh):
        """Prefetch thread: file/gzip reads overlap the main thread's
        parse/fill work (the GIL is released inside read() and inside the
        native ctypes calls — the reference runs its codec on worker
        threads for the same reason, fileIO/ByteFile2)."""
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=2)

        def feed():
            try:
                while True:
                    data = fh.read(CHUNK_BYTES)
                    if not data:
                        q.put(None)
                        return
                    q.put(data)
            except BaseException as e:  # surface errors in the consumer
                q.put(e)

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def __iter__(self) -> Iterator[ReadBatch]:
        try:
            from ..native import get_lib

            lib = get_lib()
        except Exception:
            lib = None
        if lib is not None and self.pad_to is None:
            return self._iter_native()
        return self._iter_slow()

    # ---- pipelined native path: read thread -> codec thread -> main ----
    #
    # The reference decodes FASTQ on worker threads feeding a consumer
    # (fileIO/ByteFile2, stream/FASTQ MT parse). Same shape here: one
    # thread reads 32 MB chunks, one thread newline-scans + fills WHOLE
    # chunks into padded SoA planes (all native calls, GIL released), and
    # the main thread slices zero-copy per-batch views. Filling per chunk
    # instead of per batch amortizes the pthread fan-out and lets malloc
    # hand back the same (already-faulted) planes every chunk.

    def _decode_chunk(self, buf, starts, ends):
        """codec-thread work: one parsed chunk -> SoA planes + ids. The
        raw-ASCII plane is DEFERRED (LazyAscii over the chunk buffer):
        consumers that never touch `ascii_bases` — filters, counters,
        anything not re-emitting raw bytes — never pay the third plane's
        fill (the full-plane vs compute-only ingest gap)."""
        from .batch import IdView, LazyAscii

        nrec = len(starts) // 4
        lengths0 = (ends[1::4] - starts[1::4]).astype(np.int32)
        L = bucket_length(int(lengths0.max(initial=1)))
        if self.qual_offset is None:
            if self.with_quals:
                nsamp = min(1024, nrec)
                samp = _gather_rows(
                    buf, starts[3::4][:nsamp], lengths0[:nsamp], L, 0
                )
                mask = np.arange(L)[None, :] < lengths0[:nsamp, None]
                self.qual_offset = detect_quality_offset(samp[mask])
            else:
                self.qual_offset = 33
        res = _native_build(
            [(buf, starts, ends, lengths0)], L, self.qual_offset,
            False, self.with_quals,
        )
        if res is None:  # native lib vanished mid-stream; cannot happen
            raise RuntimeError("native codec unavailable")
        bases, quals, _none, lengths = res
        ascii_b = (
            LazyAscii([(buf, starts[1::4], lengths0)], L)
            if self.with_ascii else None
        )
        ids = IdView(buf, starts[0::4] + 1, ends[0::4])
        return bases, quals, ascii_b, lengths, ids

    def _iter_native(self) -> Iterator[ReadBatch]:
        import queue
        import threading

        fh = open_input(self.path)
        q1: queue.Queue = queue.Queue(maxsize=2)
        q2: queue.Queue = queue.Queue(maxsize=2)

        def feed():
            try:
                while True:
                    data = fh.read(CHUNK_BYTES)
                    if not data:
                        q1.put(None)
                        return
                    q1.put(data)
            except BaseException as e:
                q1.put(e)

        def codec():
            leftover: np.ndarray | None = None
            try:
                while True:
                    item = q1.get()
                    if isinstance(item, BaseException):
                        q2.put(item)
                        return
                    if item is None:
                        if leftover is not None and len(leftover):
                            tail = leftover.tobytes()
                            if tail.strip():
                                if not tail.endswith(b"\n"):
                                    tail += b"\n"
                                buf = np.frombuffer(tail, np.uint8)
                                starts, ends = _split_lines(buf)
                                nrec = len(starts) // 4
                                if nrec:
                                    q2.put(self._decode_chunk(
                                        buf, starts[: nrec * 4],
                                        ends[: nrec * 4]))
                        q2.put(None)
                        return
                    new = np.frombuffer(item, dtype=np.uint8)
                    if leftover is not None and len(leftover):
                        buf = np.concatenate([leftover, new])
                    else:
                        buf = new
                    leftover = None
                    starts, ends = _split_lines(buf)
                    nrec = len(starts) // 4
                    if nrec == 0:
                        leftover = buf
                        continue
                    e = int(ends[nrec * 4 - 1])
                    cut = e + (2 if e < len(buf) and buf[e] == 13 else 1)
                    leftover = buf[cut:]
                    q2.put(self._decode_chunk(
                        buf, starts[: nrec * 4], ends[: nrec * 4]))
            except BaseException as e:
                q2.put(e)

        threading.Thread(target=feed, daemon=True).start()
        threading.Thread(target=codec, daemon=True).start()
        ordinal = 0
        numeric_id = 0
        pend: list[list] = []  # [planes..., ids, row_offset]
        pend_rows = 0
        done = False
        try:
            while True:
                while not done and pend_rows < self.batch_reads:
                    item = q2.get()
                    if isinstance(item, BaseException):
                        raise item
                    if item is None:
                        done = True
                        break
                    pend.append([*item, 0])
                    pend_rows += len(item[3])
                if pend_rows == 0:
                    return
                take = min(self.batch_reads, pend_rows)
                batch = self._assemble(pend, take, ordinal, numeric_id)
                pend_rows -= take
                numeric_id += batch.n
                ordinal += 1
                yield batch
        finally:
            if hasattr(fh, "close"):
                fh.close()

    def _assemble(self, pend, take, ordinal, numeric_id) -> ReadBatch:
        """Slice `take` rows off the pending decoded chunks. The common
        case (one chunk covers the batch) is pure views; a chunk
        boundary copies just that one batch, padding the narrower plane
        set to the wider L."""
        parts = []
        got = 0
        while got < take:
            p = pend[0]
            bases, quals, ascii_b, lengths, ids, off = p
            avail = len(lengths) - off
            use = min(avail, take - got)
            parts.append((p, off, use))
            got += use
            if use == avail:
                pend.pop(0)
            else:
                p[5] = off + use
        if len(parts) == 1:
            p, off, use = parts[0]
            bases, quals, ascii_b, lengths, ids, _ = p
            sl = slice(off, off + use)
            b = ReadBatch(
                bases=bases[sl],
                quals=None if quals is None else quals[sl],
                lengths=lengths[sl],
                ids=ids[sl], ordinal=ordinal, numeric_id0=numeric_id,
            )
            b.set_lazy_ascii(
                None if ascii_b is None else ascii_b.slice(off, use)
            )
        else:
            from .batch import LazyAscii

            L = max(p[0].shape[1] for p, _, _ in parts)

            def wide(a, fill):
                if a.shape[1] == L:
                    return a
                out = np.full((a.shape[0], L), fill, a.dtype)
                out[:, : a.shape[1]] = a
                return out

            b = ReadBatch(
                bases=np.concatenate(
                    [wide(p[0][o : o + u], 4) for p, o, u in parts]),
                quals=(
                    None if parts[0][0][1] is None else np.concatenate(
                        [wide(p[1][o : o + u], 0) for p, o, u in parts])
                ),
                lengths=np.concatenate(
                    [p[3][o : o + u] for p, o, u in parts]),
                ids=[i for p, o, u in parts for i in p[4][o : o + u]],
                ordinal=ordinal,
                numeric_id0=numeric_id,
            )
            if parts[0][0][2] is None:
                b.set_lazy_ascii(None)
            else:
                b.set_lazy_ascii(LazyAscii(
                    [seg
                     for p, o, u in parts
                     for seg in p[2].slice(o, u).segs],
                    L,
                ))
        self.reads_in += b.n
        self.bases_in += int(b.lengths.sum())
        return b

    def _iter_slow(self) -> Iterator[ReadBatch]:
        fh = open_input(self.path)
        leftover: np.ndarray | None = None
        ordinal = 0
        numeric_id = 0
        pending: list[tuple[np.ndarray, ...]] = []  # parsed record arrays
        pend_count = 0
        try:
            for chunk in self._chunks(fh):
                new = np.frombuffer(chunk, dtype=np.uint8)
                if leftover is not None and len(leftover):
                    buf = np.concatenate([leftover, new])
                else:
                    buf = new
                leftover = None
                starts, ends = _split_lines(buf)
                nrec = len(starts) // 4
                if nrec == 0:
                    leftover = buf
                    continue
                # raw end of the last full record: the adjusted end points
                # before a stripped \r, so the newline sits 1 (or 2) bytes
                # later — no second newline scan needed
                e = int(ends[nrec * 4 - 1])
                cut = e + (2 if e < len(buf) and buf[e] == 13 else 1)
                leftover = buf[cut:]
                # view, not copy: the chunk array stays alive via base
                pending.append(
                    (buf[:cut], starts[: nrec * 4], ends[: nrec * 4])
                )
                pend_count += nrec
                while pend_count >= self.batch_reads:
                    batch, pending, pend_count = self._emit(
                        pending, self.batch_reads, ordinal, numeric_id
                    )
                    numeric_id += batch.n
                    ordinal += 1
                    yield batch
            tail = leftover.tobytes() if leftover is not None else b""
            if tail.strip():
                if not tail.endswith(b"\n"):
                    tail += b"\n"
                buf = np.frombuffer(tail, dtype=np.uint8)
                starts, ends = _split_lines(buf)
                nrec = len(starts) // 4
                if nrec:
                    pending.append((buf, starts[: nrec * 4], ends[: nrec * 4]))
                    pend_count += nrec
            while pend_count > 0:
                batch, pending, pend_count = self._emit(
                    pending, self.batch_reads, ordinal, numeric_id
                )
                numeric_id += batch.n
                ordinal += 1
                yield batch
        finally:
            if hasattr(fh, "close"):
                fh.close()

    def _emit(self, pending, want, ordinal, numeric_id):
        """Assemble up to `want` reads from pending parsed chunks."""
        take = []
        count = 0
        rest = []
        for buf, starts, ends in pending:
            n = len(starts) // 4
            if count >= want:
                rest.append((buf, starts, ends))
                continue
            use = min(n, want - count)
            take.append((buf, starts[: use * 4], ends[: use * 4]))
            if use < n:
                rest.append((buf, starts[use * 4 :], ends[use * 4 :]))
            count += use
        batch = self._build(take, ordinal, numeric_id)
        return batch, rest, sum(len(s) // 4 for _, s, _ in rest)

    def _build(self, parts, ordinal, numeric_id) -> ReadBatch:
        seq_rows = []
        qual_rows = []
        len_rows = []
        ids: list[bytes] = []
        maxlen = 1
        for buf, starts, ends in parts:
            s_start, s_end = starts[1::4], ends[1::4]
            lengths = (s_end - s_start).astype(np.int32)
            maxlen = max(maxlen, int(lengths.max(initial=1)))
            len_rows.append((buf, starts, ends, lengths))
        L = self.pad_to or bucket_length(maxlen)
        if self.qual_offset is None:
            # detect from raw qual bytes of the first up-to-1024 records
            buf0, starts0, ends0, lengths0 = len_rows[0]
            nsamp = min(1024, len(starts0) // 4)
            samp = _gather_rows(
                buf0, starts0[3::4][:nsamp], lengths0[:nsamp], L, 0
            )
            mask = np.arange(L)[None, :] < lengths0[:nsamp, None]
            self.qual_offset = detect_quality_offset(samp[mask])
        native = _native_build(len_rows, L, self.qual_offset,
                               self.with_ascii)
        if native is not None:
            bases, q, seqs, lengths = native
            if len(len_rows) == 1:
                buf, starts, ends, _ = len_rows[0]
                from .batch import IdView

                # zero-copy: IdView holds the chunk ndarray itself —
                # bytes-ifying the 32 MB chunk per batch was ~60% of
                # total reader time (profiled)
                ids = IdView(buf, starts[0::4] + 1, ends[0::4])
            else:
                for buf, starts, ends, _ in len_rows:
                    h_start = starts[0::4]
                    h_end = ends[0::4]
                    if len(h_start) == 0:
                        continue
                    # copy only this part's span, not the whole chunk
                    lo = int(h_start[0])
                    blob = buf[lo : int(h_end[-1])].tobytes()
                    hs = (h_start - lo).tolist()
                    he = (h_end - lo).tolist()
                    ids.extend(
                        [blob[a + 1 : b] for a, b in zip(hs, he)]
                    )
            self.reads_in += len(lengths)
            self.bases_in += int(lengths.sum())
            return ReadBatch(
                bases=bases,
                quals=q,
                lengths=lengths,
                ids=ids,
                ordinal=ordinal,
                numeric_id0=numeric_id,
                ascii_bases=seqs,
            )
        for buf, starts, ends, lengths in len_rows:
            seq_rows.append(_gather_rows(buf, starts[1::4], lengths, L, ord("N")))
            qual_rows.append(_gather_rows(buf, starts[3::4], lengths, L, 0))
            blob = buf.tobytes()
            h_start = starts[0::4].tolist()
            h_end = ends[0::4].tolist()
            ids.extend([blob[a + 1 : b] for a, b in zip(h_start, h_end)])
        seqs = np.concatenate(seq_rows) if len(seq_rows) > 1 else seq_rows[0]
        quals = np.concatenate(qual_rows) if len(qual_rows) > 1 else qual_rows[0]
        lengths = np.concatenate([r[3] for r in len_rows])
        if self.qual_offset is None:
            sample = quals[: min(1024, len(quals))]
            self.qual_offset = detect_quality_offset(
                sample[np.arange(sample.shape[1])[None, :] < lengths[: len(sample), None]]
            )
        bases = BASE_TO_CODE[seqs]
        mask = np.arange(L)[None, :] >= lengths[:, None]
        bases[mask] = N_CODE
        q = quals.astype(np.int16) - self.qual_offset
        np.clip(q, 0, 93, out=q)
        q = q.astype(np.uint8)
        q[mask] = 0
        self.reads_in += len(lengths)
        self.bases_in += int(lengths.sum())
        return ReadBatch(
            bases=bases,
            quals=q,
            lengths=lengths,
            ids=ids,
            ordinal=ordinal,
            numeric_id0=numeric_id,
            ascii_bases=seqs,
        )


class FastqWriter:
    """Ordered FASTQ writer. Batches must be added in any order; they are
    released strictly by ordinal (ConcurrentGenericReadOutputStream.java:87
    invariant), so output is input-order-deterministic at any parallelism."""

    def __init__(self, path: str, qual_offset: int = 33, ziplevel: int | None = None):
        self.fh = open_output(path, ziplevel=ziplevel)
        self.qual_offset = qual_offset
        self._next = 0
        self._held: dict[int, bytes] = {}
        self.reads_out = 0
        self.bases_out = 0

    def add(self, batch: ReadBatch, keep: np.ndarray | None = None):
        payload = encode_fastq(batch, keep, self.qual_offset)
        if keep is None:
            self.reads_out += batch.n
            self.bases_out += int(batch.lengths.sum())
        else:
            self.reads_out += int(np.count_nonzero(keep))
            self.bases_out += int(batch.lengths[keep].sum())
        self._held[batch.ordinal] = payload
        while self._next in self._held:
            self.fh.write(self._held.pop(self._next))
            self._next += 1

    def close(self):
        for k in sorted(self._held):
            self.fh.write(self._held.pop(k))
        if hasattr(self.fh, "close"):
            self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def encode_fastq(
    batch: ReadBatch, keep: np.ndarray | None = None, qual_offset: int = 33
) -> bytes:
    """Serialize (a subset of) a batch to FASTQ bytes (native C emitter
    when available — the per-read python join measures ~55 Mbases/s)."""
    if batch.ascii_bases is not None:
        ascii_bases = batch.ascii_bases
    else:
        ascii_bases = CODE_TO_BASE[np.minimum(batch.bases, N_CODE)]
    q = batch.quals
    try:
        from ..native import emit_fastq_native
    except Exception:
        emit_fastq_native = None
    if emit_fastq_native is not None and batch.n:
        from .batch import IdView

        if isinstance(batch.ids, IdView) and batch.ids.materialized is None:
            idblob = batch.ids.blob
            idstart = batch.ids.starts
            idend = batch.ids.ends
        else:
            idblob = b"".join(batch.ids)
            idoff = np.zeros(batch.n + 1, np.int64)
            np.cumsum([len(x) for x in batch.ids], out=idoff[1:])
            idstart, idend = idoff[:-1], idoff[1:]
        quals = (
            q
            if q is not None
            else np.full(
                ascii_bases.shape, ord("I") - qual_offset, np.uint8
            )
        )
        res = emit_fastq_native(
            idblob, idstart, idend, ascii_bases, quals, batch.lengths,
            keep, qual_offset,
        )
        if res is not None:
            return res
    idxs = range(batch.n) if keep is None else np.flatnonzero(keep)
    ascii_quals = (
        (q + qual_offset).astype(np.uint8) if q is not None else None
    )
    parts: list[bytes] = []
    lengths = batch.lengths
    for i in idxs:
        m = lengths[i]
        parts.append(b"@" + batch.ids[i] + b"\n")
        parts.append(ascii_bases[i, :m].tobytes() + b"\n+\n")
        if ascii_quals is not None:
            parts.append(ascii_quals[i, :m].tobytes() + b"\n")
        else:
            parts.append(b"I" * int(m) + b"\n")
    return b"".join(parts)


def _native_build(len_rows, L, qual_offset, with_ascii=True,
                  with_quals=True):
    """Gather all parts with the native codec; None if unavailable."""
    try:
        from ..native import fill_records_native
    except Exception:
        return None
    outs = []
    for buf, starts, ends, lengths in len_rows:
        res = fill_records_native(buf, starts, ends, L, qual_offset,
                                  with_ascii=with_ascii,
                                  with_quals=with_quals)
        if res is None:
            return None
        outs.append(res)
    if len(outs) == 1:
        b, q, a, ln = outs[0]
    else:
        b = np.concatenate([o[0] for o in outs])
        q = (
            np.concatenate([o[1] for o in outs])
            if outs[0][1] is not None else None
        )
        a = (
            np.concatenate([o[2] for o in outs])
            if outs[0][2] is not None else None
        )
        ln = np.concatenate([o[3] for o in outs])
    return b, q, a, ln


def read_fastq(path: str, **kw) -> list[ReadBatch]:
    return list(FastqReader(path, **kw))


def write_fastq(path: str, batches, qual_offset: int = 33):
    with FastqWriter(path, qual_offset=qual_offset) as w:
        for b in batches:
            w.add(b)


def detect_interleaved(path: str) -> bool:
    """Peek the first two records: paired if headers end '/1' then '/2'
    (same stem) or carry ' 1:' then ' 2:' Casava fields
    (stream/FASTQ.java testInterleaved* heuristics)."""
    fh = open_input(path)
    try:
        lines = []
        while len(lines) < 8:
            l = fh.readline()
            if not l:
                return False
            lines.append(l.rstrip(b"\r\n"))
    finally:
        close = getattr(fh, "close", None)
        if close:
            close()
    h1, h2 = lines[0], lines[4]
    if not (h1.startswith(b"@") and h2.startswith(b"@")):
        return False
    if h1.endswith(b"/1") and h2.endswith(b"/2") and h1[:-2] == h2[:-2]:
        return True
    p1, p2 = h1.split(b" ", 1), h2.split(b" ", 1)
    if (
        len(p1) == 2
        and len(p2) == 2
        and p1[0] == p2[0]
        and p1[1].startswith(b"1:")
        and p2[1].startswith(b"2:")
    ):
        return True
    return False


def deinterleave(batch: ReadBatch) -> tuple[ReadBatch, ReadBatch]:
    """Split an interleaved batch into (r1, r2) halves (even/odd rows)."""
    n = batch.n - (batch.n % 2)

    def half(off):
        return ReadBatch(
            bases=batch.bases[off:n:2],
            quals=batch.quals[off:n:2] if batch.quals is not None else None,
            lengths=batch.lengths[off:n:2],
            ids=batch.ids[off:n:2] if batch.ids else [],
            ordinal=batch.ordinal,
            numeric_id0=batch.numeric_id0 // 2,
            ascii_bases=(
                batch.ascii_bases[off:n:2]
                if batch.ascii_bases is not None
                else None
            ),
        )

    return half(0), half(1)


def paired_reader(
    in1: str,
    in2: str | None = None,
    interleaved: bool | None = None,
    batch_reads: int = DEFAULT_BATCH_READS,
    qual_offset: int | None = None,
):
    """Yield (b1, b2) pairs from two files, one interleaved file, or a
    single unpaired file (b2=None). `interleaved=None` autodetects from
    the first two headers when in2 is absent (FASTQ.java interleaving
    detection; forced with the `interleaved=` flag)."""
    r1 = FastqReader(in1, batch_reads=batch_reads, qual_offset=qual_offset)
    if in2:
        r2 = FastqReader(in2, batch_reads=batch_reads, qual_offset=qual_offset)
        it2 = iter(r2)
        for b1 in r1:
            yield b1, next(it2, None)
        return
    if interleaved is None:
        interleaved = detect_interleaved(in1)
    if not interleaved:
        for b1 in r1:
            yield b1, None
        return
    # keep pairs intact across batch boundaries: even batch size
    if batch_reads % 2:
        r1.batch_reads = batch_reads + 1
    for b in r1:
        yield deinterleave(b)


def interleave(b1: ReadBatch, b2: ReadBatch) -> ReadBatch:
    """Merge paired batches row-alternating (r1,r2,r1,r2,...) for
    interleaved output."""
    n = b1.n
    L = max(b1.padded_len, b2.padded_len)

    def pad(x, fillv):
        if x.shape[1] == L:
            return x
        out = np.full((x.shape[0], L), fillv, dtype=x.dtype)
        out[:, : x.shape[1]] = x
        return out

    bases = np.empty((2 * n, L), dtype=b1.bases.dtype)
    bases[0::2] = pad(b1.bases, 4)
    bases[1::2] = pad(b2.bases, 4)
    quals = None
    if b1.quals is not None and b2.quals is not None:
        quals = np.empty((2 * n, L), dtype=b1.quals.dtype)
        quals[0::2] = pad(b1.quals, 0)
        quals[1::2] = pad(b2.quals, 0)
    lengths = np.empty(2 * n, dtype=b1.lengths.dtype)
    lengths[0::2] = b1.lengths
    lengths[1::2] = b2.lengths
    ids: list[bytes] = []
    for a, b in zip(b1.ids, b2.ids):
        ids.append(a)
        ids.append(b)
    ascii_bases = None
    if b1.ascii_bases is not None and b2.ascii_bases is not None:
        ascii_bases = np.empty((2 * n, L), dtype=b1.ascii_bases.dtype)
        ascii_bases[0::2] = pad(b1.ascii_bases, ord("N"))
        ascii_bases[1::2] = pad(b2.ascii_bases, ord("N"))
    return ReadBatch(
        bases=bases, quals=quals, lengths=lengths, ids=ids,
        ordinal=b1.ordinal, numeric_id0=b1.numeric_id0 * 2,
        ascii_bases=ascii_bases,
    )
