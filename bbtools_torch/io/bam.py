"""BAM binary alignment codec over BGZF — no samtools dependency.

Encodes/decodes BAM v1 records (SAM spec §4.2). The reference can only
produce BAM by piping SAM through an external `samtools view` process
(fileIO/ReadWrite.java:getOutputStreamFromProcess); this implementation is
self-contained: BGZF blocks (io/bgzf.py) with in-process MT compression.

Record layout: block_size, refID, pos, l_read_name, mapq, bin, n_cigar_op,
flag, l_seq, next_refID, next_pos, tlen, read_name\\0, cigar(u32 op|len),
seq 4-bit nibbles (=ACMGRSVTWYHKDBN), qual raw (0xFF if absent), tags.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from .bgzf import BgzfReader, BgzfWriter
from .sam_read import SamRecord, parse_cigar

SEQ_NIBBLE = b"=ACMGRSVTWYHKDBN"
NIBBLE_OF = {c: i for i, c in enumerate(SEQ_NIBBLE)}
for _lo, _up in zip(b"acgtn", b"ACGTN"):
    NIBBLE_OF[_lo] = NIBBLE_OF[_up]
CIGAR_OPS = "MIDNSHP=X"
CIGAR_CODE = {op: i for i, op in enumerate(CIGAR_OPS)}

_REC_HEAD = struct.Struct("<iiBBHHHiiii")  # after block_size


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning scheme (SAM spec §5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _ref_span(cigar: str) -> int:
    span = 0
    for n, op in parse_cigar(cigar):
        if op in "MDN=X":
            span += n
    return span


def encode_tags(tag_fields) -> bytes:
    """Text SAM tags (XX:T:val) -> binary BAM tag stream (spec §4.2.4)."""
    out = bytearray()
    for t in tag_fields:
        if isinstance(t, str):
            t = t.encode()
        tag, typ, val = t.split(b":", 2)
        out += tag
        if typ == b"i":
            out += b"i" + struct.pack("<i", int(val))
        elif typ == b"A":
            out += b"A" + val[:1]
        elif typ == b"f":
            out += b"f" + struct.pack("<f", float(val))
        elif typ == b"Z":
            out += b"Z" + val + b"\0"
        else:  # H/B and exotics: ship as Z to stay lossless-ish
            out += b"Z" + typ + b":" + val + b"\0"
    return bytes(out)


def encode_record(
    rec, ref_ids: dict, mate_rname: bytes = b"*", mate_pos: int = 0,
    tlen: int = 0, tags: bytes = b"",
) -> bytes:
    """Encode one alignment. `rec` needs qname/flag/rname/pos/mapq/cigar/
    seq/qual attributes (SamRecord or SamWriter row); rnext/pnext/tlen
    attributes override the keyword defaults when present."""
    mate_rname = getattr(rec, "rnext", mate_rname)
    mate_pos = getattr(rec, "pnext", mate_pos)
    tlen = getattr(rec, "tlen", tlen)
    rec_tags = getattr(rec, "tags", None)
    if rec_tags and not tags:
        tags = encode_tags(rec_tags)
    name = rec.qname if isinstance(rec.qname, bytes) else rec.qname.encode()
    refid = ref_ids.get(rec.rname, -1)
    pos0 = rec.pos - 1
    cigar = rec.cigar if rec.cigar != "*" else ""
    ops = parse_cigar(cigar) if cigar else []
    seq = rec.seq if isinstance(rec.seq, bytes) else rec.seq.encode()
    qual = rec.qual if isinstance(rec.qual, bytes) else rec.qual.encode()
    l_seq = 0 if seq == b"*" else len(seq)

    packed_cigar = b"".join(
        struct.pack("<I", (n << 4) | CIGAR_CODE[op]) for n, op in ops
    )
    if l_seq:
        nib = np.frombuffer(seq, np.uint8)
        vals = np.array([NIBBLE_OF.get(int(c), 15) for c in nib], np.uint8)
        if len(vals) % 2:
            vals = np.append(vals, 0)
        packed_seq = ((vals[0::2] << 4) | vals[1::2]).tobytes()
        if qual == b"*":
            packed_qual = b"\xff" * l_seq
        else:
            packed_qual = (np.frombuffer(qual, np.uint8) - 33).tobytes()
    else:
        packed_seq = b""
        packed_qual = b""

    next_refid = (
        refid if mate_rname == b"=" else ref_ids.get(mate_rname, -1)
    )
    end = pos0 + max(_ref_span(cigar), 1)
    body = (
        _REC_HEAD.pack(
            refid,
            pos0,
            len(name) + 1,
            rec.mapq,
            reg2bin(max(pos0, 0), max(end, 1)) if refid >= 0 else 4680,
            len(ops),
            rec.flag,
            l_seq,
            next_refid,
            mate_pos - 1,
            tlen,
        )
        + name
        + b"\0"
        + packed_cigar
        + packed_seq
        + packed_qual
        + tags
    )
    return struct.pack("<I", len(body)) + body


class BamWriter:
    """Writes a BAM file from SAM-level records.

    header_text: the SAM header (@HD/@SQ lines, bytes);
    refs: ordered list of (name_bytes, length).
    index=True also writes `path.bai` (BamIndexWriter analog,
    stream/bam/BamIndexWriter in the reference) — requires coordinate-
    sorted input, which the caller is responsible for.
    """

    def __init__(self, path: str, header_text: bytes, refs, threads: int = 4,
                 index: bool = False):
        self._fh = BgzfWriter(open(path, "wb"), threads=threads)
        self.ref_ids = {name: i for i, (name, _) in enumerate(refs)}
        hdr = b"BAM\x01" + struct.pack("<i", len(header_text)) + header_text
        hdr += struct.pack("<i", len(refs))
        for name, length in refs:
            hdr += struct.pack("<i", len(name) + 1) + name + b"\0"
            hdr += struct.pack("<i", length)
        self._fh.write(hdr)
        self._index = BaiBuilder(len(refs), path + ".bai") if index else None

    def write_record(self, rec, **kw) -> None:
        if self._index is not None:
            vbeg = self._fh.tell_virtual()
            self._fh.write(encode_record(rec, self.ref_ids, **kw))
            vend = self._fh.tell_virtual()
            refid = self.ref_ids.get(rec.rname, -1)
            pos0 = rec.pos - 1
            span = _ref_span(rec.cigar if rec.cigar != "*" else "")
            self._index.add(refid, pos0, pos0 + max(span, 1), vbeg, vend)
        else:
            self._fh.write(encode_record(rec, self.ref_ids, **kw))

    def close(self) -> None:
        self._fh.close()
        if self._index is not None:
            self._index.write()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass
class BamRef:
    name: bytes
    length: int


def read_bam(path: str):
    """Yield (header_text, refs) once, then SamRecord per alignment."""
    fh = BgzfReader(open(path, "rb"))
    magic = fh.read(4)
    if magic != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file (magic {magic!r})")
    (l_text,) = struct.unpack("<i", fh.read(4))
    header_text = fh.read(l_text)
    (n_ref,) = struct.unpack("<i", fh.read(4))
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", fh.read(4))
        name = fh.read(l_name)[:-1]
        (length,) = struct.unpack("<i", fh.read(4))
        refs.append(BamRef(name, length))
    yield header_text, refs

    while True:
        raw = fh.read(4)
        if len(raw) < 4:
            break
        (block_size,) = struct.unpack("<I", raw)
        body = fh.read(block_size)
        (
            refid, pos0, l_name, mapq, _bin, n_cigar, flag, l_seq,
            next_refid, next_pos0, tlen,
        ) = _REC_HEAD.unpack_from(body, 0)
        off = _REC_HEAD.size
        name = body[off : off + l_name - 1]
        off += l_name
        cigar_ops = struct.unpack_from(f"<{n_cigar}I", body, off)
        off += 4 * n_cigar
        cigar = (
            "".join(f"{v >> 4}{CIGAR_OPS[v & 0xF]}" for v in cigar_ops)
            or "*"
        )
        nseq = (l_seq + 1) // 2
        seq_bytes = np.frombuffer(body[off : off + nseq], np.uint8)
        off += nseq
        nib = np.empty(nseq * 2, np.uint8)
        nib[0::2] = seq_bytes >> 4
        nib[1::2] = seq_bytes & 0xF
        seq = np.frombuffer(SEQ_NIBBLE, np.uint8)[nib[:l_seq]].tobytes()
        qual_raw = body[off : off + l_seq]
        off += l_seq
        if l_seq and qual_raw[0] == 0xFF:
            qual = b"*"
        else:
            qual = (np.frombuffer(qual_raw, np.uint8) + 33).tobytes()
        rname = refs[refid].name if refid >= 0 else b"*"
        rnext = _rnext_name(refid, next_refid, refs)
        yield SamRecord(
            qname=name,
            flag=flag,
            rname=rname,
            pos=pos0 + 1,
            mapq=mapq,
            cigar=cigar,
            seq=seq if l_seq else b"*",
            qual=qual if l_seq else b"*",
            rnext=rnext,
        )
    fh.close()


class BaiBuilder:
    """BAI index accumulator (SAM spec §5.2; BamIndexWriter analog)."""

    def __init__(self, n_ref: int, path: str):
        self.path = path
        self.bins = [dict() for _ in range(n_ref)]  # bin -> [(beg,end)...]
        self.linear = [dict() for _ in range(n_ref)]  # 16kb win -> min voff

    def add(self, refid, beg, end, vbeg, vend):
        if refid < 0:
            return
        b = reg2bin(beg, end)
        self.bins[refid].setdefault(b, []).append((vbeg, vend))
        for w in range(beg >> 14, ((max(end, beg + 1) - 1) >> 14) + 1):
            cur = self.linear[refid].get(w)
            if cur is None or vbeg < cur:
                self.linear[refid][w] = vbeg

    def write(self):
        out = bytearray(b"BAI\x01")
        out += struct.pack("<i", len(self.bins))
        for refid in range(len(self.bins)):
            bins = self.bins[refid]
            out += struct.pack("<i", len(bins))
            for b, chunks in sorted(bins.items()):
                # merge adjacent chunks
                merged = []
                for beg, end in sorted(chunks):
                    if merged and beg <= merged[-1][1]:
                        merged[-1] = (merged[-1][0], max(end, merged[-1][1]))
                    else:
                        merged.append((beg, end))
                out += struct.pack("<Ii", b, len(merged))
                for beg, end in merged:
                    out += struct.pack("<QQ", beg, end)
            lin = self.linear[refid]
            n = (max(lin) + 1) if lin else 0
            out += struct.pack("<i", n)
            prev = 0
            for w in range(n):
                v = lin.get(w, prev)
                out += struct.pack("<Q", v)
                prev = v
        with open(self.path, "wb") as fh:
            fh.write(bytes(out))


def _reg2bins(beg: int, end: int):
    """All bins overlapping [beg, end) (SAM spec §5.3 reg2bins)."""
    end -= 1
    out = [0]
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out += list(range(off + (beg >> shift), off + (end >> shift) + 1))
    return out


def read_bai(path: str):
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"BAI\x01":
        raise ValueError(f"{path}: not a BAI index")
    off = 4
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    refs = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bins = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                beg, end = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((beg, end))
            bins[b] = chunks
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        linear = list(
            struct.unpack_from(f"<{n_intv}Q", data, off)
        )
        off += 8 * n_intv
        refs.append((bins, linear))
    return refs


def fetch(bam_path: str, rname: bytes, beg: int, end: int):
    """Random-access region query via the .bai index: yields overlapping
    SamRecords without scanning the whole file."""
    import io as _io

    index = read_bai(bam_path + ".bai")
    # find refid from the BAM header
    it = read_bam(bam_path)
    _header, refs = next(it)
    it.close() if hasattr(it, "close") else None
    refid = next(
        (i for i, r in enumerate(refs) if r.name == rname), -1
    )
    if refid < 0 or refid >= len(index):
        return
    bins, linear = index[refid]
    min_voff = linear[beg >> 14] if (beg >> 14) < len(linear) else 0
    chunks = []
    for b in _reg2bins(beg, end):
        for c in bins.get(b, ()):
            if c[1] > min_voff:
                chunks.append(c)
    if not chunks:
        return
    # coordinate-sorted input: seek to the earliest candidate chunk and
    # scan forward until records start past the region
    vbeg = min(c[0] for c in chunks)
    raw = open(bam_path, "rb")
    coffset, uoffset = vbeg >> 16, vbeg & 0xFFFF
    raw.seek(coffset)
    reader = BgzfReader(raw)
    reader.read(uoffset)  # skip into the block
    while True:
        head = reader.read(4)
        if len(head) < 4:
            break
        (block_size,) = struct.unpack("<I", head)
        body = reader.read(block_size)
        rec = _decode_record_body(body, refs)
        if rec.rname == rname and rec.pos - 1 >= end:
            break
        if rec.rname != rname:
            continue
        span = _ref_span(rec.cigar if rec.cigar != "*" else "")
        if rec.pos - 1 + max(span, 1) > beg:
            yield rec
    raw.close()


def _decode_record_body(body: bytes, refs):
    (
        refid, pos0, l_name, mapq, _bin, n_cigar, flag, l_seq,
        next_refid, next_pos0, tlen,
    ) = _REC_HEAD.unpack_from(body, 0)
    off = _REC_HEAD.size
    name = body[off : off + l_name - 1]
    off += l_name
    cigar_ops = struct.unpack_from(f"<{n_cigar}I", body, off)
    off += 4 * n_cigar
    cigar = (
        "".join(f"{v >> 4}{CIGAR_OPS[v & 0xF]}" for v in cigar_ops) or "*"
    )
    nseq = (l_seq + 1) // 2
    seq_bytes = np.frombuffer(body[off : off + nseq], np.uint8)
    off += nseq
    nib = np.empty(nseq * 2, np.uint8)
    nib[0::2] = seq_bytes >> 4
    nib[1::2] = seq_bytes & 0xF
    seq = np.frombuffer(SEQ_NIBBLE, np.uint8)[nib[:l_seq]].tobytes()
    qual_raw = body[off : off + l_seq]
    if l_seq and qual_raw and qual_raw[0] == 0xFF:
        qual = b"*"
    else:
        qual = (np.frombuffer(qual_raw, np.uint8) + 33).tobytes()
    rname = refs[refid].name if refid >= 0 else b"*"
    return SamRecord(
        qname=name, flag=flag, rname=rname, pos=pos0 + 1, mapq=mapq,
        cigar=cigar, seq=seq if l_seq else b"*",
        qual=qual if l_seq else b"*",
        rnext=_rnext_name(refid, next_refid, refs),
    )


def _rnext_name(refid: int, next_refid: int, refs) -> bytes:
    """SAM text semantics for the mate reference: '=' when same ref."""
    if next_refid < 0:
        return b"*"
    if next_refid == refid:
        return b"="
    return refs[next_refid].name
