"""SAM output: records, CIGAR from match strings, MAPQ.

Parity targets in stream/SamLine.java:
  toCigar14 (:i match-string walk -> =/X ops, soft-clip out-of-bounds,
  D runs > INTRON_LIMIT become N) — transcribed exactly;
  toMapq (:2112-2125) — exact formula (SURVEY.md Appendix A.2);
  flag bits per the SAM spec as SamLine emits them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .readwrite import open_output

INTRON_LIMIT = 999999999  # SamLine.INTRON_LIMIT default


def cigar14_to_13(cigar: str) -> str:
    """SAM 1.4 (=/X) -> 1.3 (M) cigar (SamLine toCigar13 role): merge
    adjacent =/X runs into M."""
    if cigar == "*":
        return cigar
    import re

    out = []
    for n, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar):
        op = "M" if op in "=X" else op
        if out and out[-1][1] == op:
            out[-1][0] += int(n)
        else:
            out.append([int(n), op])
    return "".join(f"{n}{op}" for n, op in out)


def match_to_cigar14(match: bytes, read_start: int, reflen: int) -> str:
    """toCigar14: long-form match string -> SAM 1.4 CIGAR (=/X).

    read_start is the 0-based reference coordinate of the alignment start
    (may be negative); positions outside [0, reflen) soft-clip.
    """
    if not match:
        return "*"
    out = []
    count = 0
    mode = "="
    last = "="
    refloc = read_start
    for m0 in match:
        m = chr(m0)
        sfd = False
        if refloc < 0 or refloc >= reflen:
            mode = "S"
            if m != "I":
                refloc += 1
            if m == "D":
                sfd = True
        elif m in "ms":
            mode = "="
            refloc += 1
        elif m in "SV":
            mode = "X"
            refloc += 1
        elif m in "IXY":
            mode = "I"
        elif m == "D":
            mode = "D"
            refloc += 1
        elif m == "C":
            mode = "S"
            refloc += 1
        elif m in "NB":
            mode = "M"
            refloc += 1
        else:
            raise ValueError(f"invalid match char {m!r}")
        if mode != last:
            if count > 0:
                out.append(f"{count}{'N' if last == 'D' and count > INTRON_LIMIT else last}")
            count = 0
            last = mode
        count += 1
        if sfd:
            count -= 1
    out.append(f"{count}{'N' if mode == 'D' and count > INTRON_LIMIT else mode}")
    return "".join(out)


def to_mapq(score: int, length: int, mapped: bool, ambig: bool) -> int:
    """SamLine.toMapq (:2112-2125), bit-exact float math."""
    if not mapped or length < 1:
        return 0
    if ambig:
        mx = 3.0
        adjusted = (score * mx) / (100.0 * length)
        return max(1, round(adjusted))
    score2 = (score - length * 40) * 1.6
    mx = 1.5 * math.log2(length) + 36
    adjusted = (score2 * mx) / (100.0 * length)
    return max(4, round(adjusted))


# flag bits
FPAIRED = 0x1
FPROPER = 0x2
FUNMAPPED = 0x4
FMATE_UNMAPPED = 0x8
FREVERSE = 0x10
FMATE_REVERSE = 0x20
FFIRST = 0x40
FSECOND = 0x80
FSECONDARY = 0x100
FDUP = 0x400


@dataclass
class SamRecord:
    qname: bytes
    flag: int
    rname: bytes
    pos: int  # 1-based
    mapq: int
    cigar: str
    rnext: bytes = b"*"
    pnext: int = 0
    tlen: int = 0
    seq: bytes = b"*"
    qual: bytes = b"*"
    tags: list[bytes] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        fields = [
            self.qname,
            str(self.flag).encode(),
            self.rname,
            str(self.pos).encode(),
            str(self.mapq).encode(),
            self.cigar.encode(),
            self.rnext,
            str(self.pnext).encode(),
            str(self.tlen).encode(),
            self.seq,
            self.qual,
        ] + self.tags
        return b"\t".join(fields) + b"\n"


class SamWriter:
    """Ordered SAM/BAM writer. A `.bam` path switches to the binary BAM
    codec (io/bam.py, in-process BGZF — the reference needs samtools for
    this, fileIO/ReadWrite.java)."""

    def __init__(self, path: str, ref_names: list[bytes], ref_lengths,
                 program: bytes = b"bbtools_torch", version: bytes = b"0.1.0",
                 cmdline: bytes = b""):
        header = bytearray(b"@HD\tVN:1.4\tSO:unsorted\n")
        for name, ln in zip(ref_names, ref_lengths):
            header += b"@SQ\tSN:" + name.split()[0] + b"\tLN:%d\n" % int(ln)
        header += (
            b"@PG\tID:" + program + b"\tPN:" + program + b"\tVN:" + version
            + (b"\tCL:" + cmdline if cmdline else b"") + b"\n"
        )
        self._bam = None
        if path.endswith(".bam"):
            from .bam import BamWriter

            refs = [
                (n.split()[0], int(ln))
                for n, ln in zip(ref_names, ref_lengths)
            ]
            self._bam = BamWriter(path, bytes(header), refs)
            self.fh = None
        else:
            self.fh = open_output(path)
            self.fh.write(bytes(header))
        self._held: dict[int, bytes] = {}
        self._next = 0

    def _emit(self, payload: bytes):
        if self._bam is None:
            self.fh.write(payload)
            return
        from .bam import encode_record, encode_tags
        from .sam_read import SamRecord as _SR

        for line in payload.splitlines():
            if not line or line.startswith(b"@"):
                continue
            f = line.split(b"\t")
            # rnext must ride the record: encode_record's getattr sees
            # SamRecord's dataclass default b"*" before any kwarg
            rec = _SR(
                qname=f[0], flag=int(f[1]), rname=f[2], pos=int(f[3]),
                mapq=int(f[4]), cigar=f[5].decode(), seq=f[9], qual=f[10],
                rnext=f[6],
            )
            self._bam.write_record(
                rec,
                mate_rname=f[6],
                mate_pos=int(f[7]),
                tlen=int(f[8]),
                tags=encode_tags(f[11:]),
            )

    def add_batch(self, ordinal: int, payload: bytes):
        self._held[ordinal] = payload
        while self._next in self._held:
            self._emit(self._held.pop(self._next))
            self._next += 1

    def close(self):
        for k in sorted(self._held):
            self._emit(self._held.pop(k))
        if self._bam is not None:
            self._bam.close()
        elif hasattr(self.fh, "close"):
            self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
