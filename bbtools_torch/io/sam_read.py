"""SAM input: parse records and reconstruct long-form match strings.

Counterpart of stream/SamReadInputStream + SamLine parsing (SamLine.java)
for the variant-calling path: CIGAR (=/X or M ops) + SEQ + reference
-> the internal long match string ('m','S','N','I','D','C') that
var2/Var.toVars walks (SURVEY.md Appendix A.1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.dna import BASE_TO_CODE
from .readwrite import open_input


@dataclass
class SamRecord:
    qname: bytes
    flag: int
    rname: bytes
    pos: int  # 1-based
    mapq: int
    cigar: str
    seq: bytes
    qual: bytes  # phred+33 ascii
    rnext: bytes = b"*"  # mate's reference name ('=' for same)

    @property
    def mapped(self) -> bool:
        return not (self.flag & 0x4)

    @property
    def strand(self) -> int:
        return 1 if self.flag & 0x10 else 0

    @property
    def pairnum(self) -> int:
        return 1 if self.flag & 0x80 else 0

    @property
    def proper_pair(self) -> bool:
        return bool(self.flag & 0x2)

    @property
    def secondary(self) -> bool:
        return bool(self.flag & 0x100 or self.flag & 0x800)


def iter_sam(path: str):
    """Yield SamRecords from a SAM or BAM file (by extension/magic)."""
    if path.endswith(".bam"):
        from .bam import read_bam

        it = read_bam(path)
        next(it)  # (header_text, refs)
        yield from it
        return
    with open_input(path) as fh:
        for line in fh:
            if line.startswith(b"@"):
                continue
            f = line.rstrip(b"\n").split(b"\t")
            if len(f) < 11:
                continue
            yield SamRecord(
                qname=f[0],
                flag=int(f[1]),
                rname=f[2],
                pos=int(f[3]),
                mapq=int(f[4]),
                cigar=f[5].decode(),
                seq=f[9],
                qual=f[10],
                rnext=f[6],
            )


def parse_cigar(cigar: str):
    out = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append((int(num), ch))
            num = ""
    return out


def cigar_to_match(rec: SamRecord, ref_codes: np.ndarray) -> bytes:
    """Long-form match string from CIGAR + SEQ + reference scaffold codes.

    '=' -> m, 'X' -> S, 'M' -> per-base compare, I -> I, D -> D,
    S (clip) -> C (SamLine cigar semantics in reverse).
    """
    if rec.cigar == "*":
        return b""
    seq_codes = BASE_TO_CODE[np.frombuffer(rec.seq, dtype=np.uint8)]
    out = bytearray()
    rpos = rec.pos - 1
    bpos = 0
    for n, op in parse_cigar(rec.cigar):
        if op == "=":
            out += b"m" * n
            rpos += n
            bpos += n
        elif op == "X":
            for i in range(n):
                c = seq_codes[bpos + i]
                r = ref_codes[rpos + i] if 0 <= rpos + i < len(ref_codes) else 4
                out += b"N" if (c >= 4 or r >= 4) else b"S"
            rpos += n
            bpos += n
        elif op == "M":
            for i in range(n):
                c = seq_codes[bpos + i]
                r = ref_codes[rpos + i] if 0 <= rpos + i < len(ref_codes) else 4
                if c == r and c < 4:
                    out += b"m"
                elif c >= 4 or r >= 4:
                    out += b"N"
                else:
                    out += b"S"
            rpos += n
            bpos += n
        elif op == "I":
            out += b"I" * n
            bpos += n
        elif op in ("D", "N"):
            out += b"D" * n
            rpos += n
        elif op in ("S",):
            out += b"C" * n
            bpos += n
        elif op == "H":
            pass
        else:
            raise ValueError(f"cigar op {op}")
    return bytes(out)
