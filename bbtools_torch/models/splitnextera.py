"""SplitNexteraLMP — split Nextera long-mate-pair libraries by linker
orientation (splitnextera.sh, jgi/SplitNexteraLMP.java:355-556).

Reads carry a junction adapter (CTGTCTCTTATACACATCTAGATGTGTATAAGAGACAG —
palindromic, so one orientation suffices). Junction bases are either
pre-masked to `junction=J` (e.g. by bbduk ktmask=J) or found here with
mask=t. Split semantics follow the reference exactly:
  - r1.start/stop = first/last junction symbol; subreads keep their
    orientation (no reverse-complementing at split).
  - paired: outer LMP = (r1left, r2right), inner LMP = (r1right,
    r2left; emitted only with innerlmp=t), left/right fragments pair the
    remaining same-side pieces; leftovers are singletons. Pairs with no
    junction in either read go to outu.
  - single-end: LMP = (left, right) when both sides >= minlength; reads
    with no junction are singletons (SplitNexteraLMP.java:427-430).
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.parser import tokenize
from ..io.fastq import paired_reader
from ..io.readwrite import open_output

JUNCTION = b"CTGTCTCTTATACACATCTAGATGTGTATAAGAGACAG"
B2C = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    B2C[_b] = _i
    B2C[_b + 32] = _i


def mask_junction(seq: bytearray, hdist: int = 1, k: int = 19,
                  symbol: int = ord("J")) -> int:
    """Mask every k-window matching a junction k-mer within hdist subs
    (the bbduk ktmask=J k=19 hdist=1 equivalent). Returns masked bases."""
    codes = B2C[np.frombuffer(bytes(seq), dtype=np.uint8)]
    L = len(codes)
    if L < k:
        return 0
    jc = B2C[np.frombuffer(JUNCTION, dtype=np.uint8)]
    wins = np.lib.stride_tricks.sliding_window_view(codes, k)
    jwins = np.lib.stride_tricks.sliding_window_view(jc, k)
    # [L-k+1, nj] mismatch counts for every read window vs junction kmer
    mm = (wins[:, None, :] != jwins[None, :, :]).sum(2)
    hit = (mm <= hdist).any(1)
    masked = 0
    for i in np.nonzero(hit)[0]:
        for j in range(i, i + k):
            if seq[j] != symbol:
                seq[j] = symbol
                masked += 1
    return masked


class _Rec:
    __slots__ = ("name", "seq", "qual")

    def __init__(self, name, seq, qual):
        self.name, self.seq, self.qual = name, seq, qual

    def sub(self, a, b):
        return _Rec(self.name, self.seq[a:b], self.qual[a:b] if self.qual else b"")


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1, in2 = a.get("in", "in1"), a.get("in2")
    out = a.get("out", "out1")
    out2 = a.get("out2")
    outf = a.get("outf")
    outu = a.get("outu")
    outs = a.get("outs")
    mask = a.get_bool("mask", default=False)
    symbol = ord((a.get("junction", default="J") or "J")[0])
    inner = a.get_bool("innerlmp", default=False)
    minlen = a.get_int("minlength", "ml", default=40)
    rename = a.get_bool("rename", default=True)

    def opener(p):
        return open_output(p) if p else None

    fh_lmp = opener(out)
    fh_lmp2 = opener(out2)
    fh_f = opener(outf)
    fh_u = opener(outu)
    fh_s = opener(outs)
    counts = {"lmp": 0, "frag": 0, "unknown": 0, "single": 0}

    def emit(fh, rec):
        if fh:
            fh.write(b"@%s\n%s\n+\n%s\n" % (
                rec.name, bytes(rec.seq),
                rec.qual if rec.qual else b"I" * len(rec.seq),
            ))

    def emit_pair(kind, ra, rb):
        counts[kind] += 1
        if kind == "lmp" and fh_lmp2 is not None:
            emit(fh_lmp, ra)
            emit(fh_lmp2, rb)
        else:
            fh = {"lmp": fh_lmp, "frag": fh_f, "unknown": fh_u}[kind]
            emit(fh, ra)
            emit(fh, rb)

    def junction_span(rec):
        s = bytes(rec.seq)
        i = s.find(symbol)
        if i < 0:
            return None
        return i, s.rfind(symbol)

    def split_read(rec, span):
        start, stop = span
        left = rec.sub(0, start) if start >= minlen else None
        right = (
            rec.sub(stop + 1, len(rec.seq))
            if len(rec.seq) - stop - 1 >= minlen else None
        )
        return left, right

    for b1, b2 in paired_reader(in1, in2):
        for i in range(b1.n):
            r1 = _Rec(b1.ids[i], bytearray(b1.sequence(i)), b1.quality_string(i))
            r2 = None
            if b2 is not None and i < b2.n:
                r2 = _Rec(b2.ids[i], bytearray(b2.sequence(i)), b2.quality_string(i))
            if mask:
                mask_junction(r1.seq, symbol=symbol)
                if r2 is not None:
                    mask_junction(r2.seq, symbol=symbol)
            sp1 = junction_span(r1)
            if r2 is None:
                if sp1 is None:
                    counts["single"] += 1
                    emit(fh_s, r1)
                    continue
                left, right = split_read(r1, sp1)
                if left is not None and right is not None:
                    if rename:
                        right.name = right.name.replace(b" /1", b" /2").replace(b" 1:", b" 2:")
                    emit_pair("lmp", left, right)
                elif left is not None or right is not None:
                    counts["single"] += 1
                    emit(fh_s, left if left is not None else right)
                continue
            sp2 = junction_span(r2)
            if sp1 is None and sp2 is None:
                emit_pair("unknown", r1, r2)
                continue
            r1l, r1r = split_read(r1, sp1) if sp1 else (r1, None)
            if sp2:
                # note: r2's sides are swapped (SplitNexteraLMP.java:466-470)
                l2, rr2 = split_read(r2, sp2)
                r2l, r2r = rr2, l2
            else:
                r2l, r2r = None, r2
            if r1l is not None and r2r is not None:
                emit_pair("lmp", r1l, r2r)
                r1l = r2r = None
            if r1r is not None and r2l is not None and inner:
                emit_pair("lmp", r1r, r2l)
                r1r = r2l = None
            if r1l is not None and r2l is not None:
                emit_pair("frag", r1l, r2l)
                r1l = r2l = None
            if r1r is not None and r2r is not None:
                emit_pair("frag", r1r, r2r)
                r1r = r2r = None
            for leftover in (r1l, r1r, r2l, r2r):
                if leftover is not None:
                    counts["single"] += 1
                    emit(fh_s, leftover)
    for fh in (fh_lmp, fh_lmp2, fh_f, fh_u, fh_s):
        if fh:
            fh.close()
    print(
        f"LMP pairs: {counts['lmp']}  Frag pairs: {counts['frag']}  "
        f"Unknown: {counts['unknown']}  Singletons: {counts['single']}",
        file=sys.stderr,
    )
    return counts


if __name__ == "__main__":
    main()
