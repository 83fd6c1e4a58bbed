"""CRISPR repeat-spacer array finder — bbcrisprfinder.sh.

Reference: jgi/CrisprFinder.java (3.5k LoC). Core detection loop
(:925-1000): per read, k-mers (kRepeat=13) that recur with period in
[minRepeat+minSpacer, maxRepeat+maxSpacer] seed a repeat pair; the pair
is extended outward to the maximal exact match; the repeat length must
land in [minRepeat=22, maxRepeat=56] and the spacer (period - repeat)
in [minSpacer=14, maxSpacer=60]; arrays with < minrepeats=2 repeat
copies are culled (cullLowCountRepeats :1698). Outputs: annotated
arrays (outc=), reads containing arrays (out=) vs not (outu=), masked
reads (masked=), repeat consensus fasta (consensus=), repeat-length
histogram (chist=).

This implementation vectorizes the seed scan (one rolling-kmer pass +
sorted position grouping per read) and keeps the reference's defaults
and extension rule (exact-match extension; rqhdist>0 mismatch shrink is
not implemented — detection is exact-repeat).
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.parser import parse_boolean, tokenize
from ..ops.kmers import rolling_kmers_np


class Crispr:
    __slots__ = ("a_start", "a_stop", "b_start", "b_stop", "period",
                 "copies")

    def __init__(self, a_start, a_stop, b_start, b_stop):
        self.a_start, self.a_stop = a_start, a_stop
        self.b_start, self.b_stop = b_start, b_stop
        self.period = b_stop - a_stop
        self.copies = 2


def find_crisprs(codes: np.ndarray, k: int = 13, min_spacer: int = 14,
                 max_spacer: int = 60, min_repeat: int = 22,
                 max_repeat: int = 56, min_repeats: int = 2):
    """Detect repeat-spacer arrays in one read; returns [Crispr]."""
    n = len(codes)
    if n < 2 * min_repeat + min_spacer:
        return []
    fwd, _, runlen = rolling_kmers_np(codes[None, :], k)
    fwd, runlen = fwd[0], runlen[0]
    ok = runlen >= k
    min_period = min_repeat + min_spacer
    max_period = max_repeat + max_spacer
    # group positions by kmer
    order = np.argsort(fwd[ok], kind="stable")
    pos_all = np.nonzero(ok)[0][order]
    km_sorted = fwd[ok][order]
    found: list[Crispr] = []
    claimed = np.zeros(n, bool)
    starts = np.nonzero(np.diff(km_sorted, prepend=km_sorted[0] - 1))[0] \
        if len(km_sorted) else np.zeros(0, int)
    bounds = list(starts) + [len(km_sorted)]
    for gi in range(len(bounds) - 1):
        grp = pos_all[bounds[gi]: bounds[gi + 1]]
        if len(grp) < 2:
            continue
        grp = np.sort(grp)
        for j in range(len(grp) - 1):
            a_stop, b_stop = int(grp[j]), int(grp[j + 1])
            period = b_stop - a_stop
            if not (min_period <= period <= max_period):
                continue
            if claimed[a_stop] or claimed[b_stop]:
                continue
            a_start, b_start = a_stop - k + 1, b_stop - k + 1
            # extend left
            while (a_start > 0 and b_start > 0
                   and codes[a_start - 1] == codes[b_start - 1]
                   and codes[a_start - 1] < 4):
                a_start -= 1
                b_start -= 1
            # extend right (a may not run into b's start)
            while (b_stop + 1 < n and a_stop + 1 < b_start
                   and codes[a_stop + 1] == codes[b_stop + 1]
                   and codes[a_stop + 1] < 4):
                a_stop += 1
                b_stop += 1
            rlen = a_stop - a_start + 1
            spacer = period - rlen
            if not (min_repeat <= rlen <= max_repeat):
                continue
            if not (min_spacer <= spacer <= max_spacer):
                continue
            c = Crispr(a_start, a_stop, b_start, b_stop)
            # count further copies at the same period
            rep = codes[a_start: a_stop + 1]
            nxt = b_start + period
            while nxt + rlen <= n:
                if (codes[nxt: nxt + rlen] == rep).all():
                    c.copies += 1
                    c.b_start, c.b_stop = nxt, nxt + rlen - 1
                    nxt += period
                else:
                    break
            prev = a_start - period
            while prev >= 0:
                if (codes[prev: prev + rlen] == rep).all():
                    c.copies += 1
                    c.a_start, c.a_stop = prev, prev + rlen - 1
                    prev -= period
                else:
                    break
            if c.copies >= min_repeats:
                claimed[c.a_start: c.b_stop + 1] = True
                found.append(c)
    return found


def main(args):
    a = tokenize(args)
    inpath = a.get("in", "in1")
    if not inpath:
        print("Usage: bbcrisprfinder in=<reads> [out=<with arrays>]"
              " [outu=<without>] [outc=<annotations>] [masked=]"
              " [consensus=] [chist=] [minrepeats=2] [minrepeat=22]"
              " [maxrepeat=56] [minspacer=14] [maxspacer=60] [kr=13]",
              file=sys.stderr)
        return 1
    k = int(a.get("krepeat", "kr", "k", default="13"))
    min_spacer = int(a.get("minspacer", default="14"))
    max_spacer = int(a.get("maxspacer", default="60"))
    min_repeat = int(a.get("minrepeat", default="22"))
    max_repeat = int(a.get("maxrepeat", default="56"))
    min_repeats = int(a.get("minrepeats", "repeats", default="2"))
    from ..core.dna import decode
    from ..io.fastq import FastqReader, FastqWriter

    out = a.get("out", "out1")
    outu = a.get("outu")
    outc = a.get("outc", "outcrispr")
    maskedp = a.get("masked")
    consensus_p = a.get("consensus")
    w = FastqWriter(out) if out else None
    wu = FastqWriter(outu) if outu else None
    wm = FastqWriter(maskedp) if maskedp else None
    ann = []
    rep_counts: dict[bytes, int] = {}
    lenhist = np.zeros(max_repeat + 2, np.int64)
    n_reads = n_with = n_arrays = 0
    for batch in FastqReader(inpath):
        has = np.zeros(batch.n, bool)
        masked = batch.bases.copy() if wm is not None else None
        for i in range(batch.n):
            L = int(batch.lengths[i])
            codes = batch.bases[i, :L]
            crisprs = find_crisprs(
                codes, k, min_spacer, max_spacer, min_repeat, max_repeat,
                min_repeats)
            if not crisprs:
                continue
            has[i] = True
            n_arrays += len(crisprs)
            name = batch.ids[i].split()[0].decode()
            for c in crisprs:
                rep = decode(codes[c.a_start: c.a_stop + 1])
                rlen = c.a_stop - c.a_start + 1
                lenhist[min(rlen, max_repeat + 1)] += 1
                rep_counts[rep] = rep_counts.get(rep, 0) + c.copies
                ann.append(
                    f"{name}\t{c.a_start}\t{c.b_stop + 1}\t{rlen}"
                    f"\t{c.period - rlen}\t{c.copies}\t{rep.decode()}")
                if masked is not None:
                    # mask every repeat copy (keep spacers)
                    p = c.a_start
                    while p <= c.b_start:
                        masked[i, p: p + rlen] = 4  # N
                        p += c.period
        n_reads += batch.n
        n_with += int(has.sum())
        if w is not None:
            w.add(batch, keep=has)
        if wu is not None:
            wu.add(batch, keep=~has)
        if wm is not None:
            orig = batch.bases
            batch.bases = masked
            wm.add(batch)
            batch.bases = orig
    for x in (w, wu, wm):
        if x is not None:
            x.close()
    if outc:
        with open(outc, "w") as fh:
            fh.write("#read\tstart\tstop\trepeatLen\tspacerLen\tcopies"
                     "\trepeat\n")
            fh.write("\n".join(ann) + ("\n" if ann else ""))
    if consensus_p:
        with open(consensus_p, "w") as fh:
            for ri, (rep, cnt) in enumerate(sorted(
                    rep_counts.items(), key=lambda t: -t[1])):
                fh.write(f">repeat_{ri} copies={cnt}\n{rep.decode()}\n")
    if a.get("chist", "crisprhist", "outcrisprhist"):
        with open(a.get("chist", "crisprhist", "outcrisprhist"), "w") as fh:
            fh.write("#repeatLen\tcount\n")
            for ln, c in enumerate(lenhist):
                if c:
                    fh.write(f"{ln}\t{int(c)}\n")
    print(f"Reads: {n_reads}\tWith arrays: {n_with}\t"
          f"Arrays: {n_arrays}\tDistinct repeats: {len(rep_counts)}",
          file=sys.stderr)
    return 0
