"""FixScaffoldGaps — resize scaffold N-gaps using paired-read insert
evidence (fixgaps.sh, consensus/FixScaffoldGaps.java:600-700).

Reference algorithm, reproduced:
  - every primary leftmost same-scaffold pair adds +1 depth and
    +insertSize (tlen) over [start+trim, start+tlen-trim), where
    trim = border*readlen (border=0.4);
  - all pair inserts feed a global histogram -> per-percentile insert
    lookup (buckets=1000);
  - at each N-streak >= gap (with >=300 bp of scaffold on both sides):
    pivot = gap middle; avgInsert = insertSum/depth at pivot;
    avgDepth = mean of depth 200 bp outside the gap on each side;
    percentile = buckets * max(0.5, 1 - depth/(avgDepth+depth));
    dif = insertByPercentile[percentile] - avgInsert;
    newGap = max(gap, streak + dif). Spanning pairs self-select for
    long inserts, hence the depth-ratio percentile proxy instead of the
    plain mean.
  - gaps with spanning depth < mindepth are left unchanged.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.parser import tokenize
from ..io.fasta import FastaRecord, read_fasta, write_fasta
from ..io.readwrite import open_input

BUCKETS = 1000


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    sam = a.get("in", "in1")
    ref_path = a.get("ref")
    out1 = a.get("out", "out1")
    min_gap = a.get_int("gap", "ns", "scaffoldbreak", default=10)
    border = a.get_float("border", default=0.4)
    mindepth = a.get_int("mindepth", default=10)

    scaffolds = read_fasta(ref_path)
    index = {r.name.split()[0]: i for i, r in enumerate(scaffolds)}
    # difference arrays -> cumsum gives per-base depth / insert sums
    depth_d = [np.zeros(len(r.seq) + 1, dtype=np.int64) for r in scaffolds]
    insert_d = [np.zeros(len(r.seq) + 1, dtype=np.int64) for r in scaffolds]
    inserts: list[int] = []

    with open_input(sam) as fh:
        for line in fh:
            if line.startswith(b"@"):
                continue
            f = line.rstrip(b"\n").split(b"\t")
            if len(f) < 11:
                continue
            flag = int(f[1])
            # mapped, paired on same scaffold, primary, leftmost
            if flag & 0x4 or flag & 0x100 or flag & 0x800 or not flag & 0x1:
                continue
            if f[6] not in (b"=", f[2]):
                continue
            tlen = int(f[8])
            if tlen <= 0:
                continue
            si = index.get(f[2])
            if si is None:
                continue
            readlen = len(f[9])
            trim = int(readlen * border)
            start = int(f[3]) - 1 + trim
            stop = int(f[3]) - 1 + tlen - trim
            L = len(scaffolds[si].seq)
            s0, s1 = max(start, 0), min(max(stop, 0), L)
            if s1 <= s0:
                continue
            depth_d[si][s0] += 1
            depth_d[si][s1] -= 1
            insert_d[si][s0] += tlen
            insert_d[si][s1] -= tlen
            inserts.append(tlen)

    if inserts:
        arr = np.sort(np.asarray(inserts))
        insert_by_pct = np.quantile(
            arr, np.linspace(0, 1, BUCKETS + 1)
        ).astype(np.int64)
    else:
        insert_by_pct = np.zeros(BUCKETS + 1, dtype=np.int64)

    widened = narrowed = unchanged = 0
    ns_added = ns_removed = 0
    out_recs = []
    for si, rec in enumerate(scaffolds):
        depth = np.cumsum(depth_d[si][:-1])
        isum = np.cumsum(insert_d[si][:-1])
        seq = rec.seq
        upper = seq.upper()
        L = len(seq)
        pieces = []
        i = 0
        streak = 0
        gap_start = 0
        pos = 0
        for i in range(L + 1):
            is_n = i < L and upper[i : i + 1] == b"N"
            if is_n:
                if streak == 0:
                    gap_start = i
                streak += 1
                continue
            if streak:
                new_gap = streak
                if (
                    streak >= min_gap and gap_start > 300 and i < L - 300
                ):
                    pivot = i - streak // 2 - 1
                    d = int(depth[pivot])
                    if d >= mindepth:
                        avg_insert = isum[pivot] / d
                        left_p = max(i - 200 - streak, 0)
                        right_p = min(i + 200, L - 1)
                        avg_depth = (
                            int(depth[left_p]) + int(depth[right_p])
                        ) // 2
                        pct = int(
                            BUCKETS
                            * max(0.5, 1.0 - d / (avg_depth + d))
                        )
                        proxy = int(insert_by_pct[min(pct, BUCKETS)])
                        dif = int(round(proxy - avg_insert))
                        new_gap = max(min_gap, streak + dif)
                        if dif > 0:
                            widened += 1
                            ns_added += dif
                        elif dif < 0:
                            narrowed += 1
                            ns_removed -= dif
                        else:
                            unchanged += 1
                pieces.append(seq[pos:gap_start])
                pieces.append(b"N" * new_gap)
                pos = i
                streak = 0
        pieces.append(seq[pos:L])
        out_recs.append(FastaRecord(rec.name, b"".join(pieces)))
    if out1:
        write_fasta(out1, out_recs)
    print(
        f"Gaps widened: {widened}  narrowed: {narrowed}  "
        f"unchanged: {unchanged}  Ns added: {ns_added}  removed: {ns_removed}",
        file=sys.stderr,
    )
    return out_recs


if __name__ == "__main__":
    main()
