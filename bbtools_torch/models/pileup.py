"""CoveragePileup — per-scaffold coverage stats from SAM
(jgi/CoveragePileup.java, pileup.sh).

Streams SAM once, accumulates per-base coverage arrays per scaffold, and
writes covstats (per-scaffold summary: Avg_fold, Length, Ref_GC,
Covered_percent, Covered_bases, Plus/Minus_reads — jgi/CovStatsLine
column set), plus optional basecov (per-base) and bincov (binned).
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.parser import tokenize
from ..io.fasta import load_reference
from ..io.readwrite import open_output
from ..io.sam_read import iter_sam, parse_cigar


def bases_under_window(cov: np.ndarray, avg: float, window: int) -> int:
    """Bases belonging to any length-`window` sliding window whose summed
    coverage is below ceil(window*avg) (CoveragePileup.java
    basesUnderAverageCoverage :1566; computed here as the union of
    below-limit windows via a vectorized rolling sum).
    """
    n = len(cov)
    if n < window:
        return 0
    limit = int(np.ceil(window * avg))
    sums = np.convolve(cov, np.ones(window, dtype=np.int64), "valid")
    below = sums < limit  # window starting at each position
    if not below.any():
        return 0
    # union of [start, start+window) intervals for every below window
    covered = np.zeros(n + 1, dtype=np.int32)
    starts = np.flatnonzero(below)
    covered[starts] += 1
    covered[starts + window] -= 1
    return int((np.cumsum(covered[:-1]) > 0).sum())


def write_covstats(out, ref, cov, plus_reads, minus_reads,
                   covwindow: int = 0, covwindowavg: float = 5.0):
    """covstats= table (jgi/CovStatsLine format), shared by the
    standalone pileup tool and BBMap's inline coverage outputs
    (align2/AbstractMapper printOutput -> CoveragePileup)."""
    with open_output(out) as fh:
        hdr = (
            b"#ID\tAvg_fold\tLength\tRef_GC\tCovered_percent\t"
            b"Covered_bases\tPlus_reads\tMinus_reads"
        )
        if covwindow > 0:
            hdr += b"\tUnder_%.0f/%d" % (covwindowavg, covwindow)
        fh.write(hdr + b"\n")
        for i, name in enumerate(ref.names):
            c = cov[i]
            codes = ref.scaffold_codes(i)
            gc = float(((codes == 1) | (codes == 2)).sum()) / max(
                len(codes), 1
            )
            covered = int((c > 0).sum())
            avg = float(c.sum()) / max(len(c), 1)
            row = b"%s\t%.4f\t%d\t%.4f\t%.4f\t%d\t%d\t%d" % (
                name.split()[0], avg, len(c), gc,
                100.0 * covered / max(len(c), 1), covered,
                plus_reads[i], minus_reads[i],
            )
            if covwindow > 0:
                row += b"\t%d" % bases_under_window(
                    c, covwindowavg, covwindow
                )
            fh.write(row + b"\n")


def write_basecov(path, ref, cov):
    with open_output(path) as fh:
        fh.write(b"#RefName\tPos\tCoverage\n")
        for i, name in enumerate(ref.names):
            nm = name.split()[0]
            for p, c in enumerate(cov[i]):
                fh.write(b"%s\t%d\t%d\n" % (nm, p, c))


def write_bincov(path, ref, cov, binsize: int = 1000):
    with open_output(path) as fh:
        fh.write(b"#RefName\tCov\tPos\tRunningPos\n")
        running = 0
        for i, name in enumerate(ref.names):
            c = cov[i]
            nm = name.split()[0]
            for p0 in range(0, len(c), binsize):
                seg = c[p0 : p0 + binsize]
                fh.write(
                    b"%s\t%.2f\t%d\t%d\n"
                    % (nm, float(seg.mean()), p0, running + p0)
                )
            running += len(c)


def write_covhist(path, cov, hist_max: int = 100000):
    """covhist= (#Coverage\\tnumBases rows, CoveragePileup histogram)."""
    h = np.zeros(hist_max + 1, dtype=np.int64)
    for c in cov:
        np.add.at(h, np.minimum(c, hist_max), 1)
    with open_output(path) as fh:
        fh.write(b"#Coverage\tnumBases\n")
        top = int(np.flatnonzero(h)[-1]) if h.any() else 0
        for depth in range(0, top + 1):
            fh.write(b"%d\t%d\n" % (depth, h[depth]))


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    sam = a.get("in", "in1")
    ref_path = a.get("ref")
    out = a.get("out", "covstats", "stats")
    basecov = a.get("basecov")
    bincov = a.get("bincov")
    covhist = a.get("covhist", "hist")
    binsize = a.get_int("binsize", default=1000)
    # low-coverage sliding window (CoveragePileup.java LOW_COV_WINDOW /
    # LOW_COV_DEPTH, covwindow=/covwindowavg= flags :249-256): adds an
    # "Under_<depth>/<window>" covstats column counting bases inside
    # windows whose mean coverage is below the threshold.
    covwindow = a.get_int("covwindow", "window", default=0)
    covwindowavg = a.get_float(
        "covwindowavg", "windowcov", "lowcovdepth", default=5.0
    )
    # covered-range report consumed by trimcontigs
    # (CoveragePileup.java writeCoverageRanges :1927)
    rangecov = a.get("ranges", "rangecov")
    mindepthcovered = a.get_int("mindepthcovered", default=1)
    ref = load_reference(ref_path)
    name_to_idx = {n.split()[0]: i for i, n in enumerate(ref.names)}
    cov = [np.zeros(int(l), dtype=np.int32) for l in ref.lengths]
    plus_reads = np.zeros(ref.n_scaffolds, dtype=np.int64)
    minus_reads = np.zeros(ref.n_scaffolds, dtype=np.int64)
    reads = 0
    for rec in iter_sam(sam):
        if not rec.mapped or rec.secondary:
            continue
        i = name_to_idx.get(rec.rname)
        if i is None:
            continue
        reads += 1
        span = sum(n for n, op in parse_cigar(rec.cigar) if op in "=XMDN")
        a0 = rec.pos - 1
        b0 = min(a0 + span, len(cov[i]))
        cov[i][max(a0, 0) : b0] += 1
        if rec.strand:
            minus_reads[i] += 1
        else:
            plus_reads[i] += 1
    if out:
        write_covstats(out, ref, cov, plus_reads, minus_reads,
                       covwindow, covwindowavg)
    if rangecov:
        # per scaffold: "#name" then "start-end\tavgDepth" rows for each
        # maximal run with coverage >= mindepthcovered (0-based inclusive)
        with open_output(rangecov) as fh:
            for i, name in enumerate(ref.names):
                fh.write(b"#" + name + b"\n")
                c = cov[i]
                covered = c >= mindepthcovered
                if not covered.any():
                    continue
                edges = np.diff(covered.astype(np.int8))
                starts = list(np.flatnonzero(edges == 1) + 1)
                ends = list(np.flatnonzero(edges == -1) + 1)
                if covered[0]:
                    starts.insert(0, 0)
                if covered[-1]:
                    ends.append(len(c))
                for s, e in zip(starts, ends):
                    seg = c[s:e]
                    fh.write(
                        b"%d-%d\t%.2f\n" % (s, e - 1, float(seg.mean()))
                    )
    if basecov:
        write_basecov(basecov, ref, cov)
    if bincov:
        write_bincov(bincov, ref, cov, binsize)
    if covhist:
        write_covhist(covhist, cov)
    print(f"Reads:               \t{reads}", file=sys.stderr)
    total_cov = sum(int(c.sum()) for c in cov)
    total_len = sum(len(c) for c in cov)
    print(f"Average coverage:    \t{total_cov/max(total_len,1):.3f}", file=sys.stderr)
    return cov


if __name__ == "__main__":
    main()
