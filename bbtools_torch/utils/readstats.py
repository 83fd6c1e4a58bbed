"""ReadStats — the histogram hub (tracker/ReadStats.java:29).

Accumulates per-batch statistics (vectorized numpy, no per-read Python)
and writes the reference's histogram file formats:
  qhist  — per-position avg quality, linear + logarithmic
           ("#BaseNum\\tRead1_linear\\tRead1_log", writeQualityToFile :1161)
  aqhist — average-read-quality histogram ("#Quality\\tcount1\\tfraction1",
           writeAverageQualityToFile :1062)
  lhist  — length histogram ("#Length\\tCount", :1289)
  gchist — GC fraction histogram with #Mean/#Median/#Mode/#STDev header
           (writeGCToFile :1301)
  bhist  — per-position base composition ("#Pos\\tA\\tC\\tG\\tT\\tN",
           writeBhistToFile)
"""

from __future__ import annotations

import numpy as np

from ..core.qualtools import PROB_ERROR

MAXLEN = 1024
GC_BINS = 100


class ReadStats:
    def __init__(self):
        self.qual_sum = [np.zeros(MAXLEN, np.int64), np.zeros(MAXLEN, np.int64)]
        self.qual_sum_prob = [np.zeros(MAXLEN, np.float64), np.zeros(MAXLEN, np.float64)]
        self.qual_len = [np.zeros(MAXLEN, np.int64), np.zeros(MAXLEN, np.int64)]
        self.length_hist = np.zeros(80000, np.int64)
        self.gc_hist = np.zeros(GC_BINS + 1, np.int64)
        self.aq_hist = [np.zeros(128, np.int64), np.zeros(128, np.int64)]
        self.base_hist = np.zeros((MAXLEN, 5), np.int64)

    def add_batch(self, batch, pairnum: int = 0):
        bases = batch.bases
        lengths = batch.lengths.astype(np.int64)
        B, L = bases.shape
        Lc = min(L, MAXLEN)
        valid = np.arange(Lc)[None, :] < lengths[:, None]
        if batch.quals is not None:
            q = batch.quals[:, :Lc].astype(np.int64)
            self.qual_sum[pairnum][:Lc] += np.where(valid, q, 0).sum(axis=0)
            self.qual_sum_prob[pairnum][:Lc] += np.where(
                valid, PROB_ERROR[np.minimum(q, 127)], 0
            ).sum(axis=0)
            self.qual_len[pairnum][:Lc] += valid.sum(axis=0)
            # average read quality (probability-based, Read.avgQuality)
            pe_sum = np.where(valid, PROB_ERROR[np.minimum(q, 127)], 0).sum(axis=1)
            p = pe_sum / np.maximum(lengths, 1)
            with np.errstate(divide="ignore"):
                avgq = np.where(
                    p >= 1, 0, np.where(p <= 1e-6, 60, -10 * np.log10(np.maximum(p, 1e-300)))
                )
            np.add.at(
                self.aq_hist[pairnum],
                np.clip(avgq.astype(np.int64), 0, 127),
                1,
            )
        np.add.at(self.length_hist, np.clip(lengths, 0, len(self.length_hist) - 1), 1)
        gc = ((bases == 1) | (bases == 2))[:, :Lc]
        gc_count = np.where(valid, gc, False).sum(axis=1)
        at_count = np.where(valid, ((bases == 0) | (bases == 3))[:, :Lc], False).sum(axis=1)
        denom = np.maximum(gc_count + at_count, 1)
        frac = gc_count / denom
        np.add.at(self.gc_hist, np.minimum((frac * GC_BINS).round().astype(np.int64), GC_BINS), 1)
        for code in range(5):
            sel = np.where(valid, bases[:, :Lc] == code, False)
            self.base_hist[:Lc, code] += sel.sum(axis=0)

    # ------------------------------------------------------------------
    def write_qhist(self, path: str, paired: bool = False):
        ql1 = self.qual_len[0].copy()
        ql2 = self.qual_len[1].copy()
        for i in range(MAXLEN - 2, -1, -1):
            ql1[i] += ql1[i + 1]
            ql2[i] += ql2[i + 1]
        with open(path, "w") as fh:
            if paired:
                fh.write("#BaseNum\tRead1_linear\tRead1_log\tRead2_linear\tRead2_log\n")
            else:
                fh.write("#BaseNum\tRead1_linear\tRead1_log\n")
            for i in range(MAXLEN):
                if ql1[i] <= 0 and (not paired or ql2[i] <= 0):
                    break
                div1 = max(1, ql1[i])
                blin = self.qual_sum[0][i] / div1
                blog = _prob_to_phred(self.qual_sum_prob[0][i] / div1)
                if paired:
                    div2 = max(1, ql2[i])
                    clin = self.qual_sum[1][i] / div2
                    clog = _prob_to_phred(self.qual_sum_prob[1][i] / div2)
                    fh.write(f"{i + 1}\t{blin:.3f}\t{blog:.3f}\t{clin:.3f}\t{clog:.3f}\n")
                else:
                    fh.write(f"{i + 1}\t{blin:.3f}\t{blog:.3f}\n")

    def write_lhist(self, path: str):
        with open(path, "w") as fh:
            fh.write("#Length\tCount\n")
            nz = np.flatnonzero(self.length_hist)
            for i in nz:
                fh.write(f"{i}\t{self.length_hist[i]}\n")

    def write_aqhist(self, path: str, paired: bool = False):
        h1 = self.aq_hist[0]
        h2 = self.aq_hist[1]
        t1 = max(1, h1.sum())
        t2 = max(1, h2.sum())
        hi = max(
            np.flatnonzero(h1).max(initial=0), np.flatnonzero(h2).max(initial=0)
        )
        with open(path, "w") as fh:
            fh.write(
                "#Quality\tcount1\tfraction1"
                + ("\tcount2\tfraction2" if paired else "")
                + "\n"
            )
            for i in range(hi + 1):
                row = f"{i}\t{h1[i]}\t{h1[i] / t1:.5f}"
                if paired:
                    row += f"\t{h2[i]}\t{h2[i] / t2:.5f}"
                fh.write(row + "\n")

    def write_gchist(self, path: str):
        h = self.gc_hist
        total = max(1, h.sum())
        mult = 100.0 / max(1, len(h) - 1)
        idx = np.arange(len(h))
        mean = float((h * idx).sum() / total) * mult
        cum = np.cumsum(h)
        median = float(np.searchsorted(cum, total / 2)) * mult
        mode = float(np.argmax(h)) * mult
        var = float((h * (idx - mean / mult) ** 2).sum() / total)
        stdev = var ** 0.5 * mult
        with open(path, "w") as fh:
            fh.write(f"#Mean\t{mean:.3f}\n")
            fh.write(f"#Median\t{median:.3f}\n")
            fh.write(f"#Mode\t{mode:.3f}\n")
            fh.write(f"#STDev\t{stdev:.3f}\n")
            fh.write("#GC\tCount\n")
            for i in range(len(h)):
                if h[i] > 0:
                    fh.write(f"{i * mult:.1f}\t{h[i]}\n")

    def write_bhist(self, path: str):
        with open(path, "w") as fh:
            fh.write("#Pos\tA\tC\tG\tT\tN\n")
            for i in range(MAXLEN):
                row = self.base_hist[i]
                tot = row.sum()
                if tot == 0:
                    break
                fh.write(
                    f"{i}\t"
                    + "\t".join(f"{row[j] / tot:.5f}" for j in range(5))
                    + "\n"
                )


def _prob_to_phred(p: float) -> float:
    if p >= 1:
        return 0.0
    if p <= 0.000001:
        return 60.0
    import math

    return -10 * math.log10(p)
