"""FilterByTile — drop reads from low-quality flowcell regions.

Reference: hiseq/AnalyzeFlowCell.java + MicroTile.java + TileDump.java
(filterbytile.sh). Two passes:
  1. bin reads into micro-tiles — (lane, tile, x/500, y/500) grid cells
     (Tile.java:158 xSize=ySize=500) — accumulating read counts and
     probability-averaged quality;
  2. mark a micro-tile bad when its quality deficit dq = flowcellAvg -
     tileAvg satisfies dq > qDeviations*std AND dq > avg*qualFraction AND
     dq > qualAbs (TileDump.markTiles :803, defaults 2.4/0.08/2.0), then
     discard (or quality-mark) its reads.

Headers are Illumina-colon format: the 5th/6th/7th `:` fields of the
first whitespace token are tile, x, y (IlluminaHeaderParser).

The accumulation is vectorized per batch: header coordinates parse into
int arrays once, micro-tile keys sort into a contiguous id space, and
np.add.at scatters count/quality sums.

Paired input (in2=, out2=), which the JAX package's module reads only as
in=: the micro-tiles are measured over the interleaved stream (r1, r2,
r1, r2, ...) and a pair is kept only when both mates' micro-tiles are,
as the JAX package's filterbytile does on an interleaved file whose mates
carry one header's coordinates; outb= gets the discarded pairs
interleaved.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..core.parser import tokenize
from ..core.qualtools import PROB_ERROR
from ..io.fastq import FastqReader, FastqWriter, deinterleave, interleave

X_SIZE = 500
Y_SIZE = 500
Q_DEVIATIONS = 2.4
QUAL_FRACTION = 0.08
QUAAL_ABS = 2.0


def parse_coords(ids: list[bytes]):
    """(tile, x, y) int arrays from Illumina headers; -1 when unparsable."""
    n = len(ids)
    tile = np.full(n, -1, np.int64)
    x = np.full(n, -1, np.int64)
    y = np.full(n, -1, np.int64)
    for i, rid in enumerate(ids):
        tok = rid.split(b" ")[0].split(b"/")[0]
        parts = tok.split(b":")
        if len(parts) >= 7:
            try:
                tile[i] = int(parts[4])
                x[i] = int(parts[5])
                y[i] = int(parts[6])
            except ValueError:
                pass
    return tile, x, y


def avg_quality_by_prob(quals: np.ndarray, lengths: np.ndarray):
    """Read quality as -10log10(mean error prob) (Read.java
    avgQualityByProbabilityDouble)."""
    L = quals.shape[1]
    valid = np.arange(L)[None, :] < lengths[:, None]
    pe = np.where(valid, PROB_ERROR[np.clip(quals, 0, 127)], 0.0)
    mean_pe = pe.sum(axis=1) / np.maximum(lengths, 1)
    mean_pe = np.clip(mean_pe, 1e-10, 1.0)
    return -10.0 * np.log10(mean_pe)


def error_free_pct(quals: np.ndarray, lengths: np.ndarray):
    """Percent probability the read is error-free: 100*prod(1-P_err)
    (MicroTile errorFreeProb metric)."""
    L = quals.shape[1]
    valid = np.arange(L)[None, :] < lengths[:, None]
    pe = np.where(valid, PROB_ERROR[np.clip(quals, 0, 127)], 0.0)
    with np.errstate(divide="ignore"):
        logp = np.where(valid, np.log1p(-np.clip(pe, 0.0, 0.999999)), 0.0)
    return 100.0 * np.exp(logp.sum(axis=1))


def polyg_flags(bases: np.ndarray, lengths: np.ndarray, tail: int = 20,
                frac: float = 0.9):
    """Reads whose 3' tail is >= frac G (the NovaSeq dark-cycle
    artifact the pg* gates target)."""
    n, L = bases.shape
    out = np.zeros(n, dtype=bool)
    for i in range(n):
        ln = int(lengths[i])
        t = min(tail, ln)
        if t >= 10:
            out[i] = float((bases[i, ln - t : ln] == 2).mean()) >= frac
    return out


@dataclass
class FBTConfig:
    in1: str = ""
    in2: str | None = None  # mate file: pairs judged and kept together
    out: str = ""
    out2: str | None = None
    outb: str | None = None  # discarded reads
    # per-metric (deviations, fraction, absolute) gates; a micro-tile is
    # discarded when ALL THREE trip for AT LEAST ONE metric
    q_deviations: float = Q_DEVIATIONS
    qual_fraction: float = QUAL_FRACTION
    qual_abs: float = QUAAL_ABS
    u_deviations: float = 1.5
    u_fraction: float = 0.01
    u_abs: float = 1.0
    e_deviations: float = 3.0
    e_fraction: float = 0.2
    e_abs: float = 6.0
    pg_deviations: float = 1.4
    pg_fraction: float = 0.2
    pg_abs: float = 0.2
    mdf: float = 0.4  # max fraction of tiles discarded
    k_uniq: int = 25  # leading-kmer length for the uniqueness metric
    xsize: int = X_SIZE
    ysize: int = Y_SIZE


def parse_args(argv) -> FBTConfig:
    a = tokenize(argv)
    c = FBTConfig()
    c.in1 = a.get("in", "in1", default="")
    c.in2 = a.get("in2")
    c.out = a.get("out", "out1", default="")
    c.out2 = a.get("out2")
    c.outb = a.get("outb", "outbad")
    c.q_deviations = a.get_float("qd", "qdeviations", default=Q_DEVIATIONS)
    c.qual_fraction = a.get_float("qf", "qfraction", default=QUAL_FRACTION)
    c.qual_abs = a.get_float("qa", "qabsolute", "qabs", default=QUAAL_ABS)
    c.u_deviations = a.get_float("ud", "udeviations", default=1.5)
    c.u_fraction = a.get_float("uf", "ufraction", default=0.01)
    c.u_abs = a.get_float("ua", "uabsolute", default=1.0)
    c.e_deviations = a.get_float("ed", "edeviations", default=3.0)
    c.e_fraction = a.get_float("ef", "efraction", default=0.2)
    c.e_abs = a.get_float("ea", "eabsolute", default=6.0)
    c.pg_deviations = a.get_float("pgd", "pgdeviations", default=1.4)
    c.pg_fraction = a.get_float("pgf", "pgfraction", default=0.2)
    c.pg_abs = a.get_float("pga", "pgabsolute", default=0.2)
    c.mdf = a.get_float("mdf", "maxdiscardfraction", default=0.4)
    c.xsize = a.get_int("xsize", default=X_SIZE)
    c.ysize = a.get_int("ysize", default=Y_SIZE)
    return c


class FilterByTile:
    def __init__(self, cfg: FBTConfig):
        self.cfg = cfg
        self.bad_keys: set[tuple] = set()
        self.reads_discarded = 0
        self.reads_kept = 0

    def _keys(self, b):
        tile, x, y = parse_coords(b.ids)
        return list(
            zip(tile.tolist(), (x // self.cfg.xsize).tolist(),
                (y // self.cfg.ysize).tolist())
        )

    def _records(self):
        """The input's batches; paired input as the interleaved stream."""
        if not self.cfg.in2:
            yield from FastqReader(self.cfg.in1)
            return
        for b1, b2 in zip(FastqReader(self.cfg.in1), FastqReader(self.cfg.in2)):
            yield interleave(b1, b2)

    def analyze(self):
        cfg = self.cfg
        counts: dict[tuple, int] = {}
        qsums: dict[tuple, float] = {}
        esums: dict[tuple, float] = {}     # error-free probability %
        uniq: dict[tuple, int] = {}        # first-time leading kmers
        polyg: dict[tuple, int] = {}       # poly-G tail reads
        seen_kmers: set[int] = set()
        k = cfg.k_uniq
        for b in self._records():
            if b.quals is None:
                continue
            qual = avg_quality_by_prob(b.quals, b.lengths.astype(np.int64))
            efree = error_free_pct(b.quals, b.lengths.astype(np.int64))
            pg = polyg_flags(b.bases, b.lengths)
            batch_keys = self._keys(b)
            for i, (key, q) in enumerate(zip(batch_keys, qual)):
                if key[0] < 0:
                    continue
                counts[key] = counts.get(key, 0) + 1
                qsums[key] = qsums.get(key, 0.0) + float(q)
                esums[key] = esums.get(key, 0.0) + float(efree[i])
                if pg[i]:
                    polyg[key] = polyg.get(key, 0) + 1
                # uniqueness: is the read's leading kmer new?
                L = int(b.lengths[i])
                if L >= k:
                    w = b.bases[i, :k]
                    if not (w >= 4).any():
                        v = 0
                        for c in w:
                            v = (v << 2) | int(c)
                        if v not in seen_kmers:
                            seen_kmers.add(v)
                            uniq[key] = uniq.get(key, 0) + 1
        if not counts:
            return
        keys = list(counts)
        n = np.array([counts[k_] for k_ in keys], np.float64)
        metrics = {
            # name -> (per-tile value, bad-direction sign, (dev, frac, abs))
            "quality": (
                np.array([qsums[k_] for k_ in keys]) / n, -1,
                (cfg.q_deviations, cfg.qual_fraction, cfg.qual_abs),
            ),
            "errorfree": (
                np.array([esums[k_] for k_ in keys]) / n, -1,
                (cfg.e_deviations, cfg.e_fraction, cfg.e_abs),
            ),
            "uniqueness": (
                100.0 * np.array([uniq.get(k_, 0) for k_ in keys]) / n, +1,
                (cfg.u_deviations, cfg.u_fraction, cfg.u_abs),
            ),
            "polyg": (
                np.array([polyg.get(k_, 0) for k_ in keys]) / n, +1,
                (cfg.pg_deviations, cfg.pg_fraction, cfg.pg_abs),
            ),
        }
        uniq_counts = np.array([uniq.get(k_, 0) for k_ in keys])
        polyg_counts = np.array([polyg.get(k_, 0) for k_ in keys])
        bad = np.zeros(len(keys), dtype=bool)
        worst = np.zeros(len(keys), dtype=np.float64)
        self.tile_stats = {}
        for name, (vals, sign, (dev, frac, absv)) in metrics.items():
            mean = float((vals * n).sum() / n.sum())
            std = float(np.sqrt(((vals - mean) ** 2 * n).sum() / n.sum()))
            delta = (vals - mean) * sign  # positive = toward-bad
            trip = (
                (delta > dev * std)
                & (delta > abs(mean) * frac)
                & (delta > absv)
            )
            # count-based metrics: a single event is never significant
            if name == "uniqueness":
                trip &= uniq_counts >= 2
            elif name == "polyg":
                trip &= polyg_counts >= 2
            bad |= trip
            if std > 0:
                worst = np.maximum(worst, delta / std)
            self.tile_stats[name] = (mean, std)
            if name == "quality":
                self.flowcell_avg = mean
                self.flowcell_std = std
        # mdf cap: never discard more than mdf of the micro-tiles
        max_bad = int(cfg.mdf * len(keys))
        if bad.sum() > max_bad:
            order = np.argsort(-worst)
            keep_bad = set(order[:max_bad].tolist())
            bad = np.array(
                [m and i in keep_bad for i, m in enumerate(bad)], bool
            )
        self.bad_keys = {k_ for k_, m in zip(keys, bad) if m}

    def filter(self):
        cfg = self.cfg
        w = FastqWriter(cfg.out) if cfg.out else None
        wb = FastqWriter(cfg.outb) if cfg.outb else None
        w2 = FastqWriter(cfg.out2) if cfg.in2 and cfg.out2 else None
        for b in self._records():
            keep = np.array(
                [k not in self.bad_keys for k in self._keys(b)], bool
            )
            if cfg.in2:
                keep[0::2] = keep[1::2] = keep[0::2] & keep[1::2]
            self.reads_kept += int(keep.sum())
            self.reads_discarded += int((~keep).sum())
            if w and cfg.in2:
                b1, b2 = deinterleave(b)
                w.add(b1, keep[0::2])
                if w2:
                    w2.add(b2, keep[1::2])
            elif w:
                w.add(b, keep)
            if wb:
                wb.add(b, ~keep)
        for x in (w, w2, wb):
            if x:
                x.close()

    def run(self):
        self.analyze()
        self.filter()
        print(
            f"Flagged micro-tiles: \t{len(self.bad_keys)}",
            file=sys.stderr,
        )
        print(f"Reads discarded:     \t{self.reads_discarded}", file=sys.stderr)
        print(f"Reads kept:          \t{self.reads_kept}", file=sys.stderr)
        return self


def main(argv=None):
    return FilterByTile(parse_args(argv if argv is not None else sys.argv[1:])).run()
