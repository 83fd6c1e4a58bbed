"""Illumina flowcell/plumbing tools (hiseq/ package long tail).

Reference mains:
  - tiledump.sh -> hiseq.TileDump: per-micro-tile metric table (reads,
    avg quality, error-free %, uniqueness, poly-G) from reads — the
    dump format AnalyzeFlowCell writes/loads.
  - plotflowcell.sh -> hiseq.PlotFlowCell: per-tile quality map of the
    flowcell (same metrics, organized as an x/y grid per lane/tile).
  - plothist.sh -> hiseq.PlotHist: per-column histograms of a numeric
    matrix (bins over each column's range; one TSV per column).
  - plotreadposition.sh -> hiseq.PlotReadPosition: per-read x/y
    coordinates + barcode Hamming distance vs expected= barcodes.
  - cg2illumina.sh -> hiseq.BGI2Illumina: rewrite BGI/CG headers
    `<fc>[_run]L<lane>C<col>R<yyy><tile>/<pair>` into Illumina form
    `CG:0:<fc>:<lane>:<tile>:<x>:<y> <pair>:N:0:<barcode>`
    (BGIHeaderParser2.java:66-148: y = coord[0:3], tile = coord[3:]).
  - kapastats.sh -> jgi.GatherKapaStats: NOT portable — the reference
    fills plate data from a JGI-internal web service
    (GatherKapaStats.loadPlates -> Plate.fillFromWeb); gated here.

The micro-tile metrics reuse models/filterbytile's vectorized helpers
(one pass, device-free numpy — these are host-I/O-bound tools).
"""

from __future__ import annotations

import re
import sys

import numpy as np

from ..core.parser import tokenize
from .filterbytile import (
    avg_quality_by_prob,
    error_free_pct,
    parse_coords,
    polyg_flags,
)


def _microtile_table(inpath: str, xsize: int, ysize: int):
    """One pass over reads -> {(tile, xb, yb): [n, qsum, esum, polyg]}."""
    from ..io.fastq import FastqReader

    table: dict[tuple, list] = {}
    for b in FastqReader(inpath):
        if b.quals is None:
            continue
        qual = avg_quality_by_prob(b.quals, b.lengths.astype(np.int64))
        efree = error_free_pct(b.quals, b.lengths.astype(np.int64))
        pg = polyg_flags(b.bases, b.lengths)
        tile, x, y = parse_coords(b.ids)
        xb, yb = x // xsize, y // ysize
        for i in range(b.n):
            if tile[i] < 0:
                continue
            key = (int(tile[i]), int(xb[i]), int(yb[i]))
            row = table.get(key)
            if row is None:
                row = table[key] = [0, 0.0, 0.0, 0]
            row[0] += 1
            row[1] += float(qual[i])
            row[2] += float(efree[i])
            row[3] += int(pg[i])
    return table


def tiledump_main(args):
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out", "dump", "out1")
    if not inpath:
        print("Usage: tiledump in=<reads.fq> out=<dump.tsv>"
              " [xsize=500] [ysize=500]", file=sys.stderr)
        return 1
    xsize = int(a.get("xsize", default="500"))
    ysize = int(a.get("ysize", default="500"))
    table = _microtile_table(inpath, xsize, ysize)
    lines = ["#tile\tx\ty\treads\tavgQuality\terrorFreePct\tpolyGPct"]
    for (tile, xb, yb), (n, qs, es, pg) in sorted(table.items()):
        lines.append(f"{tile}\t{xb * xsize}\t{yb * ysize}\t{n}"
                     f"\t{qs / n:.4f}\t{es / n:.4f}\t{100.0 * pg / n:.4f}")
    text = "\n".join(lines) + "\n"
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text.encode())
    else:
        sys.stdout.write(text)
    print(f"Dumped {len(table)} micro-tiles.", file=sys.stderr)
    return 0


def plotflowcell_main(args):
    """Per-TILE (not micro-tile) quality grid + flagged low-quality
    tiles (PlotFlowCell role)."""
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out", "out1")
    if not inpath:
        print("Usage: plotflowcell in=<reads.fq> out=<tsv>"
              " [deviations=2]", file=sys.stderr)
        return 1
    dev = float(a.get("deviations", "dev", default="2"))
    table = _microtile_table(inpath, 1 << 30, 1 << 30)  # whole tiles
    tiles = sorted(table)
    q = np.array([table[t][1] / table[t][0] for t in tiles])
    n = np.array([table[t][0] for t in tiles], np.float64)
    mean = float((q * n).sum() / n.sum())
    std = float(np.sqrt(((q - mean) ** 2 * n).sum() / n.sum()))
    lines = ["#tile\treads\tavgQuality\tdelta\tflag"]
    flagged = 0
    for t, qv in zip(tiles, q):
        bad = std > 0 and (mean - qv) > dev * std
        flagged += bad
        lines.append(f"{t[0]}\t{int(table[t][0])}\t{qv:.4f}"
                     f"\t{qv - mean:+.4f}\t{'BAD' if bad else 'ok'}")
    text = "\n".join(lines) + "\n"
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text.encode())
    else:
        sys.stdout.write(text)
    print(f"{len(tiles)} tiles, {flagged} flagged; meanQ={mean:.3f}"
          f" std={std:.3f}", file=sys.stderr)
    return 0


def plothist_main(args):
    """plothist.sh: per-column histograms of a numeric TSV matrix."""
    a = tokenize(args)
    inpath = a.get("in", "in1")
    if not inpath:
        print("Usage: plothist in=<matrix.tsv> [out=<pattern with #>]"
              " [bins=100]", file=sys.stderr)
        return 1
    bins = int(a.get("bins", default="100"))
    out = a.get("out", default="hist_#.tsv")
    from ..io.readwrite import read_bytes

    rows = []
    header = None
    for ln in read_bytes(inpath).split(b"\n"):
        if not ln.strip():
            continue
        if ln.startswith(b"#"):
            header = ln[1:].split(b"\t")
            continue
        try:
            rows.append([float(x) for x in ln.split(b"\t")])
        except ValueError:
            header = ln.split(b"\t")
    mat = np.array(rows)
    if mat.ndim != 2 or not len(mat):
        print("No numeric rows found.", file=sys.stderr)
        return 1
    names = ([h.decode() for h in header] if header
             and len(header) == mat.shape[1]
             else [f"col{i}" for i in range(mat.shape[1])])
    for c in range(mat.shape[1]):
        col = mat[:, c]
        lo, hi = float(col.min()), float(col.max())
        width = (hi - lo) / bins if hi > lo else 1.0
        idx = np.clip(((col - lo) / width).astype(int), 0, bins - 1)
        hist = np.bincount(idx, minlength=bins)
        path = out.replace("#", names[c])
        with open(path, "w") as fh:
            fh.write(f"#bin_start\tcount\t({names[c]})\n")
            for i, cnt in enumerate(hist):
                fh.write(f"{lo + i * width:.5f}\t{int(cnt)}\n")
    print(f"Wrote {mat.shape[1]} histograms ({len(mat)} rows each).",
          file=sys.stderr)
    return 0


def plotreadposition_main(args):
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out", "out1")
    if not inpath:
        print("Usage: plotreadposition in=<reads.fq> out=<tsv>"
              " [expected=BC1,BC2,...]", file=sys.stderr)
        return 1
    expected = [b.encode() for b in
                (a.get("expected", "barcodes") or "").upper().split(",")
                if b]
    from ..io.fastq import FastqReader

    lines = ["#x\ty\tbarcodeHdist"]
    n = 0
    for b in FastqReader(inpath):
        tile, x, y = parse_coords(b.ids)
        for i in range(b.n):
            if tile[i] < 0:
                continue
            hd = -1
            name = b.ids[i]
            p = name.rfind(b":")
            bc = name[p + 1:].strip() if p >= 0 else b""
            if expected and bc:
                hd = min(
                    sum(c1 != c2 for c1, c2 in zip(bc, e))
                    + abs(len(bc) - len(e))
                    for e in expected
                )
            lines.append(f"{int(x[i])}\t{int(y[i])}\t{hd}")
            n += 1
    text = "\n".join(lines) + "\n"
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text.encode())
    else:
        sys.stdout.write(text)
    print(f"Plotted {n} read positions.", file=sys.stderr)
    return 0


# BGI/CG header: <flowcell>[_<run>]L<lane>C<col>R<coord>/<pair>
_BGI_RE = re.compile(
    rb"^(?P<fc>.+?)L(?P<lane>\d+)C(?P<col>\d+)R(?P<coord>\d+)"
    rb"/(?P<pair>\d)(?P<extra>\s.*)?$")


def bgi_to_illumina(name: bytes, barcode: bytes = b"") -> bytes:
    """BGIHeaderParser2.toIllumina (hiseq/BGIHeaderParser2.java:66-148):
    y = coord[0:3], tile = coord[3:], x = the C column field."""
    m = _BGI_RE.match(name)
    if m is None:
        return name
    fc = m.group("fc").split(b"_")[0]
    coord = m.group("coord")
    y = int(coord[:3] or b"0")
    tile = int(coord[3:] or b"0")
    x = int(m.group("col"))
    out = b"CG:0:%s:%d:%d:%d:%d %s:N:0:%s" % (
        fc, int(m.group("lane")), tile, x, y, m.group("pair"), barcode)
    extra = m.group("extra")
    if extra:
        out += b"\t" + extra.strip()
    return out


def cg2illumina_main(args):
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out", "out1")
    if not inpath or not out:
        print("Usage: cg2illumina in=<bgi.fq> out=<fq> [in2= out2=]"
              " [barcode=]", file=sys.stderr)
        return 1
    barcode = (a.get("barcode") or "").encode()
    from ..io.fastq import FastqReader, FastqWriter

    pairs = [(inpath, out)]
    if a.get("in2") and a.get("out2"):
        pairs.append((a.get("in2"), a.get("out2")))
    n = 0
    for src, dst in pairs:
        w = FastqWriter(dst)
        for batch in FastqReader(src):
            batch.ids = [bgi_to_illumina(i, barcode) for i in batch.ids]
            w.add(batch)
            n += batch.n
        w.close()
    print(f"Converted {n} headers.", file=sys.stderr)
    return 0


def kapastats_main(args):
    print("kapastats (jgi.GatherKapaStats) depends on a JGI-internal web"
          " service (Plate.fillFromWeb) for plate metadata and cannot run"
          " outside that environment.", file=sys.stderr)
    return 1
