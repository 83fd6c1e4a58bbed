"""Compositional scalar metrics (scalar/ package: scalars.sh,
scalarintervals.sh, cloudplot.sh).

Reference: tracker/KmerTracker.java:120-340 defines 14 GC-independent
dimer metrics (GC, strandedness, HH, PP, AAAT, CCCG, HMH, HHPP, ACTG,
ACAG, CAGA, CCMCG, ATMTA, AT) over a 16-cell dinucleotide count array;
scalar/Scalars.java computes them globally or in sliding windows and
prints the `#GC STR HH ...` table; scalar/ScalarIntervals.java emits
one row per interval; scalar/CloudPlot.java renders (GC, HH, CAGA)
triples as a 2D scatter with color encoding.

Dimer counting here is one vectorized np.bincount per batch.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.parser import parse_boolean, tokenize

_COLS = ["GC", "STR", "HH", "PP", "AAAT", "CCCG", "HMH", "HHPP", "ACTG",
         "ACAG", "CAGA", "CCMCG", "ATMTA", "AT"]


def dimer_counts(codes: np.ndarray) -> np.ndarray:
    """16-cell dinucleotide counts of one code array (N breaks pairs)."""
    c = np.asarray(codes)
    if len(c) < 2:
        return np.zeros(16, np.int64)
    a, b = c[:-1], c[1:]
    ok = (a < 4) & (b < 4)
    code = (a[ok].astype(np.int64) << 2) | b[ok].astype(np.int64)
    return np.bincount(code, minlength=16).astype(np.int64)


def metrics(counts: np.ndarray) -> dict:
    """KmerTracker.java metric formulas, verbatim."""
    c = counts.astype(np.float64)
    AA, AC, AG, AT = c[0b0000], c[0b0001], c[0b0010], c[0b0011]
    CA, CC, CG, CT = c[0b0100], c[0b0101], c[0b0110], c[0b0111]
    GA, GC_, GG, GT = c[0b1000], c[0b1001], c[0b1010], c[0b1011]
    TA, TC, TG, TT = c[0b1100], c[0b1101], c[0b1110], c[0b1111]
    acgt = np.zeros(4)
    for km in range(16):
        acgt[km & 3] += c[km]
    gc_total = acgt[1] + acgt[2]
    at_total = acgt[0] + acgt[3]
    gc = gc_total / max(gc_total + at_total, 1.0)
    lower = upper = 0.0
    for km in range(8):
        a_, b_ = c[km], c[15 & ~km]
        lower += min(a_, b_)
        upper += max(a_, b_)
    strand = (2 * upper / max(upper + lower, 1.0)) - 1
    at_group = max(AA + TT + AT + TA, 1.0)
    cg_group = max(CC + GG + CG + GC_, 1.0)
    aaat = (AA + TT) / at_group
    atmta = 0.5 * (1 + (AT - TA) / at_group)
    at_m = AT / at_group
    cccg = (CC + GG) / cg_group
    ccmcg = 0.5 * (1 + (CC + GG - CG) / cg_group)
    hh = (AA + CC + GG + TT) / max(
        AA + TT + AT + TA + CC + GG + CG + GC_, 1.0)
    pur = AA + AG + GA + GG
    pyr = CC + CT + TC + TT
    delta = AC + AT + CA + CG + GC_ + GT + TA + TG
    pp = (pur + pyr) / max(pur + pyr + delta, 1.0)
    mixed = max(AC + AG + CA + GA + TC + TG + CT + GT, 1.0)
    actg = (AC + TG + GT + CA) / mixed
    acag = 0.5 * (1 + (AC + GT - AG - CT) / mixed)
    caga = 0.5 * (1 + (CA + TG - GA - TC) / mixed)
    hmh = max(0.0, 0.5 * (aaat - cccg + 1))
    hhpp = 0.5 * (hh + pp)
    return dict(zip(_COLS, [gc, strand, hh, pp, aaat, cccg, hmh, hhpp,
                            actg, acag, caga, ccmcg, atmta, at_m]))


def _iter_records(path):
    from ..core.dna import encode
    from ..io.fileformat import Format, test_input

    ff = test_input(path)
    if ff.format is Format.FASTA:
        from ..io.fasta import iter_fasta

        for rec in iter_fasta(path):
            yield rec.name, encode(rec.seq)
    else:
        from ..io.fastq import FastqReader

        for b in FastqReader(path):
            for i in range(b.n):
                yield b.ids[i], b.bases[i, : b.lengths[i]]


def scalars_main(args):
    a = tokenize(args)
    inpath = a.get("in", "in1")
    if not inpath:
        print("Usage: scalars in=<fa|fq> [out=] [window=0] [decimals=4]",
              file=sys.stderr)
        return 1
    window = int(a.get("window", default="0"))
    dec = int(a.get("decimals", default="4"))
    per_seq = parse_boolean(a.get("persequence", "perseq", default="f"))
    rows = []
    total = np.zeros(16, np.int64)
    for name, codes in _iter_records(inpath):
        if window > 0:
            for s in range(0, max(len(codes) - window + 1, 1), window):
                cnt = dimer_counts(codes[s: s + window])
                rows.append(metrics(cnt))
        elif per_seq:
            rows.append(metrics(dimer_counts(codes)))
        else:
            total += dimer_counts(codes)
    if not rows:
        rows = [metrics(total)]
    hdr = "#" + "\t".join(_COLS)
    lines = [hdr]
    if len(rows) == 1:
        lines.append("\t".join(f"{rows[0][c]:.{dec}f}" for c in _COLS))
    else:
        mat = np.array([[r[c] for c in _COLS] for r in rows])
        lines.append("#mean\t" + "\t".join(
            f"{v:.{dec}f}" for v in mat.mean(axis=0)))
        lines.append("#std\t" + "\t".join(
            f"{v:.{dec}f}" for v in mat.std(axis=0)))
        for r in rows:
            lines.append("\t".join(f"{r[c]:.{dec}f}" for c in _COLS))
    text = "\n".join(lines) + "\n"
    out = a.get("out", "out1")
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text.encode())
    else:
        sys.stdout.write(text)
    return 0


def scalarintervals_main(args):
    """One row per fixed-size interval: name, start, then the metrics."""
    a = tokenize(args)
    inpath = a.get("in", "in1")
    if not inpath:
        print("Usage: scalarintervals in=<fa> [out=] [interval=10000]",
              file=sys.stderr)
        return 1
    size = int(a.get("interval", "window", "size", default="10000"))
    dec = int(a.get("decimals", default="4"))
    lines = ["#name\tstart\t" + "\t".join(_COLS)]
    for name, codes in _iter_records(inpath):
        nm = name.split()[0].decode()
        for s in range(0, max(len(codes) - size + 1, 1), size):
            m = metrics(dimer_counts(codes[s: s + size]))
            lines.append(f"{nm}\t{s}\t" + "\t".join(
                f"{m[c]:.{dec}f}" for c in _COLS))
    text = "\n".join(lines) + "\n"
    out = a.get("out", "out1")
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text.encode())
    else:
        sys.stdout.write(text)
    return 0


def cloudplot_main(args):
    """(GC, HH, CAGA) scatter. TSV input (gc hh caga per row) or fasta
    (windowed scalars computed first). PNG via matplotlib when present,
    else a text density grid."""
    a = tokenize(args)
    inpath = a.get("in", "in1")
    if not inpath:
        print("Usage: cloudplot in=<tsv|fa> out=<png|tsv> [window=10000]",
              file=sys.stderr)
        return 1
    out = a.get("out", default="cloud.tsv")
    pts = []
    from ..io.fileformat import Format, test_input

    if test_input(inpath).format in (Format.FASTA, Format.FASTQ):
        size = int(a.get("window", default="10000"))
        for name, codes in _iter_records(inpath):
            for s in range(0, max(len(codes) - size + 1, 1), size):
                m = metrics(dimer_counts(codes[s: s + size]))
                pts.append((m["GC"], m["HH"], m["CAGA"]))
    else:
        from ..io.readwrite import read_bytes

        for ln in read_bytes(inpath).split(b"\n"):
            if not ln.strip() or ln.startswith(b"#"):
                continue
            f = ln.split(b"\t")
            if len(f) >= 3:
                try:
                    pts.append((float(f[0]), float(f[1]), float(f[2])))
                except ValueError:
                    continue
    if not pts:
        print("No points.", file=sys.stderr)
        return 1
    arr = np.array(pts)
    if out.endswith(".png"):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(6, 6))
            sc = ax.scatter(arr[:, 0], arr[:, 1], c=arr[:, 2], s=4,
                            cmap="viridis")
            ax.set_xlabel("GC")
            ax.set_ylabel("HH")
            fig.colorbar(sc, label="CAGA")
            fig.savefig(out, dpi=120)
            print(f"Wrote {out} ({len(pts)} points).", file=sys.stderr)
            return 0
        except ImportError:
            out = out[:-4] + ".tsv"
            print("matplotlib not available; writing TSV instead.",
                  file=sys.stderr)
    bins = int(a.get("bins", default="40"))
    gx = np.clip((arr[:, 0] * bins).astype(int), 0, bins - 1)
    gy = np.clip((arr[:, 1] * bins).astype(int), 0, bins - 1)
    grid = np.zeros((bins, bins), np.int64)
    np.add.at(grid, (gy, gx), 1)
    with open(out, "w") as fh:
        fh.write("#gc\thh\tcaga\n")
        for g, h, c in pts:
            fh.write(f"{g:.4f}\t{h:.4f}\t{c:.4f}\n")
        fh.write("#density grid (rows=HH, cols=GC)\n")
        for r in range(bins - 1, -1, -1):
            fh.write("#" + "".join(
                " .:-=+*#%@"[min(int(v), 9)] for v in grid[r]) + "\n")
    print(f"Wrote {out} ({len(pts)} points).", file=sys.stderr)
    return 0
