"""Barcode/mux utilities: muxbyname, removebadbarcodes, filterbarcodes.

References (semantics source, no code reuse):
  - driver/MultiplexByName.java (muxbyname.sh) — merge reads from many
    files, renaming each read with its source-file stem prefix
    (the inverse of demuxbyname).
  - jgi/RemoveBadBarcodes.java (removebadbarcodes.sh) — drop reads
    whose Illumina-header barcode (text after the last ':') contains
    non-ACGT characters ('+' dual-index separators allowed).
  - jgi/FilterBarcodes.java (filterbarcodes.sh) — filter reads muxed
    with barcode qualities (mergebarcodes format name_SEQ_QUAL) by
    minimum average barcode quality maq=; baqhist= average-quality and
    bmqhist= min-quality histograms.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core.parser import tokenize
from ..io.fastq import FastqReader
from ..io.readwrite import open_output


def _records(path: str):
    for b in FastqReader(path):
        for i in range(b.n):
            yield b.ids[i], b.sequence(i), b.quality_string(i)


def muxbyname(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    a = tokenize([t for t in argv if "=" in t])
    files = [t for t in argv if "=" not in t]
    spec = a.get("in", "in1")
    if spec:
        files = spec.split(",") + files
    out1 = a.get("out", "out1")
    n = 0
    with open_output(out1) as fh:
        for path in files:
            stem = os.path.basename(path).split(".")[0].encode()
            for name, seq, qual in _records(path):
                fh.write(
                    b"@%s_%s\n%s\n+\n%s\n"
                    % (stem, name, seq, qual or b"I" * len(seq))
                )
                n += 1
    print(f"Muxed {n} reads from {len(files)} files.", file=sys.stderr)
    return n


def removebadbarcodes(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    ok_chars = set(b"ACGT+")
    kept = total = 0
    with open_output(out1) as fh:
        for name, seq, qual in _records(in1):
            total += 1
            barcode = name.rsplit(b":", 1)[-1].strip()
            if barcode and all(c in ok_chars for c in barcode):
                fh.write(b"@%s\n%s\n+\n%s\n" % (name, seq, qual or b"I" * len(seq)))
                kept += 1
    print(f"Kept {kept} of {total} reads.", file=sys.stderr)
    return kept, total


def filterbarcodes(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    maq = a.get_float("maq", default=0.0)
    baqhist = a.get("baqhist")
    bmqhist = a.get("bmqhist")
    kept = total = 0
    avg_hist = np.zeros(64, dtype=np.int64)
    min_hist = np.zeros(64, dtype=np.int64)
    fh = open_output(out1) if out1 else None
    for name, seq, qual in _records(in1):
        total += 1
        parts = name.rsplit(b"_", 2)
        if len(parts) == 3 and parts[1] and parts[2]:
            bqual = np.frombuffer(parts[2], dtype=np.uint8).astype(
                np.int32
            ) - 33
            avg = float(bqual.mean())
            mn = int(bqual.min())
        else:
            avg, mn = 0.0, 0
        avg_hist[min(int(avg), 63)] += 1
        min_hist[min(mn, 63)] += 1
        if avg >= maq:
            kept += 1
            if fh:
                fh.write(b"@%s\n%s\n+\n%s\n" % (name, seq, qual or b"I" * len(seq)))
    if fh:
        fh.close()
    for path, hist in ((baqhist, avg_hist), (bmqhist, min_hist)):
        if path:
            top = int(np.nonzero(hist)[0].max()) if hist.any() else 0
            with open_output(path) as hf:
                hf.write(b"#quality\treads\n")
                for q in range(top + 1):
                    hf.write(b"%d\t%d\n" % (q, int(hist[q])))
    print(f"Kept {kept} of {total} reads.", file=sys.stderr)
    return kept, total


if __name__ == "__main__":
    muxbyname()


def comparelabels(argv=None):
    """CompareLabels (comparelabels.sh, barcode/CompareLabels.java) —
    compare the last two delimited label terms of each read header
    (demux method A vs B). Counts AA (agree), AB (disagree), AU/UA
    (one side unknown), UU (both unknown); summary block mirrors
    printResults :200-225 (#RelYield/#AbsYield/#Contam*_PPM rows and the
    Count/Rate/PPM metric table). labelstats= writes per-label rows.
    """
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    labelstats = a.get("labelstats")
    swap = a.get_bool("swap", default=False)
    delim = a.get("delimiter", default="tab") or "tab"
    delim = {"tab": b"\t", "whitespace": b" ", "space": b" "}.get(
        delim, delim.encode()
    )
    quantset = None
    if a.get("quantset"):
        with open(a.get("quantset"), "rb") as fh:
            quantset = {
                ln.strip() for ln in fh.read().splitlines() if ln.strip()
            }
            quantset.add(b"unknown")
    unknown = b"unknown"
    aa = uu = au = ua = ab = invalid = n = 0
    per: dict[bytes, list] = {}  # label -> [match, mismatch, unknown2]
    for name, _, _ in _records(in1):
        n += 1
        terms = name.split(delim)
        if len(terms) < 3:
            invalid += 1
            continue
        l1, l2 = terms[-2].strip(), terms[-1].strip()
        if swap:
            l1, l2 = l2, l1
        if quantset is not None and (
            l1 not in quantset or l2 not in quantset
        ):
            invalid += 1
            continue
        u1, u2 = l1 == unknown, l2 == unknown
        stat = per.setdefault(l1, [0, 0, 0])
        if u1 and u2:
            uu += 1
        elif u1:
            ua += 1
        elif u2:
            au += 1
            stat[2] += 1
        elif l1 == l2:
            aa += 1
            stat[0] += 1
        else:
            ab += 1
            stat[1] += 1
    valid = n - invalid
    count1 = aa + ab + au  # reads side 1 assigned
    count2 = aa + ab + ua
    frac = 1.0 / max(n, 1)
    ppm = 1e6 / max(n, 1)
    lines = [
        b"#Labels\t%d" % n,
        b"#Valid\t%d\t%.6f" % (valid, valid * frac),
        b"#RelYield1\t%.5f" % (aa / max(count2, 1)),
        b"#RelYield2\t%.5f" % (aa / max(count1, 1)),
        b"#AbsYield1\t%.5f" % (count1 * frac),
        b"#AbsYield2\t%.5f" % (count2 * frac),
        b"#Contam1_PPM\t%.2f" % (ab * 1e6 / max(count1, 1)),
        b"#Contam2_PPM\t%.2f" % (ab * 1e6 / max(count2, 1)),
        b"#Metric\tCount\tRate\tPPM",
        b"AACount\t%d\t%.5f\t%.2f" % (aa, aa * frac, aa * ppm),
        b"UUCount\t%d\t%.5f\t%.2f" % (uu, uu * frac, uu * ppm),
        b"AUCount\t%d\t%.5f\t%.2f" % (au, au * frac, au * ppm),
        b"UACount\t%d\t%.5f\t%.2f" % (ua, ua * frac, ua * ppm),
        b"ABCount\t%d\t%.5f\t%.2f" % (ab, ab * frac, ab * ppm),
    ]
    blob = b"\n".join(lines) + b"\n"
    if out1 and out1 != "stdout":
        with open_output(out1) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    if labelstats:
        with open_output(labelstats) as fh:
            fh.write(b"#label\tmatch\tmismatch\tunknown2\n")
            for lab in sorted(per, key=lambda x: -sum(per[x])):
                m, mm, u2 = per[lab]
                fh.write(b"%s\t%d\t%d\t%d\n" % (lab, m, mm, u2))
    return dict(aa=aa, uu=uu, au=au, ua=ua, ab=ab, n=n)
