"""GradeBins — grade metagenome bins for completeness and contamination
(gradebins.sh, bin/GradeBins.java role).

Truth mode: contig headers carry `tid_X` (the convention our synthesis
tools and the reference's CAMI renamers emit). Per bin, the primary
taxon is the one with the largest base share; completeness =
primary-taxon bases in the bin / that taxon's total bases (from ref= if
given, else summed over all bins); contamination = non-primary bases /
bin bases. The overall Completeness/Contamination Scores are the
size-weighted means the reference defines in its usage text.
"""

from __future__ import annotations

import glob
import os
import re
import sys

from ..core.parser import tokenize
from ..io.fasta import iter_fasta
from ..io.readwrite import open_output

_TID = re.compile(rb"tid_(\d+)")


def _tid_of(name: bytes) -> int | None:
    m = _TID.search(name)
    return int(m.group(1)) if m else None


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    a = tokenize([t for t in argv if "=" in t])
    pos_files = [t for t in argv if "=" not in t]
    indir = a.get("in")
    ref = a.get("ref")
    report = a.get("report", "out")
    hist_out = a.get("hist")

    bin_files = list(pos_files)
    if indir:
        if os.path.isdir(indir):
            bin_files += sorted(
                glob.glob(os.path.join(indir, "*.fa"))
                + glob.glob(os.path.join(indir, "*.fasta"))
                + glob.glob(os.path.join(indir, "*.fa.gz"))
            )
        else:
            bin_files += indir.split(",")

    # taxon total sizes
    tax_total: dict[int, int] = {}
    if ref:
        for rec in iter_fasta(ref):
            t = _tid_of(rec.name)
            if t is not None:
                tax_total[t] = tax_total.get(t, 0) + len(rec.seq)

    bins = []  # (name, size, primary_tid, primary_bases, tax_sizes)
    for path in bin_files:
        sizes: dict[int, int] = {}
        total = 0
        for rec in iter_fasta(path):
            t = _tid_of(rec.name)
            total += len(rec.seq)
            if t is not None:
                sizes[t] = sizes.get(t, 0) + len(rec.seq)
        if not ref:
            for t, s in sizes.items():
                tax_total[t] = tax_total.get(t, 0) + s
        bins.append((os.path.basename(path), total, sizes))

    rows = []
    comp_score_num = contam_score_num = denom = 0.0
    for name, total, sizes in bins:
        if sizes:
            primary = max(sizes, key=lambda t: sizes[t])
            pbases = sizes[primary]
        else:
            primary, pbases = -1, 0
        completeness = pbases / max(tax_total.get(primary, pbases), 1)
        contam = (total - pbases) / max(total, 1)
        rows.append((name, total, primary, completeness, contam))
        comp_score_num += completeness * total
        contam_score_num += contam * total
        denom += total
    comp_score = comp_score_num / max(denom, 1)
    contam_score = contam_score_num / max(denom, 1)

    lines = [
        b"#CompletenessScore\t%.4f\n" % comp_score,
        b"#ContaminationScore\t%.4f\n" % contam_score,
        b"#bin\tsize\tprimary_tid\tcompleteness\tcontam\n",
    ]
    for name, total, primary, completeness, contam in rows:
        lines.append(
            b"%s\t%d\t%d\t%.4f\t%.4f\n"
            % (name.encode(), total, primary, completeness, contam)
        )
    blob = b"".join(lines)
    if report:
        with open_output(report) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    if hist_out:
        rows_sorted = sorted(rows, key=lambda r: -r[1])
        cum = 0
        with open_output(hist_out) as fh:
            fh.write(b"#rank\tcum_size\tcontam\n")
            for i, (name, total, _p, _c, contam) in enumerate(rows_sorted):
                cum += total
                fh.write(b"%d\t%d\t%.4f\n" % (i + 1, cum, contam))
    print(
        f"Bins: {len(bins)}  CompletenessScore: {comp_score:.4f}  "
        f"ContaminationScore: {contam_score:.4f}",
        file=sys.stderr,
    )
    return rows


if __name__ == "__main__":
    main()
