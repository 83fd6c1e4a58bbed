"""FungalRelease — reformat a fungal assembly for release
(fungalrelease.sh, jgi/FungalRelease.java role).

Scaffolds are upper-cased (tuc=t), gaps of at least `mingapin` Ns are
expanded to at least `mingap` Ns, scaffolds are sorted descending by
length (sortscaffolds=t) and renamed scaffold_# (renamescaffolds=t,
first number scafnum=), short scaffolds dropped (minscaf=). Contigs
(gap-split pieces, mincontig=) go to outc=, with names scafname_c# (or
contig_# with renamecontigs=t). agp= writes an AGP v2.0 scaffold->contig
map; legend= writes old->new scaffold names.
"""

from __future__ import annotations

import sys

from ..core.parser import tokenize
from ..io.fasta import FastaRecord, read_fasta, write_fasta
from ..io.readwrite import open_output


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    outc = a.get("outc")
    agp = a.get("agp")
    legend = a.get("legend")
    wrap = a.get_int("fastawrap", default=60)
    tuc = a.get_bool("tuc", default=True)
    baniupac = a.get_bool("baniupac", default=True)
    mingap = a.get_int("mingap", default=10)
    mingapin = a.get_int("mingapin", default=1)
    sort_scaf = a.get_bool("sortscaffolds", default=True)
    rename_scaf = a.get_bool("renamescaffolds", default=True)
    scafnum = a.get_int("scafnum", default=1)
    rename_contigs = a.get_bool("renamecontigs", default=False)
    contignum = a.get_int("contignum", default=1)
    minscaf = a.get_int("minscaf", default=1)
    mincontig = a.get_int("mincontig", default=1)

    recs = read_fasta(in1)
    scaffolds = []
    for rec in recs:
        seq = rec.seq.upper() if tuc else rec.seq
        if baniupac:
            bad = set(seq) - set(b"ACGTN")
            if bad:
                raise ValueError(
                    f"non-ACGTN base {bad} in {rec.name[:40]!r} "
                    "(baniupac=t)"
                )
        # expand gaps: every N-run of length >= mingapin becomes >= mingap
        pieces = []
        i = 0
        L = len(seq)
        while i < L:
            if seq[i : i + 1] == b"N":
                j = i
                while j < L and seq[j : j + 1] == b"N":
                    j += 1
                run = j - i
                if run >= mingapin:
                    run = max(run, mingap)
                pieces.append(b"N" * run)
                i = j
            else:
                j = seq.find(b"N", i)
                j = L if j < 0 else j
                pieces.append(seq[i:j])
                i = j
        seq = b"".join(pieces)
        if len(seq) >= minscaf:
            scaffolds.append(FastaRecord(rec.name, seq))
    if sort_scaf:
        scaffolds.sort(key=lambda r: (-len(r.seq), r.name))

    legend_rows = []
    out_scafs = []
    contigs = []
    agp_rows = []
    cnum = contignum
    for si, rec in enumerate(scaffolds):
        new_name = (
            b"scaffold_%d" % (scafnum + si) if rename_scaf else rec.name
        )
        legend_rows.append((rec.name, new_name))
        out_scafs.append(FastaRecord(new_name, rec.seq))
        # split into contigs at N-runs >= mingapin
        part = 1
        pos = 0
        L = len(rec.seq)
        i = 0
        while i < L:
            if rec.seq[i : i + 1] == b"N":
                j = i
                while j < L and rec.seq[j : j + 1] == b"N":
                    j += 1
                if j - i >= mingapin:
                    agp_rows.append(
                        b"%s\t%d\t%d\t%d\tN\t%d\tscaffold\tyes\tpaired-ends\n"
                        % (new_name, i + 1, j, part, j - i)
                    )
                    part += 1
                i = j
            else:
                j = rec.seq.find(b"N", i)
                j = L if j < 0 else j
                if j - i >= mincontig:
                    cname = (
                        b"contig_%d" % cnum if rename_contigs
                        else b"%s_c%d" % (new_name, part)
                    )
                    contigs.append(FastaRecord(cname, rec.seq[i:j]))
                    agp_rows.append(
                        b"%s\t%d\t%d\t%d\tW\t%s\t1\t%d\t+\n"
                        % (new_name, i + 1, j, part, cname, j - i)
                    )
                    cnum += 1
                    part += 1
                i = j
        _ = pos
    if out1:
        write_fasta(out1, out_scafs, wrap=wrap)
    if outc:
        write_fasta(outc, contigs, wrap=wrap)
    if agp:
        with open_output(agp) as fh:
            fh.write(b"##agp-version\t2.0\n")
            fh.writelines(agp_rows)
    if legend:
        with open_output(legend) as fh:
            for old, new in legend_rows:
                fh.write(old + b"\t" + new + b"\n")
    print(
        f"Scaffolds: {len(out_scafs)}  Contigs: {len(contigs)}",
        file=sys.stderr,
    )
    return out_scafs, contigs


if __name__ == "__main__":
    main()
