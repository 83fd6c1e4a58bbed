"""AssemblyStats — N50/L50 etc (jgi/AssemblyStats2.java, stats.sh).

Computes the headline assembly metrics: scaffold/contig counts, total
size, GC, N50/L50/N90/L90, max length, and the standard summary block.
Contigs are scaffold segments split at runs of >= `mingap` Ns.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.parser import tokenize
from ..io.fasta import iter_fasta


def n_metrics(lengths: np.ndarray, frac: float):
    """(Nxx, Lxx): length at which `frac` of the total is contained."""
    if len(lengths) == 0:
        return 0, 0
    s = np.sort(lengths)[::-1]
    cum = np.cumsum(s)
    target = cum[-1] * frac
    i = int(np.searchsorted(cum, target))
    return int(s[min(i, len(s) - 1)]), i + 1


def analyze(path: str, mingap: int = 1):
    scaffold_lens = []
    contig_lens = []
    gc = 0
    at = 0
    ns = 0
    for rec in iter_fasta(path):
        seq = rec.seq.upper()
        scaffold_lens.append(len(seq))
        arr = np.frombuffer(seq, dtype=np.uint8)
        gc += int(((arr == ord("G")) | (arr == ord("C"))).sum())
        at += int(((arr == ord("A")) | (arr == ord("T"))).sum())
        isn = ~np.isin(arr, np.frombuffer(b"ACGT", dtype=np.uint8))
        ns += int(isn.sum())
        # split contigs at N runs >= mingap
        run = 0
        start = 0
        pos = 0
        for flag in np.concatenate([isn, [True]]):
            if flag:
                if run == 0:
                    end = pos
                run += 1
            else:
                if run >= mingap and pos - start - run > 0:
                    contig_lens.append(end - start)
                    start = pos
                run = 0
            pos += 1
        if pos - start > 0:
            contig_lens.append(pos - start)
    return (
        np.asarray(scaffold_lens, dtype=np.int64),
        np.asarray(contig_lens, dtype=np.int64),
        gc,
        at,
        ns,
    )


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    path = a.get("in", "in1", "ref")
    mingap = a.get_int("mingap", default=1)
    scafs, contigs, gc, at, ns = analyze(path, mingap)
    total = int(scafs.sum())
    ctotal = int(contigs.sum())
    n50, l50 = n_metrics(scafs, 0.5)
    n90, l90 = n_metrics(scafs, 0.9)
    cn50, cl50 = n_metrics(contigs, 0.5)
    gcf = gc / max(gc + at, 1)
    out = sys.stdout
    print(f"Main genome scaffold total:         \t{len(scafs)}", file=out)
    print(f"Main genome contig total:           \t{len(contigs)}", file=out)
    print(f"Main genome scaffold sequence total:\t{total/1e6:.3f} MB", file=out)
    print(f"Main genome contig sequence total:  \t{ctotal/1e6:.3f} MB  \t{100.0*(total-ctotal)/max(total,1):.3f}% gap", file=out)
    print(f"Main genome scaffold N/L50:         \t{l50}/{_fmt(n50)}", file=out)
    print(f"Main genome contig N/L50:           \t{cl50}/{_fmt(cn50)}", file=out)
    print(f"Main genome scaffold N/L90:         \t{l90}/{_fmt(n90)}", file=out)
    print(f"Max scaffold length:                \t{_fmt(int(scafs.max(initial=0)))}", file=out)
    print(f"Max contig length:                  \t{_fmt(int(contigs.max(initial=0)))}", file=out)
    print(f"GC content:                         \t{gcf*100:.2f}%", file=out)
    return dict(
        scaffolds=len(scafs), contigs=len(contigs), total=total, n50=n50,
        l50=l50, gc=gcf,
    )


def _fmt(n: int) -> str:
    if n >= 1_000_000:
        return f"{n/1e6:.3f} MB"
    if n >= 1_000:
        return f"{n/1e3:.3f} KB"
    return str(n)


if __name__ == "__main__":
    main()
