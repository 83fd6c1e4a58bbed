"""RandomReads — synthetic read generation CLI (synth/RandomReads3.java).

Generates reads from a reference with configured SNP rate, encoding the
true origin in headers (the synthesize->grade loop, SURVEY.md §4.1).
"""

from __future__ import annotations

import sys

from ..core.parser import tokenize
from ..io.fasta import load_reference
from ..utils.synth import random_reads, write_reads


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    ref_path = a.get("ref")
    out = a.get("out", "out1")
    out2 = a.get("out2")
    n = a.get_int("reads", default=1000)
    length = a.get_int("length", "len", "readlength", default=150)
    paired = a.get_bool("paired", default=out2 is not None)
    snprate = a.get_float("snprate", default=0.0)
    mininsert = a.get_int("mininsert", default=2 * length)
    maxinsert = a.get_int("maxinsert", default=3 * length)
    q = a.get_int("q", "qual", default=35)
    seed = a.get_int("seed", default=42)
    ref = load_reference(ref_path)
    reads = random_reads(
        ref, n, read_len=length, paired=paired,
        insert_range=(mininsert, maxinsert), snp_rate=snprate, q=q, seed=seed,
    )
    if paired:
        write_reads(out, [p[0] for p in reads])
        if out2:
            write_reads(out2, [p[1] for p in reads])
    else:
        write_reads(out, reads)
    print(f"Wrote {n} {'pairs' if paired else 'reads'}.", file=sys.stderr)
    return reads


if __name__ == "__main__":
    main()
