"""Contamination synthesis tools: CrossContaminate, MakeContaminatedGenomes.

References (SURVEY.md §6 synth loop):
  - jgi/CrossContaminate.java — swap a fraction of reads between files
    to simulate index-hopping/cross-contamination.
  - jgi/MakeContaminatedGenomes.java — splice fragments of a contaminant
    genome into a host genome at a target contamination fraction.

Used with seal/bbsplit/bbduk in the synthesize->grade loop.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.parser import tokenize
from ..io.fasta import iter_fasta, write_fasta
from ..io.fastq import FastqReader, encode_fastq
from ..io.readwrite import open_output


def cross_contaminate(argv=None):
    """in=a.fq,b.fq out=a2.fq,b2.fq rate=0.01 seed=N — each read swaps
    into the other file with probability `rate`."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    ins = (a.get("in", "in1") or "").split(",")
    outs = (a.get("out", "out1") or "").split(",")
    rate = a.get_float("rate", "contamrate", default=0.01)
    seed = a.get_int("seed", default=1)
    if len(ins) != 2 or len(outs) != 2:
        raise ValueError("crosscontaminate needs in=a,b out=a2,b2")
    rng = np.random.default_rng(seed)
    fh = [open_output(outs[0]), open_output(outs[1])]
    swapped = total = 0
    for src in (0, 1):
        for b in FastqReader(ins[src]):
            move = rng.random(b.n) < rate
            fh[src].write(encode_fastq(b, ~move))
            fh[1 - src].write(encode_fastq(b, move))
            swapped += int(move.sum())
            total += b.n
    for f in fh:
        f.close()
    print(
        f"Swapped {swapped}/{total} reads ({100.0*swapped/max(total,1):.3f}%)",
        file=sys.stderr,
    )
    return swapped, total


def make_contaminated(argv=None):
    """ref=host.fa contam=bug.fa out=mix.fa fraction=0.05 fragsize=2000 —
    splice contaminant fragments into the host at ~`fraction` of bases."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    host_p = a.get("ref", "in", "host")
    contam_p = a.get("contam", "contaminant")
    out1 = a.get("out", "out1")
    fraction = a.get_float("fraction", "rate", default=0.05)
    fragsize = a.get_int("fragsize", "frag", default=2000)
    seed = a.get_int("seed", default=1)
    rng = np.random.default_rng(seed)
    host = list(iter_fasta(host_p))
    contam = list(iter_fasta(contam_p))
    cseq = b"".join(rec.seq for rec in contam)
    out_records = []
    inserted = 0
    total = 0
    for rec in host:
        seq = bytearray(rec.seq)
        total += len(seq)
        n_frags = max(
            0, int(round(len(seq) * fraction / max(fragsize, 1)))
        )
        for _ in range(n_frags):
            if len(cseq) <= fragsize:
                frag = cseq
            else:
                o = int(rng.integers(0, len(cseq) - fragsize))
                frag = cseq[o : o + fragsize]
            pos = int(rng.integers(0, max(1, len(seq) - 1)))
            seq[pos:pos] = frag
            inserted += len(frag)
        out_records.append((rec.name, bytes(seq)))
    if out1:
        write_fasta(out1, out_records)
    print(
        f"Inserted {inserted} contaminant bases into {total} "
        f"({100.0*inserted/max(total+inserted,1):.2f}%)",
        file=sys.stderr,
    )
    return inserted, total
