"""Small utility tools: Shred, FuseSequence, PartitionReads,
CalcUniqueness (bbcountunique).

References:
  - synth/Shred.java — cut sequences into `length=` windows with
    `overlap=` (stride = length - overlap), dropping sub-`minlength`
    tails.
  - synth/FuseSequence.java — concatenate all input sequences into one
    record, `npad=300` Ns between fragments (:45).
  - scalar/PartitionReads.java — deal reads round-robin into `ways=`
    output files (pattern with %).
  - jgi/CalcUniqueness.java — sequencing-saturation curves: per
    `interval=25000` reads (:717), the percent of reads whose probe
    k-mer (k=25, :80) was never seen before; `first` uses the k-mer at
    offset 0, `rand` a random offset, cumulative=f resets per interval
    (:240-300). Output is the reference's tab table.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.parser import tokenize
from ..io.fasta import iter_fasta, write_fasta
from ..io.fastq import FastqReader, encode_fastq
from ..io.readwrite import open_output


# ---------------------------------------------------------------- shred
def shred(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    length = a.get_int("length", "shredlength", default=500)
    overlap = a.get_int("overlap", default=0)
    minlen = max(1, min(a.get_int("minlength", "minlen", default=1), length))
    stride = max(1, length - overlap)
    records = []
    n_in = 0
    for rec in iter_fasta(in1):
        n_in += 1
        seq = rec.seq
        for start in range(0, max(1, len(seq)), stride):
            piece = seq[start : start + length]
            if len(piece) < minlen:
                break
            records.append(
                (rec.name.split()[0] + b"_%d-%d" % (start, start + len(piece)),
                 piece)
            )
            if start + length >= len(seq):
                break
    if out1:
        write_fasta(out1, records)
    print(f"Shreds:              \t{len(records)}", file=sys.stderr)
    return records


# ----------------------------------------------------------------- fuse
def fuse(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    npad = a.get_int("pad", "npad", "ns", default=300)
    name = (a.get("name") or "fused").encode()
    parts = [rec.seq for rec in iter_fasta(in1)]
    fused = (b"N" * npad).join(parts)
    if out1:
        write_fasta(out1, [(name, fused)])
    print(
        f"Fused {len(parts)} sequences into {len(fused)} bases",
        file=sys.stderr,
    )
    return fused


# ------------------------------------------------------------ partition
def partition(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1", default="")
    ways = a.get_int("ways", default=2)
    if "%" not in out1:
        raise ValueError("partition requires out= containing %")
    outs = [open_output(out1.replace("%", str(w))) for w in range(ways)]
    n = 0
    from ..io.fileformat import Format, test_input

    if test_input(in1).format is Format.FASTA:
        # FASTA records are dealt as FASTA, wrapped as write_fasta wraps
        # them (a FastqReader takes a FASTA file's lines as records)
        for rec in iter_fasta(in1):
            outs[n % ways].write(b">" + rec.name + b"\n" + b"".join(
                rec.seq[i:i + 70] + b"\n" for i in range(0, len(rec.seq), 70)))
            n += 1
        batches = ()
    else:
        batches = FastqReader(in1)
    for b in batches:
        rows = (np.arange(b.n) + n) % ways
        for w in range(ways):
            sel = rows == w
            if sel.any():
                outs[w].write(encode_fastq(b, sel))
        n += b.n
    for fh in outs:
        fh.close()
    print(f"Partitioned {n} reads {ways} ways", file=sys.stderr)
    return n


# ------------------------------------------------- bbcountunique
def count_uniqueness(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    k = a.get_int("k", default=25)
    interval = a.get_int("interval", default=25000)
    cumulative = a.get_bool("cumulative", default=False)
    rng = np.random.default_rng(a.get_int("seed", default=0))
    seen_first: set[int] = set()
    seen_rand: set[int] = set()
    first_hits = first_misses = 0
    rand_hits = rand_misses = 0
    rows = []
    count = 0

    def kmer_at(codes, off):
        if off + k > len(codes):
            return -1
        w = codes[off : off + k]
        if (w >= 4).any():
            return -1
        v = 0
        for c in w:
            v = (v << 2) | int(c)
        return v

    def flush():
        nonlocal first_hits, first_misses, rand_hits, rand_misses
        fp = 100.0 * first_misses / max(first_misses + first_hits, 1)
        rp = 100.0 * rand_misses / max(rand_misses + rand_hits, 1)
        rows.append((count, fp, rp))
        if not cumulative:
            first_hits = first_misses = rand_hits = rand_misses = 0

    for b in FastqReader(in1):
        for i in range(b.n):
            L = int(b.lengths[i])
            codes = b.bases[i, :L]
            km = kmer_at(codes, 0)
            if km >= 0:
                if km in seen_first:
                    first_hits += 1
                else:
                    seen_first.add(km)
                    first_misses += 1
            if L > k:
                km2 = kmer_at(codes, int(rng.integers(0, L - k)))
                if km2 >= 0:
                    if km2 in seen_rand:
                        rand_hits += 1
                    else:
                        seen_rand.add(km2)
                        rand_misses += 1
            count += 1
            if count % interval == 0:
                flush()
    if count % interval:
        flush()
    text = "#count\tfirst\trand\n" + "".join(
        f"{c}\t{fp:.3f}\t{rp:.3f}\n" for c, fp, rp in rows
    )
    if out1:
        with open_output(out1) as fh:
            fh.write(text.encode())
    sys.stderr.write(text)
    return rows
