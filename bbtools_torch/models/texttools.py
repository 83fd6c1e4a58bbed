"""bloomfilter, from the JAX package's text and sketch tools (texttools.py).

The PyTorch port of bbtools_tpu/models/texttools.py's bloomfilter
(bloom/BloomFilterWrapper, bloomfilter.sh): build a counting filter of
the ref= k-mers (keys max(forward, reverse), as the JAX package takes
them) in a count-min sketch on the run's device (`device=`, cuda by
default; ops/cms.py), then keep (or with include=f toss) reads with >=
minhits k-mer hits, one sketch query a batch. The k-mers are rolled on
the device too (`ops/kmer_count.read_keys_t`; host numpy in the JAX
package). The other tools of that module do no device work (ROADMAP
A8b).
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fasta import iter_fasta
from ..io.fastq import FastqReader


def bloomfilter(argv=None):
    """bloomfilter.sh (bloom/BloomFilterWrapper role): build a counting
    filter from ref= k-mers on device (ops/cms.CountMinSketch), then
    keep (or with include=f toss) reads with >= minhits k-mer hits."""
    from ..core.dna import encode
    from ..io.fastq import FastqWriter
    from ..ops.cms import CountMinSketch
    from ..ops.kmer_count import read_keys_t

    a = tokenize(argv if argv is not None else sys.argv[1:])
    device = resolve_device(a.get("device", default="cuda"))
    in1 = a.get("in", "in1")
    ref = a.get("ref")
    out1 = a.get("out", "out1")
    outm = a.get("outm", "outmatch")
    k = a.get_int("k", default=31)
    minhits = a.get_int("minhits", default=1)
    include = a.get_bool("include", default=False)
    cms = CountMinSketch(device=device)
    for rec in iter_fasta(ref):
        codes = encode(rec.seq)
        if len(codes) < k:
            continue
        flat, _ = read_keys_t(codes[None, :], [len(codes)], k, device, canonical=False)
        cms.add(flat)
    kept = total = 0
    w = FastqWriter(out1) if out1 else None
    wm = FastqWriter(outm) if outm else None
    for b in FastqReader(in1):
        flat, counts = read_keys_t(b.bases, b.lengths, k, device, canonical=False)
        hits = np.zeros(b.n, np.int64)
        if len(flat):
            found = cms.query(flat) > 0
            hits = np.bincount(np.repeat(np.arange(b.n), counts), weights=found,
                               minlength=b.n).astype(np.int64)
        matched = hits >= minhits
        keep = matched if include else ~matched
        total += b.n
        kept += int(keep.sum())
        if w:
            w.add(b, keep)
        if wm:
            wm.add(b, matched)
    for x in (w, wm):
        if x:
            x.close()
    print(f"Reads Processed:    \t{total}", file=sys.stderr)
    print(f"Reads Out:          \t{kept}", file=sys.stderr)
    return kept, total
