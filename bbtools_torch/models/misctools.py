"""kmercoverage, from the JAX package's stream tools (misctools.py).

The PyTorch port of bbtools_tpu/models/misctools.py's kmercoverage
(jgi/KmerCoverage.java, kmercoverage.sh): annotate each read header with
its k-mer depth (min/avg) from a count-min sketch built over the input
(+extra=), and write a depth histogram. The sketch lives on the run's
device (`device=`, cuda by default; ops/cms.py, 2 hashes), as are the
k-mers (`ops/kmer_count.read_keys_t`; the JAX package rolls them in
host numpy). The JAX package queries the sketch once a read; the port
queries a batch's valid k-mers in one call and splits the estimates by
read, so each read's min and mean come from its own int64 slice in the
same order. The other tools of that module do no device work (ROADMAP
A8b).
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fastq import FastqReader
from ..io.readwrite import open_output


def kmercoverage(argv=None):
    from ..ops.cms import CountMinSketch
    from ..ops.kmer_count import read_keys_t

    a = tokenize(argv if argv is not None else sys.argv[1:])
    device = resolve_device(a.get("device", default="cuda"))
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    hist_out = a.get("hist")
    extra = a.get("extra")
    k = a.get_int("k", default=31)

    cms = CountMinSketch(hashes=a.get_int("hashes", default=2), device=device)
    sources = [in1] + (extra.split(",") if extra else [])
    for path in sources:
        for b in FastqReader(path):
            flat, _ = read_keys_t(b.bases, b.lengths, k, device)
            if len(flat):
                cms.add(flat)

    hist = np.zeros(1 << 16, dtype=np.int64)
    n = 0
    with open_output(out1) as fh:
        for b in FastqReader(in1):
            flat, counts = read_keys_t(b.bases, b.lengths, k, device)
            depths_all = cms.query(flat) if len(flat) else np.zeros(0, np.int64)
            ends = np.cumsum(counts)
            for i in range(b.n):
                depths = depths_all[ends[i] - counts[i]: ends[i]]
                if len(depths):
                    mind, avgd = int(depths.min()), float(depths.mean())
                else:
                    mind, avgd = 0, 0.0
                hist[min(int(avgd), hist.shape[0] - 1)] += 1
                fh.write(
                    b"@%s min=%d avg=%.2f\n%s\n+\n%s\n"
                    % (
                        b.ids[i], mind, avgd, b.sequence(i),
                        b.quality_string(i) or b"I" * int(b.lengths[i]),
                    )
                )
                n += 1
    if hist_out:
        top = int(np.nonzero(hist)[0].max()) if hist.any() else 0
        with open_output(hist_out) as fh:
            fh.write(b"#depth\treads\n")
            for d in range(top + 1):
                fh.write(b"%d\t%d\n" % (d, int(hist[d])))
    print(f"Annotated {n} reads.", file=sys.stderr)
    return n
