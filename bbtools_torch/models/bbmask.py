"""BBMask — mask low-entropy/repetitive reference regions (jgi/BBMask.java).

Windowed Shannon-entropy masking with the exact EntropyTracker model
(ops/entropy.py): windows whose entropy falls below the cutoff are masked
to N (or lowercase with masklowercase=t). Default window/k match the
reference (window=80, k=5 for bbmask; entropy=0.70).
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.dna import BASE_TO_CODE
from ..core.parser import tokenize
from ..io.fasta import iter_fasta, write_fasta
from ..ops.entropy import EntropyModel


def mask_sequence(seq: bytes, em: EntropyModel, cutoff: float,
                  lowercase: bool = False) -> tuple[bytes, int]:
    codes = BASE_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]
    n = len(codes)
    if n < em.window:
        return seq, 0
    W = em.window
    # per-window entropy via the batch engine: treat each window position
    # as one measurement; recover per-window values by sliding evaluation
    # (host loop over windows in chunks for memory economy)
    arr = bytearray(seq)
    masked = 0
    chunk = 8192
    starts = np.arange(0, n - W + 1)
    for c0 in range(0, len(starts), chunk):
        cs = starts[c0 : c0 + chunk]
        wins = np.stack([codes[s : s + W] for s in cs])
        lens = np.full(len(cs), W, dtype=np.int64)
        # single-window entropy == averageEntropy of an exactly-window-long
        # sequence (one measurement)
        vals = em.average_entropy_batch(wins, lens)
        for s, v in zip(cs, vals):
            if v < cutoff:
                for i in range(s, s + W):
                    if lowercase:
                        arr[i] = arr[i] | 0x20
                    elif arr[i] != ord("N"):
                        arr[i] = ord("N")
                        masked += 1
    return bytes(arr), masked


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1", "ref")
    out = a.get("out", "out1")
    entropy = a.get_float("entropy", default=0.70)
    window = a.get_int("window", "w", default=80)
    k = a.get_int("ke", "k", default=5)
    lowercase = a.get_bool("masklowercase", "lc", default=False)
    em = EntropyModel(k=k, window=window)
    records = []
    total_masked = 0
    total = 0
    for rec in iter_fasta(in1):
        seq, masked = mask_sequence(rec.seq, em, entropy, lowercase)
        total_masked += masked
        total += len(seq)
        records.append((rec.name, seq))
    if out:
        write_fasta(out, records)
    print(f"Masked {total_masked} of {total} bases ({100.0*total_masked/max(total,1):.3f}%)", file=sys.stderr)
    return total_masked


if __name__ == "__main__":
    main()
