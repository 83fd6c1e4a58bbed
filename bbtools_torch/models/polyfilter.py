"""PolyFilter — remove reads with suspicious homopolymers (polyfilter.sh,
jgi/PolyFilter.java role).

The PyTorch port of bbtools_tpu/models/polyfilter.py. Filtering rules
(reference usage contract):
  - a read is ALWAYS discarded if it fails ldf2, entropy2, quality2, or
    minpolymer2;
  - a read is ALSO discarded if it fails minpolymer AND any of
    (ldf, entropy, quality);
  - a pair is discarded if either read is discarded.

Depth analysis counts read k-mers against a count-min sketch loaded from
`extra=`, on the run's device (`device=`, cuda by default; ops/cms.py),
the k-mers rolled there too (`ops/kmer_count.read_keys_t`); a k-mer is
low-depth when its count < mincount. The JAX package adds and queries
the sketch once a read; the port adds a batch's k-mers in one call (the
saturating add gives the same counters: min(min(c+a, M)+b, M) =
min(c+a+b, M)) and queries them in one call, split by read. The
homopolymer length (`_max_pure_run`) and the entropy model are the JAX
package's host code.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fastq import FastqReader, FastqWriter, interleave, paired_reader
from ..ops.cms import CountMinSketch
from ..ops.entropy import EntropyModel
from ..ops.kmer_count import read_keys_t


def _max_pure_run(codes: np.ndarray, length: int, symbol: int,
                  purity: float) -> int:
    """Longest window with >= purity fraction equal to `symbol` whose
    first and last base are the symbol (two-pointer, O(L))."""
    x = codes[:length] == symbol
    best = lo = ones = 0
    for hi in range(length):
        if x[hi]:
            ones += 1
        while lo <= hi and (
            not x[lo] or (ones < purity * (hi - lo + 1))
        ):
            if x[lo]:
                ones -= 1
            lo += 1
        if x[hi] and ones >= purity * (hi - lo + 1):
            best = max(best, hi - lo + 1)
    return best


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    device = resolve_device(a.get("device", default="cuda"))
    in1, in2 = a.get("in", "in1"), a.get("in2")
    out1, out2 = a.get("out", "out1"), a.get("out2")
    outb = a.get("outb", "outbad")
    k = a.get_int("k", default=31)
    mincount = a.get_int("mincount", default=2)
    ldf = a.get_float("ldf", "lowdepthfraction", default=0.24)
    ldf2 = a.get_float("ldf2", default=1.1)
    entropy_lo = a.get_float("entropy", default=0.67)
    entropy2 = a.get_float("entropy2", default=0.2)
    quality = a.get_float("quality", default=12.5)
    quality2 = a.get_float("quality2", default=7.5)
    polymers = (a.get("polymers", default="G") or "G").upper()
    minpolymer = a.get_int("minpolymer", default=20)
    minpolymer2 = a.get_int("minpolymer2", default=29)
    purity = a.get_float("purity", default=0.85)
    extra = a.get("extra")

    symbol_codes = [b"ACGT".index(c.encode()) for c in polymers if c in "ACGT"]

    depth_on = ldf <= 1.0 or ldf2 <= 1.0
    cms = None
    if depth_on and extra:
        cms = CountMinSketch(hashes=a.get_int("hashes", default=2), device=device)
        for path in extra.split(","):
            for b in FastqReader(path):
                flat, _ = read_keys_t(b.bases, b.lengths, k, device)
                if len(flat):
                    cms.add(flat)
    ent_model = EntropyModel()

    w1 = FastqWriter(out1) if out1 else None
    w2 = FastqWriter(out2) if out2 else None
    wb = FastqWriter(outb) if outb else None
    kept = removed = 0

    def judge(batch) -> np.ndarray:
        """bool [n]: True = discard."""
        n = batch.n
        ent = ent_model.average_entropy_batch(batch.bases, batch.lengths)
        if batch.quals is not None:
            vm = batch.valid_mask()
            avgq = (batch.quals * vm).sum(1) / np.maximum(batch.lengths, 1)
        else:
            avgq = np.full(n, 41.0)
        ldfrac = np.zeros(n)
        if cms is not None:
            flat, nk = read_keys_t(batch.bases, batch.lengths, k, device)
            if len(flat):
                # a read's share of low-depth k-mers: its integer count
                # over its k-mers, in float64, as numpy's mean of bools
                low = np.bincount(np.repeat(np.arange(n), nk),
                                  weights=cms.query(flat) < mincount, minlength=n)
                ldfrac = np.where(nk > 0, low / np.maximum(nk, 1), 0.0)
        poly = np.zeros(n, dtype=np.int64)
        for i in range(n):
            L = int(batch.lengths[i])
            poly[i] = max(
                (_max_pure_run(batch.bases[i], L, s, purity)
                 for s in symbol_codes),
                default=0,
            )
        hard = (
            (ldfrac >= ldf2) | (ent < entropy2) | (avgq < quality2)
            | (poly >= minpolymer2)
        )
        soft = (poly >= minpolymer) & (
            (ldfrac >= ldf) | (ent < entropy_lo) | (avgq < quality)
        )
        return hard | soft

    if in2:
        stream = paired_reader(in1, in2)
        for b1, b2 in stream:
            bad = judge(b1) | judge(b2)
            good = ~bad
            if w2 is not None:
                w1.add(b1, good)
                w2.add(b2, good)
            elif w1 is not None:
                w1.add(interleave(b1, b2), np.repeat(good, 2))
            if wb:
                wb.add(interleave(b1, b2), np.repeat(bad, 2))
            kept += int(good.sum())
            removed += int(bad.sum())
    else:
        for b in FastqReader(in1):
            bad = judge(b)
            good = ~bad
            if w1:
                w1.add(b, good)
            if wb:
                wb.add(b, bad)
            kept += int(good.sum())
            removed += int(bad.sum())
    for w in (w1, w2, wb):
        if w:
            w.close()
    print(f"Kept {kept} reads; removed {removed}.", file=sys.stderr)
    return kept, removed


if __name__ == "__main__":
    main()
