"""BBCMS — error correction / depth filtering via a count-min sketch
(bbcms.sh -> bloom/BloomFilterCorrectorWrapper.java over BloomFilter +
BloomFilterCorrector).

The PyTorch port of bbtools_tpu/models/bbcms.py. Flow (wrapper
semantics): count all input k-mers into the memory-bounded sketch on the
device (`device=`, cuda by default; ops/cms.py), then stream reads back
through the corrector and optional depth filters:
  ecc=t       pincer+tail correction (tadpole_ecc.EccEngine over
              CMSTable; host code, each count a query on the device)
  mincount=N  discard reads whose fraction of k-mers with count >= N is
              under hcf= (one device query per batch)
  hcf=F       high-count fraction needed to keep
  tossjunk=t  discard reads whose median k-mer depth is under 1
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fastq import FastqReader, FastqWriter, paired_reader
from ..ops.cms import CMSTable, CountMinSketch
from ..ops.kmer_count import PAD, batch_keys


def _count_pass(paths, k, hashes, cells, device):
    cms = CountMinSketch(cells_per_hash=cells, hashes=hashes, device=device)
    reads = 0
    for path in paths:
        r = FastqReader(path)
        for b in r:
            keys = batch_keys(b.bases, b.lengths, k, cms.device)
            cms.add(keys[keys != int(PAD)])
        reads += r.reads_in
    return cms, reads


def _read_depth_stats(cms, bases, lengths, k):
    """(median depth, counts, valid) per read: one device query of the
    batch's k-mers."""
    B, L = bases.shape
    keys = batch_keys(bases, lengths, k, cms.device)
    valid_t = keys != int(PAD)
    counts_t = torch.where(valid_t, cms.query_t(keys).to(torch.int64), 0)
    counts = counts_t.cpu().numpy().reshape(B, L)
    valid = valid_t.cpu().numpy().reshape(B, L)
    med = np.zeros(B, np.int64)
    for i in range(B):
        c = counts[i][valid[i]]
        if len(c):
            med[i] = np.median(c)
    return med, counts, valid


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    in2 = a.get("in2")
    out1 = a.get("out", "out1")
    out2 = a.get("out2")
    outb = a.get("outb", "outbad", "outlow")
    k = a.get_int("k", default=31)
    ecc = a.get_bool("ecc", default=True)
    mincount = a.get_int("mincount", default=0)
    hcf = a.get_float("hcf", "highcountfraction", default=1.0)
    hashes = a.get_int("hashes", default=3)
    cells = a.get_int("cells", "bits", default=1 << 22)
    if cells & (cells - 1):
        cells = 1 << int(cells - 1).bit_length()
    tossjunk = a.get_bool("tossjunk", default=False)
    device = resolve_device(a.get("device", default="cuda"))
    t0 = time.time()
    paths = [p for p in (in1, in2) if p]
    cms, reads_in = _count_pass(paths, k, hashes, cells, device)
    table = CMSTable(cms, k)
    ecc_engine = None
    if ecc:
        from .tadpole_ecc import EccConfig, EccEngine

        ecc_engine = EccEngine(table, k, EccConfig())
    w1 = FastqWriter(out1) if out1 else None
    w2 = FastqWriter(out2) if out2 else None
    wb = FastqWriter(outb) if outb else None
    kept = tossed = 0
    errors = 0
    for b1, b2 in paired_reader(in1, in2):
        sides = [b1] + ([b2] if b2 is not None else [])
        keep = np.ones(b1.n, bool)
        for b in sides:
            if ecc_engine is not None:
                nc = ecc_engine.correct_batch(b.bases, b.lengths, b.quals)
                errors += int(nc.sum())
                if (nc > 0).any():
                    b.ascii_bases = None
            if mincount > 0 or tossjunk:
                med, counts, valid = _read_depth_stats(
                    cms, b.bases, b.lengths, k
                )
                if mincount > 0:
                    nk = valid.sum(axis=1)
                    ok_frac = np.where(
                        nk > 0,
                        (counts >= mincount).sum(axis=1) / np.maximum(nk, 1),
                        0.0,
                    )
                    keep &= ok_frac >= hcf
                if tossjunk:
                    keep &= med >= 1
        kept += int(keep.sum())
        tossed += int((~keep).sum())
        if w1:
            w1.add(b1, keep)
        if w2 and b2 is not None:
            w2.add(b2, keep)
        if wb:
            wb.add(b1, ~keep)
    for w in (w1, w2, wb):
        if w:
            w.close()
    el = time.time() - t0
    print(f"Reads In:           \t{reads_in}", file=sys.stderr)
    print(f"Reads Out:          \t{kept}", file=sys.stderr)
    if ecc:
        print(f"Errors Corrected:   \t{errors}", file=sys.stderr)
    print(f"Time:               \t{el:.3f} seconds.", file=sys.stderr)
    return kept, tossed, errors


if __name__ == "__main__":
    main()
