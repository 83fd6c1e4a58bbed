"""BBNorm — depth normalization via approximate k-mer counts
(jgi/KmerNormalize.java:54 over bloom/KCountArray7MTA).

The PyTorch port of bbtools_tpu/models/bbnorm.py. One normalization
round = count pass (the count-min sketch on the run's device, `device=`,
cuda by default) + keep pass: each read's depth is the `depthpercentile`
(default 0.54) percentile of its k-mer counts, kept with probability
target/depth above the target (plus the mindepth discard). Deterministic
given the seed: the keep draws are numpy's on the host, so the kept
reads are the JAX package's.

The depths are taken on the device: one sketch query of the batch's
k-mers, then a row sort of the counts with the invalid windows sorted
last, and the element at the percentile's index picked per read
(`read_depths`); only the [B] depths come to the host.

`passes=2` reproduces the reference's two-round loop (:239): round 1
normalizes to an intermediate target (4x final) into a temp stream, and
round 2 recounts THAT output and normalizes to the final target — the
recount sharpens depth estimates because the high-abundance tail no
longer swamps the sketch. `ecc=t` (and the `ecc` tool) correct reads
with kmernorm_ecc.NormEccEngine, host code that queries the sketch on
the device.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fastq import FastqReader, FastqWriter
from ..ops.cms import CountMinSketch
from ..ops.kmer_count import PAD, batch_keys

_NO_COUNT = torch.iinfo(torch.int64).max


def read_depths(cms, bases, lengths, k: int, percentile: float):
    """Per-read depth estimate: percentile of its kmer counts (int64 [B]
    on the host, 0 for a read with no valid k-mer)."""
    if cms.device.type == "cuda":
        read_depths.device_calls += 1
    B, L = bases.shape
    keys = batch_keys(bases, lengths, k, cms.device).reshape(B, L)
    valid = keys != int(PAD)
    counts = torch.where(valid, cms.query_t(keys.reshape(-1)).reshape(B, L).to(torch.int64),
                         _NO_COUNT)
    srt = torch.sort(counts, dim=1).values
    n = valid.sum(dim=1)
    pick = torch.minimum((n.to(torch.float64) * percentile).floor().to(torch.int64), n - 1)
    depth = srt.gather(1, pick.clamp(min=0)[:, None])[:, 0]
    return torch.where(n > 0, depth, 0).cpu().numpy()


#: calls with the sketch on CUDA since the count was last set to 0
read_depths.device_calls = 0


def _normalize_round(in1, out1, outt, k, target, mindepth, percentile,
                     hashes, seed, device, ecc=False, keepall=False):
    cms = CountMinSketch(hashes=hashes, device=device)
    # pass 1: count
    for b in FastqReader(in1):
        keys = batch_keys(b.bases, b.lengths, k, cms.device)
        cms.add(keys[keys != int(PAD)])
    # pass 2: (optionally correct, KmerNormalize.java:3303 ecc hook) +
    # normalize
    ecc_engine = None
    errors_corrected = 0
    if ecc:
        from .kmernorm_ecc import NormEccEngine

        ecc_engine = NormEccEngine(cms, k)
    rng = np.random.default_rng(seed)
    w = FastqWriter(out1) if out1 else None
    wt = FastqWriter(outt) if outt else None
    kept = tossed = total = 0
    reader = FastqReader(in1)
    for b in reader:
        if ecc_engine is not None:
            nc = ecc_engine.correct_batch(b.bases, b.lengths, b.quals)
            errors_corrected += int(nc.sum())
            if (nc > 0).any():
                # re-emit corrected bases (ascii cache is stale)
                b.ascii_bases = None
        if keepall:
            keep = np.ones(b.n, bool)
        else:
            depths = read_depths(
                cms, b.bases, b.lengths.astype(np.int64), k, percentile
            )
            keep_prob = np.where(
                depths <= target, 1.0, target / np.maximum(depths, 1)
            )
            keep = (rng.random(b.n) < keep_prob) & (depths >= mindepth)
        total += b.n
        kept += int(keep.sum())
        tossed += int((~keep).sum())
        if w:
            w.add(b, keep)
        if wt:
            wt.add(b, ~keep)
    for x in (w, wt):
        if x:
            x.close()
    return total, kept, tossed, errors_corrected


def main(argv=None, ecc_tool=False):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    outt = a.get("outt", "outtoss")
    k = a.get_int("k", default=31)
    target = a.get_int("target", default=100)
    mindepth = a.get_int("mindepth", "min", default=5)
    percentile = a.get_float("depthpercentile", "dp", default=0.54)
    hashes = a.get_int("hashes", default=3)
    seed = a.get_int("seed", default=1)
    passes = a.get_int("passes", default=1)
    ecc = a.get_bool("ecc", default=ecc_tool)
    # ecc.sh = KmerNormalize with ecc=t keepall=t passes=1
    keepall = a.get_bool("keepall", default=ecc_tool)
    device = resolve_device(a.get("device", default="cuda"))
    if keepall:
        passes = 1
    t0 = time.time()
    errors_corrected = 0
    if passes >= 2 and out1:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="bbnorm_") as td:
            mid = f"{td}/pass1.fq"
            t1 = max(target * 4, target + 20)
            # reference corrects on pass 1 only (ecc1; :425)
            _, _, _, ec1 = _normalize_round(
                in1, mid, None, k, t1, mindepth, percentile, hashes, seed,
                device, ecc=ecc,
            )
            total, kept, tossed, _ = _normalize_round(
                mid, out1, outt, k, target, mindepth, percentile, hashes,
                seed + 1, device,
            )
            errors_corrected = ec1
    else:
        total, kept, tossed, errors_corrected = _normalize_round(
            in1, out1, outt, k, target, mindepth, percentile, hashes, seed,
            device, ecc=ecc, keepall=keepall,
        )
    print(f"Reads In:            \t{total}", file=sys.stderr)
    print(
        f"Reads Out:           \t{kept} ({100.0*kept/max(total,1):.2f}%)",
        file=sys.stderr,
    )
    if ecc:
        print(f"Errors Corrected:    \t{errors_corrected}", file=sys.stderr)
    print(f"Time:                \t{time.time()-t0:.3f} seconds.", file=sys.stderr)
    return kept, tossed


if __name__ == "__main__":
    main()
