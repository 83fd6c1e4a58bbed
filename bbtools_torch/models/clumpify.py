"""Clumpify — k-mer-pivot read sorting for compression/locality
(clump/Clumpify.java:28, KmerComparator.java:23).

Reads sharing a pivot k-mer (the minimizer of hashed k-mers) sort
adjacently, which dramatically improves gzip ratios and enables optical/
PCR-duplicate marking. The PyTorch port of bbtools_tpu/models/clumpify.py:
pivot hashing is a batched reduction on the run's device (`device=`,
cuda by default; min over hashed window k-mers, on int64 bits: logical
shifts, `mix64_t`, the sign bit flipped for the unsigned min); the
ordering, the writers, optical and paired dedupe are host code, copied.
Optional dedupe=t removes exact duplicates within a clump.

`groups=N` enables the reference's EXTERNAL 2-pass shuffle
(Clumpify.java:88-97, KmerSplit -> KmerSort): pass 1 streams reads into N
temp partitions by pivot hash (memory = one batch), pass 2 sorts each
partition independently and concatenates — pivot-partitioning makes the
concatenation globally clump-ordered without a global sort.
"""

from __future__ import annotations

import sys
import time

import numpy as np

import torch

from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fastq import FastqReader, encode_fastq
from ..io.readwrite import open_output
from ..ops.kmer_index import _as_int64, _mix64, mix64_t
from ..ops.kmers import rolling_kmers, rolling_kmers_np

#: the sign bit of an int64
_SIGN = _as_int64(1 << 63)


def pivot_kmers(bases: np.ndarray, lengths: np.ndarray, k: int,
                device: torch.device):
    """Per-read pivot: the minimum 64-bit-hashed canonical k-mer.

    Torch path on `device` (rolling registers + mix + min-reduce) for
    real batches (B*L >= 2^16); numpy for tiny ones where dispatch
    overhead dominates, as in the JAX package. Both produce identical
    (pivot, position) pairs."""
    if bases.shape[0] * bases.shape[1] >= 1 << 16:
        piv, pos = _pivot_kmers_t(
            torch.from_numpy(np.ascontiguousarray(bases)).to(device),
            torch.from_numpy(np.asarray(lengths)).to(device), k)
        return piv.cpu().numpy().view(np.uint64), pos.cpu().numpy()
    return _pivot_kmers_np(bases, lengths, k)


def _pivot_kmers_np(bases, lengths, k: int):
    fwd, rkm, runlen = rolling_kmers_np(bases, k)
    valid = (runlen >= k) & (
        np.arange(bases.shape[1])[None, :] < lengths[:, None]
    )
    keys = np.maximum(fwd, rkm)
    h = _mix64(keys.astype(np.uint64))
    h = np.where(valid, h, np.uint64(0xFFFFFFFFFFFFFFFF))
    piv = h.min(axis=1)
    pos = h.argmin(axis=1)
    return piv, pos


def _pivot_kmers_t(bases: torch.Tensor, lengths: torch.Tensor, k: int):
    """(pivot int64 [B] holding the uint64 bits, position int64 [B]) of
    each read: the unsigned min of splitmix64 over its canonical k-mers,
    invalid windows all bits set, and the first position of it. torch
    has no unsigned 64-bit order: the min is taken on the bits with the
    sign bit flipped, which orders as unsigned."""
    if bases.device.type == "cuda":
        _pivot_kmers_t.device_calls += 1
    fwd, rkm, runlen = rolling_kmers(bases, k)
    valid = (runlen >= k) & (
        torch.arange(bases.shape[1], device=bases.device)[None, :] < lengths[:, None]
    )
    h = torch.where(valid, mix64_t(torch.maximum(fwd, rkm)), -1)
    ordered = h ^ _SIGN
    low = ordered.amin(dim=1)
    iota = torch.arange(h.shape[1], device=h.device)[None, :]
    pos = torch.where(ordered == low[:, None], iota, h.shape[1]).amin(dim=1)
    return low ^ _SIGN, pos


#: calls on CUDA tensors since the count was last set to 0
_pivot_kmers_t.device_calls = 0


def _coords(name: bytes):
    """(lane, tile, x, y) from an Illumina header, or None."""
    parts = name.split(b" ")[0].split(b":")
    if len(parts) >= 7:
        try:
            return (int(parts[3]), int(parts[4]), int(parts[5]),
                    int(parts[6]))
        except ValueError:
            return None
    return None


def _sort_and_write(records, fh, dedupe: bool, optical: bool = False,
                    dupedist: int = 40) -> int:
    """KmerComparator order: (pivot, position-in-read desc, sequence).

    optical=t restricts duplicate removal to reads whose flowcell
    coordinates are within `dupedist` on the same lane+tile (Clumpify's
    optical-duplicate mode, clump/Clump.java dist semantics)."""
    records.sort(key=lambda r: (r[0], -r[1], r[3]))
    dupes = 0
    prev_seq = None
    run = []  # coords of kept copies of the current identical sequence
    for piv, pos, name, seq, qual in records:
        if dedupe and seq == prev_seq:
            if not optical:
                dupes += 1
                continue
            c = _coords(name)
            near = c is not None and any(
                k is not None
                and k[0] == c[0]
                and k[1] == c[1]
                and (k[2] - c[2]) ** 2 + (k[3] - c[3]) ** 2
                <= dupedist * dupedist
                for k in run
            )
            if near:
                dupes += 1
                continue
        else:
            run = []
        fh.write(b"@%s\n%s\n+\n%s\n" % (name, seq, qual))
        prev_seq = seq
        run.append(_coords(name))
    return dupes


def _sort_and_write_paired(records, fh1, fh2, dedupe: bool,
                           optical: bool = False,
                           dupedist: int = 40) -> int:
    """Paired clump order: PAIRS sort by read-1's pivot and a duplicate
    requires BOTH mates to match the previous pair (Clumpify's paired
    mode, clump/Clump.java pair semantics)."""
    records.sort(key=lambda r: (r[0], -r[1], r[3], r[6]))
    dupes = 0
    prev = (None, None)
    run = []
    for piv, pos, n1, s1, q1, n2, s2, q2 in records:
        if dedupe and (s1, s2) == prev:
            if not optical:
                dupes += 2
                continue
            c = _coords(n1)
            near = c is not None and any(
                kk is not None and kk[0] == c[0] and kk[1] == c[1]
                and (kk[2] - c[2]) ** 2 + (kk[3] - c[3]) ** 2
                <= dupedist * dupedist
                for kk in run
            )
            if near:
                dupes += 2
                continue
        else:
            run = []
        fh1.write(b"@%s\n%s\n+\n%s\n" % (n1, s1, q1))
        fh2.write(b"@%s\n%s\n+\n%s\n" % (n2, s2, q2))
        prev = (s1, s2)
        run.append(_coords(n1))
    return dupes


def main(argv=None):
    import os
    import tempfile

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    in2 = a.get("in2")
    out1 = a.get("out", "out1")
    out2 = a.get("out2")
    k = a.get_int("k", default=31)
    dedupe = a.get_bool("dedupe", default=False)
    optical = a.get_bool("optical", "opticalonly", default=False)
    dupedist = a.get_int("dupedist", "dist", default=40)
    groups = a.get_int("groups", "g", default=1)
    device = resolve_device(a.get("device", default="cuda"))
    t0 = time.time()
    dupes = 0
    n = 0
    reader = FastqReader(in1)
    if in2:
        # paired: pairs travel together, keyed on read 1's pivot
        records = []
        it2 = iter(FastqReader(in2))
        for b in reader:
            b2 = next(it2)
            piv, pos = pivot_kmers(b.bases, b.lengths.astype(np.int64), k, device)
            for i in range(b.n):
                records.append(
                    (int(piv[i]), int(pos[i]), b.ids[i], b.sequence(i),
                     b.quality_string(i), b2.ids[i], b2.sequence(i),
                     b2.quality_string(i))
                )
        n = 2 * len(records)
        with open_output(out1) as f1, open_output(out2) as f2:
            dupes = _sort_and_write_paired(
                records, f1, f2, dedupe, optical, dupedist
            )
    elif groups <= 1:
        records = []  # (pivot, pos, name, seq, qual)
        for b in reader:
            piv, pos = pivot_kmers(b.bases, b.lengths.astype(np.int64), k, device)
            for i in range(b.n):
                records.append(
                    (int(piv[i]), int(pos[i]), b.ids[i], b.sequence(i),
                     b.quality_string(i))
                )
        n = len(records)
        with open_output(out1) as fh:
            dupes = _sort_and_write(records, fh, dedupe, optical, dupedist)
    else:
        # pass 1 (KmerSplit): partition by pivot into temp files. The
        # partition key uses the TOP bits so groups are pivot-ordered and
        # per-group sorted outputs concatenate into a global clump order.
        with tempfile.TemporaryDirectory(prefix="clumpify_") as td:
            parts = [
                open(os.path.join(td, f"g{g}.fq"), "wb")
                for g in range(groups)
            ]
            for b in reader:
                piv, pos = pivot_kmers(b.bases, b.lengths.astype(np.int64), k, device)
                gid = (piv.astype(np.uint64) >> np.uint64(64 - 16)).astype(
                    np.int64
                ) * groups // (1 << 16)
                for g in range(groups):
                    rows = np.flatnonzero(gid == g)
                    if len(rows):
                        parts[g].write(encode_fastq(b, gid == g))
                n += b.n
            for fh in parts:
                fh.close()
            # pass 2 (KmerSort): sort each partition independently
            with open_output(out1) as fh:
                for g in range(groups):
                    records = []
                    for b in FastqReader(os.path.join(td, f"g{g}.fq")):
                        piv, pos = pivot_kmers(
                            b.bases, b.lengths.astype(np.int64), k, device
                        )
                        for i in range(b.n):
                            records.append(
                                (int(piv[i]), int(pos[i]), b.ids[i],
                                 b.sequence(i), b.quality_string(i))
                            )
                    dupes += _sort_and_write(
                        records, fh, dedupe, optical, dupedist
                    )
    print(f"Reads:               \t{n}", file=sys.stderr)
    if dedupe:
        print(f"Duplicates removed:  \t{dupes}", file=sys.stderr)
    print(f"Time:                \t{time.time()-t0:.3f} seconds.", file=sys.stderr)
    return n, dupes


if __name__ == "__main__":
    main()
