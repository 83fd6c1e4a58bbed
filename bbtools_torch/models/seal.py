"""Seal — multi-reference k-mer quantification/binning (jgi/Seal.java:59).

The PyTorch port of bbtools_tpu/models/seal.py. BBDuk with
per-REFERENCE values. Seal k-mers are MULTI-VALUED: a k-mer shared by
several references credits all of them (Seal.java keeps id lists per
kmer). The per-kmer value is an int32 COMBO id into a distinct-bitset
table (W x 62-bit words per row, OR-merged at build), so the one-gather
bucket lookup (`kscan_full`) serves any number of reference files. On
the run's device (`device=`, cuda by default) a batch's votes are one
gather of the combo table's word per position and a bit test per
reference; the read's best reference is picked there too, and only the
per-read verdicts come back to the host. Reads are attributed per
`ambig=` (first | all | toss | best; Seal.java:280-291). Outputs
per-ref read/base counts (refstats format) and optional per-ref FASTQs
(pattern out=%.fq).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..core.dna import encode
from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fasta import iter_fasta
from ..io.fastq import FastqReader, FastqWriter
from ..ops.bbduk_scan import KScanConfig, kscan_full
from ..ops.kmer_index import BucketKmerIndex, build_ref_keys


def seal_votes(combo_table: torch.Tensor, ids: torch.Tensor, nref: int) -> torch.Tensor:
    """[nref + 1, B] int64 votes: row rid counts the positions of each
    read whose combo id (ids [B, L], 0 = miss) holds reference rid's bit
    (row 0 stays 0). combo_table [C, W] int64 on ids' device."""
    if ids.device.type == "cuda":
        seal_votes.device_calls += 1
    B = ids.shape[0]
    votes = torch.zeros((nref + 1, B), dtype=torch.int64, device=ids.device)
    ids = ids.to(torch.int64)
    for w in range((nref + 61) // 62):
        word = combo_table[:, w][ids]  # [B, L]: one gather per word
        for bit in range(min(62, nref - 62 * w)):
            votes[62 * w + bit + 1] = ((word >> bit) & 1).sum(dim=1)
    return votes


#: calls on CUDA tensors since the count was last set to 0
seal_votes.device_calls = 0


def seal_best(votes: torch.Tensor, mkh: int, toss: bool) -> torch.Tensor:
    """[B] int64 reference of each read: the lowest rid of most votes
    (AMBIG_FIRST), 0 under minkmerhits; with toss, 0 where the top is
    shared."""
    per_ref = votes[1:]
    best_votes = per_ref.amax(dim=0)
    rid = torch.arange(1, per_ref.shape[0] + 1, device=votes.device)[:, None]
    first = torch.where(per_ref == best_votes[None, :], rid, per_ref.shape[0] + 1).amin(dim=0)
    best = torch.where(best_votes >= mkh, first, 0)
    if toss:
        n_top = (per_ref == best_votes[None, :]).sum(dim=0)
        best = torch.where((n_top > 1) & (best > 0), 0, best)
    return best


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    refs = a.get_list("ref")
    out_pattern = a.get("pattern", "basename")
    stats = a.get("stats", "refstats")
    k = a.get_int("k", default=31)
    mkh = a.get_int("minkmerhits", "mkh", default=1)
    ambig = (a.get("ambiguous", "ambig") or "first").lower()
    device = resolve_device(a.get("device", default="cuda"))
    t0 = time.time()
    # one id per REFERENCE FILE (Seal's ref-level attribution); scaffolds
    # within a file share the id. Bitsets are W x 62-bit words; the
    # bucket index stores an int32 COMBO id into the distinct-bitset
    # table, so any number of reference files works (the sharing combos
    # are few even when refs are many).
    nref = len(refs)
    W = max(1, (nref + 61) // 62)
    all_keys = []
    all_rid = []
    names = []
    for rid, path in enumerate(refs, start=1):
        names.append(path.encode())
        scaffolds = [encode(rec.seq) for rec in iter_fasta(path)]
        rk, _ = build_ref_keys(scaffolds, k)
        # dedup inside one ref (same bit): harmless but shrinks the sort
        rk = np.unique(rk)
        all_keys.append(rk)
        all_rid.append(np.full(len(rk), rid, dtype=np.int64))
    keys = np.concatenate(all_keys)
    rids = np.concatenate(all_rid)
    order = np.argsort(keys, kind="stable")
    sk, sr = keys[order], rids[order]
    group_start = np.flatnonzero(
        np.concatenate([[True], sk[1:] != sk[:-1]])
    )
    rows = np.zeros((len(group_start), W), np.int64)
    for w in range(W):
        word_mask = np.where(
            (sr - 1) // 62 == w, np.int64(1) << ((sr - 1) % 62), np.int64(0)
        )
        rows[:, w] = np.bitwise_or.reduceat(word_mask, group_start)
    combos, inverse = np.unique(rows, axis=0, return_inverse=True)
    # combo id 0 = miss: prepend a zero row
    combo_table = np.vstack([np.zeros((1, W), np.int64), combos])
    idx = BucketKmerIndex.build(
        sk[group_start], (inverse + 1).astype(np.int32)
    )
    cfg = KScanConfig(k=k, nb=idx.nb)
    table = idx.device_arrays(device)
    combo_t = torch.from_numpy(combo_table).to(device)
    read_counts = np.zeros(nref + 1, dtype=np.int64)
    base_counts = np.zeros(nref + 1, dtype=np.int64)
    writers = {}
    reader = FastqReader(in1)
    for b in reader:
        out = kscan_full(cfg, table, torch.from_numpy(b.bases).to(device),
                         torch.from_numpy(b.lengths).to(device))
        votes_t = seal_votes(combo_t, out["ids"], nref)
        best = seal_best(votes_t, mkh, ambig == "toss").cpu().numpy()
        np.add.at(read_counts, best, 1)
        np.add.at(base_counts, best, b.lengths.astype(np.int64))
        credit = (votes_t[1:] >= mkh).cpu().numpy() if ambig == "all" else None
        if out_pattern:
            for rid in range(1, nref + 1):
                keep = (
                    credit[rid - 1] if credit is not None else best == rid
                )
                if not keep.any():
                    continue
                if rid not in writers:
                    stem = refs[rid - 1].rsplit("/", 1)[-1].split(".")[0]
                    writers[rid] = FastqWriter(out_pattern.replace("%", stem))
                writers[rid].add(b, keep)
    for w in writers.values():
        w.close()
    if stats:
        with open(stats, "w") as fh:
            fh.write("#name\treads\tbases\n")
            for rid in range(1, nref + 1):
                fh.write(
                    f"{refs[rid-1]}\t{read_counts[rid]}\t{base_counts[rid]}\n"
                )
            fh.write(f"*unmatched*\t{read_counts[0]}\t{base_counts[0]}\n")
    print(f"Reads:               \t{reader.reads_in}", file=sys.stderr)
    for rid in range(1, nref + 1):
        print(f"  {refs[rid-1]}:\t{read_counts[rid]} reads", file=sys.stderr)
    print(f"Unmatched:           \t{read_counts[0]} reads", file=sys.stderr)
    print(f"Time:                \t{time.time()-t0:.3f} seconds.", file=sys.stderr)
    return read_counts


if __name__ == "__main__":
    main()
