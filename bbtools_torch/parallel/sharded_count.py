"""Multi-device k-mer counting, alignment scoring, insert scan, fill and
matcher steps.

The counterpart of bbtools_tpu/parallel/sharded_count.py. Each step cuts
its inputs into one slab per dp row of the mesh (and, for the seed index
and the matcher, its table into one slab per tp column), launches every
slab on its device through the single-device function or kernel wrapper,
and only then combines on the mesh's first device:

- `sharded_count_step`: each slab's canonical k-mers sort-reduced
  (ops/kmer_count.py), the runs stacked on dp and the clamped count
  histograms summed;
- `sharded_ungapped_score_step`: BBMap's ungapped scoring per slab;
- `sharded_overlap_step`: BBMerge's insert scan per slab (the B5 kernel,
  csrc/overlap_scan.cu, on the card);
- `shard_seed_index` (the JAX package's host build, copied) and
  `sharded_seed_expand_step`: the CSR seed index cut by key % tp, each
  shard expanding the query keys it owns;
- `make_sharded_fill_walk`: BBMap's fill and walk per slab, in the plane
  budget's groups (the B4 kernels, csrc/msa_fill.cu, on the card);
- `sharded_mm_lookup_step`: the one-hot matcher with its columns cut over
  tp; each column slab gives each query's best priority word undecoded
  (`mm_best`, a mode of the B3 kernel, csrc/mm_match.cu) and a min over
  the slabs is the first-inserted winner, then decoded.

Every output equals the single-device call's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kmer_count import batch_kmers, sort_reduce
from ..ops.mm_match import BIG32, mm_best, mm_decode_best
from ..ops.msa_fill import fill_walk
from ..ops.overlap_scan import overlap_counts
from ..ops.score_ungapped import score_no_indels
from .mesh import Mesh, slabs


def _dp_slabs(mesh: Mesh, n: int):
    """(device, rows) of each dp slab of n rows."""
    return [(mesh.row(d), sl) for d, sl in enumerate(slabs(n, mesh.shape["dp"]))]


def _cat(mesh: Mesh, parts):
    return torch.cat([p.to(mesh.row(0)) for p in parts])


def sharded_count_step(mesh: Mesh, k: int):
    """fn(bases [B, L] uint8, lengths [B] int) -> (values [dp, n] int64,
    counts [dp, n] int64, n_runs [dp] int64, hist [64] int64): each dp
    slab's sort-reduced runs, stacked (feed each row to
    KmerSpectrum.add_batch), and the dp sum of the slabs' histograms of
    their run counts clamped to 63. B divides by dp."""

    def step(bases, lengths):
        parts = []
        for dev, sl in _dp_slabs(mesh, bases.shape[0]):
            values, counts, n_runs = sort_reduce(
                batch_kmers(bases[sl].to(dev), lengths[sl].to(dev), k))
            bins = torch.arange(64, dtype=torch.int64, device=dev)[:, None]
            hist = ((counts.clamp(max=63)[None, :] == bins)
                    & (counts > 0)[None, :]).sum(dim=1)
            parts.append((values, counts, n_runs, hist))
        dev0 = mesh.row(0)
        hist = parts[0][3].to(dev0)
        for p in parts[1:]:
            hist = hist + p[3].to(dev0)
        return (torch.stack([p[0].to(dev0) for p in parts]),
                torch.stack([p[1].to(dev0) for p in parts]),
                torch.stack([p[2].to(dev0) for p in parts]), hist)

    return step


def sharded_ungapped_score_step(mesh: Mesh, L: int, W: int):
    """fn(reads [T, L] uint8, lens [T] int32, refs [T, W] uint8, starts [T]
    int32) -> scores [T] int32, tasks sharded on dp (T divides by dp)."""

    def step(reads, lens, refs, starts):
        parts = []
        for dev, sl in _dp_slabs(mesh, reads.shape[0]):
            widths = torch.full((sl.stop - sl.start,), W, dtype=torch.int32, device=dev)
            parts.append(score_no_indels(L, reads[sl].to(dev), lens[sl].to(dev),
                                         refs[sl].to(dev), starts[sl].to(dev), widths))
        return _cat(mesh, parts)

    return step


def sharded_overlap_step(mesh: Mesh, m0: int, ni: int):
    """fn(a [B, L] uint8, b_rc [B, L] uint8, alens [B] int32, blens [B]
    int32) -> (good, bad, olen) int32 [B, ni]: the BBMerge insert scan
    (ops/overlap_scan.py `overlap_counts`) dp-sharded over pairs. Pairs
    are independent, so the slabs need no combine but their
    concatenation. B divides by dp."""

    def step(a, b_rc, alens, blens):
        parts = []
        for dev, sl in _dp_slabs(mesh, a.shape[0]):
            parts.append(overlap_counts(
                a[sl].to(dev).contiguous(), b_rc[sl].to(dev).contiguous(),
                alens[sl].to(dev, torch.int32).contiguous(),
                blens[sl].to(dev, torch.int32).contiguous(), m0, ni))
        return tuple(_cat(mesh, [p[i] for p in parts]) for i in range(3))

    return step


def shard_seed_index(starts: np.ndarray, sites: np.ndarray, n_shards: int,
                     max_hits: int):
    """Reference-block sharding of the BBMap CSR seed index: shard s owns
    keys with key % n_shards == s. Each shard's table is re-laid out as a
    FIXED-WIDTH [n_keys_local, max_hits] site matrix (pad -1) so the
    device lookup is a single row gather — the CSR's variable-length rows
    don't shard onto fixed-shape devices, the padded layout does.
    Returns (tables [S, nk_local, max_hits] int32, n_shards)."""
    import numpy as _np

    nk = len(starts) - 1
    nk_local = (nk + n_shards - 1) // n_shards
    tables = _np.full((n_shards, nk_local, max_hits), -1, _np.int32)
    counts = _np.diff(starts)
    for s in range(n_shards):
        keys = _np.arange(s, nk, n_shards)
        for li, key in enumerate(keys):
            c = min(int(counts[key]), max_hits)
            if c:
                tables[s, li, :c] = sites[starts[key] : starts[key] + c]
    return tables


def sharded_seed_expand_step(mesh: Mesh, n_shards: int):
    """fn(keys [B, K] int, tables [S, nk_local, M] int32) -> sites [S, B,
    K, M] int32 (pad -1): tp shard s, on the first dp row's device of its
    column, expands the query keys it owns (key % S == s) from its table;
    the results stack on the shard axis (the reference-block parallel
    seed lookup, the kmer/KmerTableSet WAYS layout over the CSR)."""
    if mesh.shape["tp"] != n_shards:
        raise ValueError(f"{n_shards} shards on a mesh of {mesh.shape['tp']} tp")

    def step(keys, tables):
        parts = []
        for s in range(n_shards):
            dev = mesh.devices[0, s]
            table = tables[s].to(dev)
            q = keys.to(dev)
            local = (q // n_shards).clamp(0, table.shape[0] - 1).long()
            rows = table[local]  # [B, K, M]
            parts.append(torch.where((q % n_shards == s)[:, :, None], rows, -1))
        return torch.stack([p.to(mesh.row(0)) for p in parts])

    return step


def make_sharded_fill_walk(mesh: Mesh, R: int, Cc: int):
    """BBMap's DP stage over the mesh: the unpruned fill with traceback
    planes (fillUnlimited) and the traceback walk, tasks sharded on dp.
    fn(reads [T, R] uint8, lens [T] int32, refs [T, Cc] uint8, host
    arrays) -> (best score, column, state [T] int32, walk ops [T, R+Cc]
    uint8, steps [T] int32) on the mesh's first device; each slab runs
    `ops.msa_fill.fill_walk` on its device, in the plane budget's groups
    of that device. T divides by dp. `fn.fill_calls` holds the fill
    calls of its last call."""

    def step(reads, lens, refs):
        if reads.shape[1] != R or refs.shape[1] != Cc:
            raise ValueError(f"fill_walk over [{R}, {Cc}], not {reads.shape}, {refs.shape}")
        parts = []
        step.fill_calls = 0
        for dev, sl in _dp_slabs(mesh, reads.shape[0]):
            out, n_groups = fill_walk(reads[sl], lens[sl], refs[sl], dev)
            step.fill_calls += n_groups
            parts.append(out)
        ops = [F.pad(p[3], (0, R + Cc - p[3].shape[1])) for p in parts]
        return (*(_cat(mesh, [p[i] for p in parts]) for i in range(3)),
                _cat(mesh, ops), _cat(mesh, [p[4] for p in parts]))

    step.fill_calls = 0
    return step


def sharded_mm_lookup_step(mesh: Mesh, k: int, mink: int, Kp: int):
    """The one-hot matcher (ops/mm_match.py) on the (dp, tp) mesh:
    fn(key_words [Dp, Kp/4] int32, prio [1, Dp] int32, queries [N, ...]
    int64) -> ids int32 like `mm_lookup`. The columns are cut into tp
    slabs (padded first to a multiple of tp with columns that never
    match), column slab s on device (row, s); the queries into dp row
    slabs. Each (row, column) pair gives the best (rank << 16 | id) word
    of its columns (`mm_best`; BIG32 on a miss); their min over tp is the
    first-inserted winner over all columns (the combine the reference's
    WAYS table split resolves with locks, kmer/KmerTableSet.java:273-285),
    then decoded. N divides by dp."""
    n_tp = mesh.shape["tp"]

    def step(key_words, prio, queries):
        key_words, prio = _pad_columns(key_words, prio, k, mink, n_tp)
        Dp = key_words.shape[0]
        cols = slabs(Dp, n_tp)
        placed: dict = {}

        def table(s, dev):
            if (s, dev) not in placed:
                placed[s, dev] = (key_words[cols[s]].to(dev).contiguous(),
                                  prio[:, cols[s]].to(dev).contiguous())
            return placed[s, dev]

        parts = []  # [dp][tp]: every slab launched before the first combine
        for d, sl in enumerate(slabs(queries.shape[0], mesh.shape["dp"])):
            parts.append([])
            for s in range(n_tp):
                dev = mesh.devices[d, s]
                kw, pr = table(s, dev)
                parts[-1].append(mm_best(kw, pr, k, mink, Kp, Dp // n_tp,
                                         queries[sl].to(dev).contiguous()))
        rows = []
        for d, row in enumerate(parts):
            best = row[0].to(mesh.row(d))
            for p in row[1:]:
                best = torch.minimum(best, p.to(mesh.row(d)))
            rows.append(mm_decode_best(best))
        return _cat(mesh, rows)

    return step


def _pad_columns(key_words, prio, k: int, mink: int, n: int):
    """The key words and priorities with pad columns appended up to a
    multiple of n: zero weights but the constant dim's -1, so their score
    is -1 and they never match; priority BIG32 (MMKmerIndex.build's pad
    columns)."""
    Dp, KW = key_words.shape
    extra = (-Dp) % n
    if not extra:
        return key_words, prio
    nc = (k - mink + 1) if mink and mink < k else 1
    const = 4 * k + nc  # the byte of the constant dim
    pad = torch.zeros((extra, 4 * KW), dtype=torch.int8, device=key_words.device)
    pad[:, const] = -1
    pad_prio = torch.full((1, extra), int(BIG32), dtype=torch.int32, device=prio.device)
    return (torch.cat([key_words, pad.view(torch.int32)]),
            torch.cat([prio, pad_prio], dim=1))
