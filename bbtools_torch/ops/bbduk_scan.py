"""Batched BBDuk k-mer scans in torch.

The counterpart of bbtools_tpu/ops/bbduk_scan.py: the reference per-read
loops (bbduk/BBDukProcessorS.java countSetKmers :1534, ktrim :1993 and
the short-kmer Scanning4/Scanning5 loops) as one batched function: [B, L]
base codes in, per-read decisions out, as masked reductions on the
batch's device. The early exit in countSetKmers only affects which hit
credits the scaffold counter, so the batched version computes the hit
count without early exit and separately selects the
(maxBadKmers+1)-th hit's id — identical observable behavior.

Lookups go to the backend the index was built as: the lane table
(kernel csrc/lane_lookup.cu on the GPU), the sorted join (whose cummax is
the kernel csrc/cummax_i64.cu), the one-hot matcher (kernel
csrc/mm_match.cu) or the bucket table (torch gathers), which may be
sharded over a mesh's tp axis (`tp_shards`, parallel/sharded_index.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .kmer_index import BucketKmerIndex
from .kmers import length_mask, rolling_kmers, rolling_kmers_plain
from .lane_index import lane_lookup
from .mm_match import mm_lookup
from .sort_join import join_lookup

BIG = 999999999


@dataclass(frozen=True)
class KScanConfig:
    k: int
    mink: int = 0  # 0 disables short kmers
    minlen2: int = 0  # defaults to k when 0
    mid_mask: int = -1
    restrict_left: int = 0
    restrict_right: int = 0
    qhdist: int = 0
    #: speed=0-16 sampling (BBDukIndexAndLoader.java:997): kmers with
    #: (key & MAX_LONG) % 17 < speed are ignored at scan time (the load
    #: side applies the same test in build_ref_keys)
    speed: int = 0
    qskip: int = 1  # look up every qskip-th query position only
    nb: int = 64  # bucket count of the BucketKmerIndex
    packed: bool = False  # BucketKmerIndex key48|id16 single-plane layout
    rcomp: bool = True
    #: LaneKmerIndex static params (nb, groups, slots, rows, salt, packed);
    #: when set, `table` holds (tlo, thi, tid)
    lane: tuple | None = None
    #: SortJoinIndex static params (n,); when set, `table` holds
    #: (sorted_keys, ids32)
    join: tuple | None = None
    #: MMKmerIndex static params (k, mink, Kp, Dp); when set, `table`
    #: holds (key_words, prio)
    mm: tuple | None = None
    #: >0 when the bucket table is sharded by key % tp_shards over a
    #: mesh's tp axis (parallel/sharded_index.py): `table` then holds each
    #: shard's (keys, ids) on its own device, every shard looks up the
    #: keys it owns, and the sum of the parts is the answer (a miss
    #: contributes 0 and exactly one shard can hit) — the kmer%WAYS
    #: layout of kmer/KmerTableSet.java:273-285
    tp_shards: int = 0

    def resolved_minlen2(self) -> int:
        return self.minlen2 if self.minlen2 > 0 else self.k


def _lookup(cfg: KScanConfig, table, keys):
    if cfg.mm is not None:
        return mm_lookup(*table, *cfg.mm, keys)
    if cfg.join is not None:
        return join_lookup(*table, keys)
    if cfg.lane is not None:
        return lane_lookup(*table, *cfg.lane, keys)
    if cfg.tp_shards > 0:
        return _sharded_lookup(cfg, table, keys)
    keys_tbl, ids_tbl = table
    if cfg.packed:
        return BucketKmerIndex.lookup_packed(keys_tbl, cfg.nb, keys)
    return BucketKmerIndex.lookup(keys_tbl, ids_tbl, cfg.nb, keys)


def _sharded_lookup(cfg: KScanConfig, table, keys):
    """The bucket lookup over the tp shards of `table`: every shard's part
    is launched on its own device before the parts are summed on the
    keys' device."""
    parts = []
    for s, (keys_tbl, ids_tbl) in enumerate(table):
        q = keys.to(keys_tbl.device)
        part = BucketKmerIndex.lookup(keys_tbl, ids_tbl, cfg.nb, q)
        parts.append(torch.where(q % cfg.tp_shards == s, part, 0))
    out = parts[0].to(keys.device)
    for part in parts[1:]:
        out = out + part.to(keys.device)
    return out


def _mutants_lookup_first(cfg: KScanConfig, table, fwd, klen, mm, lmask):
    """Look up ALL 4*klen single-sub mutants of fwd in one batched
    lookup; return (hit_any, first_hit_id) in reference (j-major,
    i-minor) order."""
    muts = []
    differs = []
    for j in range(4):
        for i in range(klen):
            temp = (fwd & ~(3 << (2 * i))) | (j << (2 * i))
            muts.append(temp)
            differs.append(temp != fwd)
    temp_all = torch.stack(muts, dim=-1)  # [..., M] in (j, i) order
    diff_all = torch.stack(differs, dim=-1)
    rtemp_all = _rc(temp_all, klen)
    mx_all = torch.maximum(temp_all, rtemp_all) if cfg.rcomp else temp_all
    keys_all = (mx_all & mm) | lmask
    cand = _lookup(cfg, table, keys_all)
    valid = (cand > 0) & diff_all
    first = torch.argmax(valid.to(torch.int32), dim=-1)  # first hit in (j, i) order
    hit = valid.any(dim=-1)
    chosen = torch.gather(cand, -1, first[..., None])[..., 0]
    return hit, chosen


def _qhdist_rec(cfg: KScanConfig, table, fwd, klen, mm, lmask, depth):
    """getValue(kmer, qHDist=depth): exact lookup, then depth-first
    single-sub mutant retries in (symbol, position) order, first hit wins
    (BBDukIndexMod.getValue :461-478). depth==1 resolves all mutants in
    one batched lookup; deeper levels loop over the outer mutant axis."""
    rkm = _rc(fwd, klen)
    mx = torch.maximum(fwd, rkm) if cfg.rcomp else fwd
    out = _lookup(cfg, table, (mx & mm) | lmask)
    if depth <= 0:
        return out
    if depth == 1:
        hit, chosen = _mutants_lookup_first(cfg, table, fwd, klen, mm, lmask)
        return torch.where((out < 1) & hit, chosen, out)
    for m in range(4 * klen):
        j, i = m // klen, m % klen
        temp = (fwd & ~(3 << (2 * i))) | (j << (2 * i))
        sub = _qhdist_rec(cfg, table, temp, klen, mm, lmask, depth - 1)
        out = torch.where((out < 1) & (temp != fwd) & (sub > 0), sub, out)
    return out


def canonical_keys(cfg: KScanConfig, fwd, rkm, klen: int):
    """The lookup keys of kmers of length klen: (max(kmer, rkmer) &
    middleMask) | lengthMask (BBDukIndexMod.toValue :529)."""
    mm = cfg.mid_mask if klen == cfg.k else -1
    mx = torch.maximum(fwd, rkm) if cfg.rcomp else fwd
    return (mx & mm) | length_mask(klen)


def _lookup_qhdist(cfg: KScanConfig, table, fwd, rkm, klen, lmask):
    """getValue with qhdist mutation retries; see _qhdist_rec."""
    if cfg.qhdist <= 0:
        return _lookup(cfg, table, canonical_keys(cfg, fwd, rkm, klen))
    mm = cfg.mid_mask if klen == cfg.k else -1
    return _qhdist_rec(cfg, table, fwd, klen, mm, lmask, cfg.qhdist)


def _rc(kmer, k: int):
    out = torch.zeros_like(kmer)
    x = kmer
    for _ in range(k):
        out = (out << 2) | (3 - (x & 3))
        x = x >> 2
    return out


def _scan_bounds(cfg: KScanConfig, lengths):
    """start/stop per read (restrictLeft/Right, BBDukProcessorS:1543-1544)."""
    if cfg.restrict_right < 1:
        start = torch.zeros_like(lengths)
    else:
        start = torch.clamp(lengths - cfg.restrict_right, min=0)
    if cfg.restrict_left < 1:
        stop = lengths
    else:
        stop = torch.clamp(lengths, max=cfg.restrict_left)
    return start, stop


def kscan_full(cfg: KScanConfig, table, bases, lengths):
    """Full-k scan shared by filter and trim modes; bases uint8 [B, L],
    lengths int32 [B] on the table's device.

    Returns a dict of per-read tensors:
      nhits   — number of eligible hit positions
      id0     — id of the first hit (scan order), 0 if none
      min_loc — min(i - k + 1) over hits (BIG if none)
      max_loc — max(i) over hits (-1 if none)
      hit     — [B, L] bool eligible-hit mask
      ids     — [B, L] int32 ids at hit positions
    """
    B, L = bases.shape
    fwd, rkm, runlen = rolling_kmers(bases, cfg.k)
    start, stop = _scan_bounds(cfg, lengths)
    i_idx = torch.arange(L, dtype=torch.int32, device=bases.device)[None, :]
    eligible = (
        (runlen >= cfg.resolved_minlen2())
        & (i_idx >= cfg.k - 1)
        & (i_idx >= start[:, None])
        & (i_idx < stop[:, None])
    )
    if cfg.qskip > 1:
        eligible &= (i_idx % cfg.qskip) == 0
    if cfg.speed > 0:
        mx = torch.maximum(fwd, rkm) if cfg.rcomp else fwd
        key0 = (mx & cfg.mid_mask) | length_mask(cfg.k)
        eligible &= ((key0 & 0x7FFFFFFFFFFFFFFF) % 17) >= cfg.speed
    ids = _lookup_qhdist(cfg, table, fwd, rkm, cfg.k, length_mask(cfg.k))
    ids = torch.where(eligible, ids, 0)
    hit = ids > 0
    nhits = hit.sum(dim=1, dtype=torch.int32)
    first_pos = torch.where(hit, i_idx, BIG).amin(dim=1)
    id0 = torch.where(
        nhits > 0,
        torch.where(i_idx == first_pos[:, None], ids, 0).sum(dim=1),
        0,
    )
    min_loc = torch.where(nhits > 0, first_pos - (cfg.k - 1), BIG)
    max_loc = torch.where(hit, i_idx, -1).amax(dim=1)
    return {
        "nhits": nhits,
        "id0": id0,
        "min_loc": min_loc,
        "max_loc": max_loc,
        "hit": hit,
        "ids": ids,
    }


def credit_id(ids, credit_ordinal):
    """Id of the (credit_ordinal+1)-th hit per read (0 if fewer hits).
    Used by filter mode: countSetKmers credits the hit at found==maxBadKmers
    (BBDukProcessorS.java:1580-1588)."""
    hit = ids > 0
    order = torch.cumsum(hit, dim=1) - 1  # ordinal of each hit
    sel = hit & (order == credit_ordinal[:, None])
    # at most one position matches per row
    return torch.where(sel, ids, 0).sum(dim=1)


def kscan_short(cfg: KScanConfig, table, bases, lengths, left: bool):
    if cfg.restrict_left < 1 and cfg.restrict_right < 1 and cfg.qhdist == 0:
        return _kscan_short_fast(cfg, table, bases, lengths, left)
    return _kscan_short_loop(cfg, table, bases, lengths, left)


def _kscan_short_fast(cfg: KScanConfig, table, bases, lengths, left: bool):
    """Short-kmer end scan from the rolling registers: prefix/suffix
    kmers of every length are bit-slices of them (static columns for the
    read-start values, a masked select for the read-end values)."""
    B, L = bases.shape
    k, mink = cfg.k, cfg.mink
    fwd, _, rkm_plain, _ = rolling_kmers_plain(bases, k)
    keys_l, live_l, i_l = [], [], []
    if left:
        # prefix of length ln ends at static column ln-1:
        #   kmer  = fwd[:, ln-1] & ((1<<2ln)-1)   (register low bits)
        #   rkmer = rkm_plain[:, ln-1] >> 2(k-ln)
        for ln in range(mink, k + 1):
            col = ln - 1
            kmer = fwd[:, col] & ((1 << (2 * ln)) - 1)
            rkmer = rkm_plain[:, col] >> (2 * (k - ln))
            mx = torch.maximum(kmer, rkmer) if cfg.rcomp else kmer
            keys_l.append(mx | length_mask(ln))
            # loop bound: i < min(k, stop) with stop = length
            live_l.append(col < torch.clamp(lengths, max=k))
            i_l.append(torch.full((B,), col, dtype=torch.int32, device=bases.device))
    else:
        # suffix of length ln ends at the read's last base
        last = torch.clamp(lengths - 1, min=0)[:, None]
        pos_i = torch.arange(L, dtype=torch.int32, device=bases.device)[None, :]
        at_last = pos_i == last
        f_end = torch.where(at_last, fwd, 0).sum(dim=1)
        r_end = torch.where(at_last, rkm_plain, 0).sum(dim=1)
        for ln in range(mink, k + 1):
            kmer = f_end & ((1 << (2 * ln)) - 1)
            rkmer = r_end >> (2 * (k - ln))
            mx = torch.maximum(kmer, rkmer) if cfg.rcomp else kmer
            keys_l.append(mx | length_mask(ln))
            # loop: i from stop-1 down, i > max(-1, stop-k); hit position
            # i = stop - ln
            i_pos = (lengths - ln).to(torch.int32)
            live_l.append(i_pos > torch.clamp(lengths - k, min=-1))
            i_l.append(i_pos)
    # [n_lens, B]
    keys = torch.stack(keys_l, dim=0)
    live = torch.stack(live_l, dim=0)
    pos = torch.stack(i_l, dim=0)
    ids = torch.where(live, _lookup(cfg, table, keys), 0)
    return _short_select(ids, pos, left, dim=0)


def _short_select(ids, pos, left: bool, dim: int):
    """(any_hit, id of the first hit along `dim`, extreme hit position)."""
    hit = ids > 0
    any_hit = hit.any(dim=dim)
    first = torch.argmax(hit.to(torch.int32), dim=dim, keepdim=True)
    id0 = torch.where(any_hit, torch.gather(ids, dim, first).squeeze(dim), 0)
    if left:
        loc = torch.where(hit, pos, -1).amax(dim=dim)
    else:
        loc = torch.where(hit, pos, BIG).amin(dim=dim)
    return any_hit, id0, loc


def _kscan_short_loop(cfg: KScanConfig, table, bases, lengths, left: bool):
    """Short-kmer end scan (Scanning4/Scanning5, BBDukProcessorS
    :2036-2106) under restrictLeft/Right or qhdist. Only meaningful when
    the full scan found nothing.

    Returns (any_hit, id0, loc) where loc is:
      left scan:  max hit index i (maxLoc candidate)
      right scan: min hit index i (minLoc candidate)
    Undefined bases contribute code 0 with no reset (matching the
    reference's short-kmer loops, which have no N handling)."""
    B, L = bases.shape
    codes = bases.to(torch.int32)
    code0 = torch.where(codes < 4, codes, 0).to(torch.int64)
    comp0 = torch.where(codes < 4, 3 - codes, 0).to(torch.int64)
    start, stop = _scan_bounds(cfg, lengths)
    k, mink = cfg.k, cfg.mink
    mask = (1 << (2 * k)) - 1
    kmer = torch.zeros(B, dtype=torch.int64, device=bases.device)
    rkmer = torch.zeros_like(kmer)
    keys_l: list = []  # per short length: canonical key [B] (or id with qhdist)
    live_l: list = []  # per short length: in-bounds mask [B]
    i_l: list = []  # per short length: absolute position [B]
    for step in range(k):
        if left:
            i = start + step
            ii = torch.clamp(i, max=L - 1)[:, None].to(torch.int64)
            x = torch.gather(code0, 1, ii)[:, 0]
            x2 = torch.gather(comp0, 1, ii)[:, 0]
            kmer = ((kmer << 2) | x) & mask
            rkmer = rkmer | (x2 << (2 * step))
            # loop bound: i < min(k, stop)  (BBDukProcessorS:2041 lim)
            live = i < torch.clamp(stop, max=k)
        else:
            i = stop - 1 - step
            live = i >= torch.clamp(stop - k, min=-1) + 1
            ii = torch.clamp(i, 0, L - 1)[:, None].to(torch.int64)
            x = torch.gather(code0, 1, ii)[:, 0]
            x2 = torch.gather(comp0, 1, ii)[:, 0]
            kmer = torch.where(live, kmer | (x << (2 * step)), kmer)
            rkmer = torch.where(live, ((rkmer << 2) | x2) & mask, rkmer)
        ln = step + 1
        if ln >= mink:
            if cfg.qhdist > 0:
                keys_l.append(
                    _lookup_qhdist(cfg, table, kmer, rkmer, ln, length_mask(ln))
                )
            else:
                mx = torch.maximum(kmer, rkmer) if cfg.rcomp else kmer
                keys_l.append(mx | length_mask(ln))
            live_l.append(live)
            i_l.append(i)
    keys = torch.stack(keys_l, dim=1)  # [B, S]
    live = torch.stack(live_l, dim=1)
    pos = torch.stack([x.to(torch.int32) for x in i_l], dim=1)
    if cfg.qhdist > 0:
        ids = torch.where(live, keys, 0)  # keys already hold looked-up ids
    else:
        ids = torch.where(live, _lookup(cfg, table, keys), 0)  # [B, S]
    return _short_select(ids, pos, left, dim=1)


def kscan_combined(cfg: KScanConfig, table, bases, lengths,
                   short_left: bool, short_right: bool):
    """Full scan + requested short-end scans of one batch."""
    out = kscan_full(cfg, table, bases, lengths)
    sl = kscan_short(cfg, table, bases, lengths, True) if short_left else None
    sr = kscan_short(cfg, table, bases, lengths, False) if short_right else None
    return out, sl, sr
