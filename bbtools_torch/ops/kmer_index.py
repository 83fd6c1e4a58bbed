"""Reference k-mer index: host build + device lookup.

Build semantics replicate the BBDuk loader exactly
(bbduk/BBDukIndexAndLoader.addToMap(Read) :618-700, addToMapLeftShift/
RightShift :707-766, mutate recursion BBDukIndexMod.java:383-443):

  - every fully-defined window of length k in a reference scaffold is
    stored under its canonical key with value = scaffold id (1-based);
    `setIfNotPresent` means the FIRST insertion wins, and insertions
    happen in (scaffold, position, mutation-order) order
  - hdist > 0 expands substitution mutants at load, depth-first per kmer,
    symbol-major then position-minor (positions counted from the LSB end)
  - mink enables short kmers at reference sequence ends: prefixes of the
    first window (addToMapRightShift) and suffixes of the last
    (addToMapLeftShift), lengths k-1 down to mink, tagged by their
    length_mask bit, expanded with hdist2
  - maskMiddle keys are stored pre-masked

Lookup runs on the index's device. Three interchangeable structures:

  SortedKmerIndex — sorted int64 keys + binary search (searchsorted).
    Deterministic, simple; the reference's own BBMap Block index is the
    same sorted-array idea (align2/Block.java:18).
  HashKmerIndex — open-addressed, linearly-probed table in flat arrays,
    keys split into int32 hi/lo lanes; probe depth is fixed at build
    time so the query is a handful of gather+compare steps (the
    HashArray analog, kmer/HashArray.java:22).
  BucketKmerIndex — keys hash to one bucket row of BUCKET slots: one or
    two row gathers a lookup whatever the load; BBDuk's bucket backend.

Each returns the stored id (>0) or 0 for a miss, per query position.

The host builders are copies of bbtools_tpu/ops/kmer_index.py, but for
`expand_kmers` at hdist >= 2, which builds the same stream vectorized
(see there). The lookups are torch gathers on the index's device; the
splitmix64 hash runs in int64 with logical right shifts, since torch
has no general uint64 arithmetic (multiplication wraps modulo 2**64 on
both the CPU and CUDA).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .kmers import (
    canonical_keys_np,
    length_mask,
    rc_kmer_np,
    rolling_kmers_np,
)


def _mutant_stream_hdist1(kmers: np.ndarray, klen: int, mid_mask: int):
    """Per base kmer: [canon(kmer)] + canon of all single-sub mutants in
    reference order (symbol-major j=0..3, position i=0..len-1 from LSB),
    skipping identity mutants. Returns [n, 1+3*klen] canonical keys."""
    n = len(kmers)
    j = np.arange(4, dtype=np.int64)[None, :, None]
    i = np.arange(klen, dtype=np.int64)[None, None, :]
    clear = ~(np.int64(3) << (2 * i))
    temp = (kmers[:, None, None] & clear) | (j << (2 * i))  # [n, 4, klen]
    keep = temp != kmers[:, None, None]
    temp_flat = temp.reshape(n, 4 * klen)
    keep_flat = keep.reshape(n, 4 * klen)
    # each row keeps exactly 3*klen entries, so masked-take stays rectangular
    mutants = temp_flat[keep_flat].reshape(n, 3 * klen)
    rmut = rc_kmer_np(mutants, klen)
    base_key = canonical_keys_np(kmers, rc_kmer_np(kmers, klen), klen, mid_mask)
    mut_key = canonical_keys_np(mutants, rmut, klen, mid_mask)
    return np.concatenate([base_key[:, None], mut_key], axis=1)


#: raw stream entries per chunk of `expand_kmers` at hdist >= 2 (32 MiB
#: of int64, so a chunk's canonicalisation stays a few hundred MiB)
EXPAND_CHUNK = 1 << 22


def _mutant_stream_raw(kmers: np.ndarray, klen: int, dist: int) -> np.ndarray:
    """The depth-first mutate recursion (BBDukIndexMod.mutate :383-443)
    of every kmer as one array [n, S], S = 1 + 3*klen*S(dist-1): each row
    is the kmer, then, for each of its single-sub mutants in (symbol j,
    position i) order, skipping the identity, that mutant's own stream at
    dist-1. Raw (not canonical) values, in the recursion's exact order."""
    kmers = np.asarray(kmers, dtype=np.int64)
    n = len(kmers)
    if dist == 0:
        return kmers[:, None]
    j = np.arange(4, dtype=np.int64)[None, :, None]
    i = np.arange(klen, dtype=np.int64)[None, None, :]
    temp = (kmers[:, None, None] & ~(np.int64(3) << (2 * i))) | (j << (2 * i))
    keep = temp != kmers[:, None, None]
    muts = temp.reshape(n, 4 * klen)[keep.reshape(n, 4 * klen)]  # [n * 3klen]
    sub = _mutant_stream_raw(muts, klen, dist - 1)
    return np.concatenate([kmers[:, None], sub.reshape(n, -1)], axis=1)


def expand_kmers(
    kmers: np.ndarray, klen: int, hdist: int, mid_mask: int = -1
) -> tuple[np.ndarray, np.ndarray]:
    """Expand kmers (in scan order) to the full insertion stream of
    canonical keys. Returns (keys, source_index) where source_index maps
    each stream entry back to its originating kmer.

    The JAX package walks hdist >= 2 as a per-kmer Python recursion (tens
    of minutes for a panel whose expansion passes the sorted join's cap).
    Here the kmers go in chunks of about EXPAND_CHUNK stream entries, and
    each chunk's stream is one vectorized array per depth in the
    recursion's exact order, so the result is the same arrays
    (tests/test_torch_mm_match.py holds them equal across chunks)."""
    kmers = np.asarray(kmers, dtype=np.int64)
    n = len(kmers)
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    if hdist == 0:
        keys = canonical_keys_np(kmers, rc_kmer_np(kmers, klen), klen, mid_mask)
        return keys, np.arange(n, dtype=np.int64)
    if hdist == 1:
        stream = _mutant_stream_hdist1(kmers, klen, mid_mask)
        src = np.repeat(np.arange(n, dtype=np.int64), stream.shape[1])
        return stream.reshape(-1), src
    per = _mutant_stream_raw(kmers[:1], klen, hdist).shape[1]
    step = max(1, EXPAND_CHUNK // per)
    keys = np.concatenate([
        canonical_keys_np(raw, rc_kmer_np(raw, klen), klen, mid_mask)
        for raw in (
            _mutant_stream_raw(kmers[c : c + step], klen, hdist).reshape(-1)
            for c in range(0, n, step)
        )
    ])
    return keys, np.repeat(np.arange(n, dtype=np.int64), per)


def _edist_children(kmers: np.ndarray, extras: np.ndarray, klen: int):
    """All one-step sub/del/ins mutants of (kmer, extra) nodes, vectorized.
    Identity mutants are NOT filtered — their keys are duplicates of the
    parent's own emission and vanish in the final first-wins dedup, so
    skipping the filter trades a few dup rows for full vectorization."""
    n = len(kmers)
    full = np.int64((1 << (2 * klen)) - 1)
    i = np.arange(klen, dtype=np.int64)[None, :]
    j = np.arange(4, dtype=np.int64)[None, :, None]
    # subs: [n, 4, klen], extra unchanged
    clear = ~(np.int64(3) << (2 * i))
    subs = (kmers[:, None, None] & clear[:, None, :]) | (j << (2 * i[:, None, :]))
    subs = subs.reshape(n, -1)
    sub_extra = np.broadcast_to(extras[:, None], subs.shape)
    out_k = [subs.reshape(-1)]
    out_e = [np.ascontiguousarray(sub_extra).reshape(-1)]
    if klen > 1:
        ii = np.arange(1, klen, dtype=np.int64)[None, :]
        left = full & ~((np.int64(1) << (2 * ii)) - 1)
        right = (np.int64(1) << (2 * ii)) - 1
        # Identity mutants (temp==kmer) are never recursed by the reference;
        # where one appears we pin the child's extra to the PARENT's extra,
        # turning it into an exact copy of the parent node whose subtree is
        # a subset of the parent's — union-harmless at any depth.
        # dels (only where extra defined): consume extra, child extra = -1
        has_extra = extras >= 0
        if has_extra.any():
            km_d = kmers[has_extra]
            ex_d = extras[has_extra]
            dels = (
                (km_d[:, None] & left)
                | ((km_d[:, None] << 2) & right)
                | ex_d[:, None]
            )
            del_extra = np.where(dels == km_d[:, None], ex_d[:, None], -1)
            out_k.append(dels.reshape(-1))
            out_e.append(del_extra.reshape(-1))
        # ins: child extra = parent's last base
        temp0 = (kmers[:, None] & left) | ((kmers[:, None] & right) >> 2)
        jj = np.arange(4, dtype=np.int64)[None, :, None]
        ins = temp0[:, None, :] | (jj << (2 * (ii[:, None, :] - 1)))
        ins = ins.reshape(n, -1)
        eb2 = (kmers & 3)[:, None]
        ins_extra = np.where(ins == kmers[:, None], extras[:, None], eb2)
        out_k.append(ins.reshape(-1))
        out_e.append(ins_extra.reshape(-1))
    return np.concatenate(out_k), np.concatenate(out_e)


def expand_kmers_edist(
    kmers: np.ndarray,
    extras: np.ndarray,
    klen: int,
    edist: int,
    mid_mask: int = -1,
) -> tuple[np.ndarray, np.ndarray]:
    """Expand kmers through `edist` recursions of sub+del+ins mutation
    (load-side `edist=` semantics, BBDukIndexMod.mutate :383-443 with
    editDistance>0). `extras[i]` is the 2-bit code of the scaffold base
    following kmer i, or -1 (scaffold end / undefined): deletions consume
    it; insertions push the dropped last base into the child's extra.

    Level-wise vectorized (the DFS emission ORDER is irrelevant here: all
    mutants of one scaffold share the scaffold id, and first-wins dedup
    happens downstream). Returns (keys, source_index) like expand_kmers;
    source_index is 0 for all rows (per-kmer attribution is not preserved
    across the level-wise expansion — callers only use per-scaffold ids).
    """
    kmers = np.asarray(kmers, dtype=np.int64)
    extras = np.asarray(extras, dtype=np.int64)
    if len(kmers) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    all_k = [kmers]
    cur_k, cur_e = kmers, extras
    for _ in range(edist):
        cur_k, cur_e = _edist_children(cur_k, cur_e, klen)
        # dedup identical (kmer, extra) nodes to bound level growth
        pairs = np.stack([cur_k, cur_e], axis=1)
        pairs = np.unique(pairs, axis=0)
        cur_k, cur_e = pairs[:, 0], pairs[:, 1]
        all_k.append(cur_k)
    raw = np.concatenate(all_k)
    keys = canonical_keys_np(raw, rc_kmer_np(raw, klen), klen, mid_mask)
    keys = np.unique(keys)
    return keys, np.zeros(len(keys), dtype=np.int64)


def scaffold_kmer_stream(codes: np.ndarray, k: int, mink: int = 0):
    """Full-k kmers (fwd, rkm) of one scaffold in scan order, plus the
    short-kmer streams at the ends when mink > 0.

    Returns (fwd[k..], rkm[k..], shorts_first, shorts_last, extras) with
    shorts a list of (kmer, rkmer, len, extra) in reference insertion
    order relative markers: shorts_first (added right after the first full
    kmer) and shorts_last. `extras` aligns with the full kmers: the 2-bit
    code of the scaffold base following each window (or -1 at scaffold
    end / before an undefined base) — consumed by edist deletions
    (BBDukIndexAndLoader passes it into addToMap/mutate).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    L = len(codes)
    if L < k:
        return (
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
            [],
            [],
            np.zeros(0, np.int64),
        )
    fwd, rkm, runlen = rolling_kmers_np(codes[None, :], k)
    fwd, rkm, runlen = fwd[0], rkm[0], runlen[0]
    valid = runlen >= k
    # extra base following the window ending at p: codes[p+1] (or -1)
    nxt = np.full(L, -1, dtype=np.int64)
    nxt[:-1] = np.where(codes[1:] < 4, codes[1:].astype(np.int64), -1)
    shorts_first: list[tuple[int, int, int, int]] = []
    shorts_last: list[tuple[int, int, int, int]] = []
    if mink and mink < k:
        right_masks = [(1 << (2 * i)) - 1 for i in range(k + 1)]
        if valid[k - 1]:
            # addToMapRightShift: prefixes of the first window; each
            # iteration's extra is the base just shifted out (kmer&3)
            km, rk = int(fwd[k - 1]), int(rkm[k - 1])
            for i in range(k - 1, mink - 1, -1):
                eb = km & 3
                km >>= 2
                rk &= right_masks[i]
                shorts_first.append((km, rk, i, eb))
        if valid[L - 1]:
            # addToMapLeftShift: suffixes of the last window; extra is the
            # caller's extraBase (base after the last window, i.e. -1 at
            # scaffold end)
            km, rk = int(fwd[L - 1]), int(rkm[L - 1])
            eb = int(nxt[L - 1])
            for i in range(k - 1, mink - 1, -1):
                km &= right_masks[i]
                rk >>= 2
                shorts_last.append((km, rk, i, eb))
    return fwd[valid], rkm[valid], shorts_first, shorts_last, nxt[valid]


def build_ref_keys(
    scaffolds: list[np.ndarray],
    k: int,
    mink: int = 0,
    hdist: int = 0,
    hdist2: int | None = None,
    edist: int = 0,
    edist2: int | None = None,
    mid_mask: int = -1,
    ids: list[int] | None = None,
    speed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Build the (sorted_keys, ids) arrays for a reference set.

    `scaffolds` are 2-bit code arrays in input order; scaffold ids default
    to 1..n (the reference's scaffold numbering, 0 reserved). First
    insertion wins on duplicate keys, in exact reference order.

    `edist` switches the load expansion to sub+del+ins recursion at depth
    edist (BBDukIndexMod.addToMap :352-360: when editDistance>0 the mutate
    depth is edist, regardless of a larger hdist — replicated faithfully).
    """
    if hdist2 is None:
        hdist2 = hdist
    if edist2 is None:
        edist2 = edist
    all_keys: list[np.ndarray] = []
    all_ids: list[np.ndarray] = []
    for snum, codes in enumerate(scaffolds):
        sid = ids[snum] if ids is not None else snum + 1
        fwd, rkm, shorts_first, shorts_last, extras = scaffold_kmer_stream(
            codes, k, mink
        )
        if len(fwd) == 0:
            continue
        # Reference interleaves short-kmer adds right after the first/last
        # full-kmer add; with setIfNotPresent and distinct length tags the
        # only ordering that matters is within each length class, which is
        # preserved by grouping (full kmers never collide with shorts).
        if edist > 0:
            keys, _ = expand_kmers_edist(fwd, extras, k, edist, mid_mask)
        else:
            keys, _ = expand_kmers(fwd, k, hdist, mid_mask)
        all_keys.append(keys)
        all_ids.append(np.full(len(keys), sid, dtype=np.int32))
        for km, rk, ln, eb in shorts_first + shorts_last:
            if edist2 > 0:
                skeys, _ = expand_kmers_edist(
                    np.array([km], dtype=np.int64),
                    np.array([eb], dtype=np.int64),
                    ln,
                    edist2,
                    -1,
                )
            else:
                skeys, _ = expand_kmers(
                    np.array([km], dtype=np.int64), ln, hdist2, -1
                )
            all_keys.append(skeys)
            all_ids.append(np.full(len(skeys), sid, dtype=np.int32))
    if not all_keys:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int32)
    keys = np.concatenate(all_keys)
    idv = np.concatenate(all_ids)
    # first-insertion-wins dedup: np.unique returns the first occurrence
    # index for each unique key
    ukeys, first = np.unique(keys, return_index=True)
    uids = idv[first]
    if speed > 0:
        # speed sampling (BBDukIndexAndLoader.passesSpeed :997), applied
        # on the same canonical key the scan side tests so both agree
        keep = (
            (ukeys.astype(np.uint64) & np.uint64(0x7FFFFFFFFFFFFFFF))
            % np.uint64(17)
        ) >= np.uint64(speed)
        ukeys, uids = ukeys[keep], uids[keep]
    return ukeys, uids


@dataclass
class SortedKmerIndex:
    """Sorted-key index; lookup via binary search. Works on host and device."""

    keys: np.ndarray  # int64 [N], sorted ascending
    ids: np.ndarray  # int32 [N]

    @property
    def n(self) -> int:
        return len(self.keys)

    def lookup_np(self, query: np.ndarray) -> np.ndarray:
        if self.n == 0:
            return np.zeros(query.shape, dtype=np.int32)
        pos = np.searchsorted(self.keys, query)
        pos = np.minimum(pos, self.n - 1)
        hit = self.keys[pos] == query
        return np.where(hit, self.ids[pos], 0).astype(np.int32)

    def device_arrays(self, device):
        return (
            torch.from_numpy(np.ascontiguousarray(self.keys, np.int64)).to(device),
            torch.from_numpy(np.ascontiguousarray(self.ids, np.int32)).to(device),
        )

    @staticmethod
    def lookup(keys, ids, query):
        """query int64 [...] -> id int32 [...] on the keys' device: the
        left insertion point, clamped to the last key, and a compare."""
        n = keys.shape[0]
        if n == 0:
            return torch.zeros(query.shape, dtype=torch.int32, device=query.device)
        pos = torch.searchsorted(keys, query.reshape(-1)).clamp(max=n - 1).reshape(query.shape)
        hit = keys[pos] == query
        return torch.where(hit, ids[pos], 0).to(torch.int32)


def _mix64(h: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (public-domain mixing constants)."""
    h = h.astype(np.uint64)
    h ^= h >> np.uint64(30)
    h *= np.uint64(0xBF58476D1CE4E5B9)
    h ^= h >> np.uint64(27)
    h *= np.uint64(0x94D049BB133111EB)
    h ^= h >> np.uint64(31)
    return h


@dataclass
class HashKmerIndex:
    """Open-addressed, linear-probe hash table in flat device arrays.

    Keys are stored as separate int32 hi/lo lanes plus an int32 id lane;
    empty slots have id == 0. `max_probe` is the longest probe sequence
    that occurred at build, so the device query is a loop of
    `max_probe + 1` gather+compare steps.
    """

    key_hi: np.ndarray  # int32 [cap]
    key_lo: np.ndarray  # int32 [cap]
    ids: np.ndarray  # int32 [cap]
    cap: int
    max_probe: int
    n: int

    #: longest probe sequence allowed; build retries with a bigger table if
    #: exceeded, keeping the device lookup a short unrolled gather chain
    PROBE_LIMIT = 6

    @staticmethod
    def build(keys: np.ndarray, ids: np.ndarray, load_factor: float = 0.5):
        n = len(keys)
        cap = 64
        while cap * load_factor < max(n, 1):
            cap *= 2
        while True:
            idx = HashKmerIndex._build_at(keys, ids, cap)
            if idx.max_probe <= HashKmerIndex.PROBE_LIMIT or cap >= 1 << 30:
                return idx
            cap *= 2

    @staticmethod
    def _build_at(keys: np.ndarray, ids: np.ndarray, cap: int):
        n = len(keys)
        key_hi = np.zeros(cap, dtype=np.int32)
        key_lo = np.zeros(cap, dtype=np.int32)
        idarr = np.zeros(cap, dtype=np.int32)
        occupied = np.zeros(cap, dtype=bool)
        h = (_mix64(keys.astype(np.uint64)) & np.uint64(cap - 1)).astype(np.int64)
        remaining = np.arange(n)
        probe = 0
        max_probe = 0
        while len(remaining):
            slot = (h[remaining] + probe) & (cap - 1)
            free = ~occupied[slot]
            # among entries landing on the same free slot, lowest index wins
            cand = remaining[free]
            cand_slot = slot[free]
            order = np.argsort(cand_slot, kind="stable")
            cand, cand_slot = cand[order], cand_slot[order]
            first = np.ones(len(cand), dtype=bool)
            first[1:] = cand_slot[1:] != cand_slot[:-1]
            placed = cand[first]
            pslot = cand_slot[first]
            occupied[pslot] = True
            key_hi[pslot] = (keys[placed] >> 32).astype(np.int32)
            key_lo[pslot] = (keys[placed] & 0xFFFFFFFF).astype(np.int32)
            idarr[pslot] = ids[placed]
            if len(placed):
                max_probe = probe
            mask = np.ones(len(remaining), dtype=bool)
            mask[np.isin(remaining, placed)] = False
            remaining = remaining[mask]
            probe += 1
            if probe > cap:
                raise RuntimeError("hash build failed to converge")
        return HashKmerIndex(key_hi, key_lo, idarr, cap, max_probe, n)

    def lookup_np(self, query: np.ndarray) -> np.ndarray:
        qh = (_mix64(query.astype(np.uint64)) & np.uint64(self.cap - 1)).astype(
            np.int64
        )
        out = np.zeros(query.shape, dtype=np.int32)
        found = np.zeros(query.shape, dtype=bool)
        q_hi = (query >> 32).astype(np.int32)
        q_lo = (query & 0xFFFFFFFF).astype(np.int32)
        for step in range(self.max_probe + 1):
            slot = (qh + step) & (self.cap - 1)
            hit = (
                (self.key_hi[slot] == q_hi)
                & (self.key_lo[slot] == q_lo)
                & (self.ids[slot] != 0)
                & ~found
            )
            out = np.where(hit, self.ids[slot], out)
            found |= hit
        return out

    def device_arrays(self, device):
        return tuple(torch.from_numpy(a).to(device)
                     for a in (self.key_hi, self.key_lo, self.ids))

    @staticmethod
    def lookup(key_hi, key_lo, ids, cap: int, max_probe: int, query):
        """query int64 [...] -> id int32 [...] on the table's device:
        max_probe + 1 steps of three gathers and a compare. The query's
        lanes are its high 32 bits and its low 32 bits read as int32
        (wrapped as numpy's astype(int32) wraps them)."""
        base = _bucket_of(query, cap)
        q_hi = (query >> 32).to(torch.int32)
        lo = query & 0xFFFFFFFF
        q_lo = (lo - ((lo >> 31) << 32)).to(torch.int32)
        out = torch.zeros(query.shape, dtype=torch.int32, device=query.device)
        for step in range(max_probe + 1):
            slot = (base + step) & (cap - 1)
            hit = (key_hi[slot] == q_hi) & (key_lo[slot] == q_lo) & (ids[slot] != 0) & (out == 0)
            out = torch.where(hit, ids[slot], out)
        return out


@dataclass
class BucketKmerIndex:
    """Bucketed hash table: one row-gather fetches all candidates.

    TPU-native replacement for probe chains: keys hash to one of `nb`
    buckets of BUCKET slots; a lookup is exactly TWO gather ops (key rows,
    id rows) regardless of load, with the match selected by a gather-free
    masked sum (at most one slot can match a given key). This is the
    device analog of HashArray's probe window (kmer/HashArray.java:154)
    collapsed into a single coalesced row access.
    """

    BUCKET = 16

    keys: np.ndarray  # int64 [nb, BUCKET]; packed: (key<<16|id), empty -1
    ids: np.ndarray  # int32 [nb, BUCKET] (packed: empty [1, BUCKET])
    nb: int
    n: int
    packed: bool = False

    @staticmethod
    def build(keys: np.ndarray, ids: np.ndarray, fill: float = 0.5,
              pack: bool = False):
        """Wide buckets; with pack=True and keys fitting 47 bits (k<=23
        incl. the length-tag bit) the layout is key48|id16 in one plane:
        ONE [.., 16] int64 row-gather per lookup instead of two [.., 8]
        gathers — measured 2.2x the lookup rate on a v5e (bench: gather
        variants a vs c). Callers using the static unpacked lookup_jnp
        must keep pack=False."""
        n = len(keys)
        B = BucketKmerIndex.BUCKET
        nb = 64
        while nb * B * fill < max(n, 1):
            nb *= 2
        while True:
            h = (_mix64(keys.astype(np.uint64)) & np.uint64(nb - 1)).astype(
                np.int64
            )
            counts = np.bincount(h, minlength=nb)
            if counts.max(initial=0) <= B or nb >= 1 << 28:
                break
            nb *= 2
        order = np.argsort(h, kind="stable")
        hs = h[order]
        slot = np.arange(n) - np.searchsorted(hs, hs)  # rank within bucket
        packed = pack and bool(
            n == 0
            or (
                keys.min(initial=0) >= 0
                and keys.max(initial=0) < (1 << 47)
                and ids.min(initial=0) >= 0
                and ids.max(initial=0) < (1 << 16)
            )
        )
        if packed:
            kt = np.full((nb, B), -1, dtype=np.int64)
            kt[hs, slot] = (keys[order] << 16) | ids[order].astype(np.int64)
            it = np.zeros((1, B), dtype=np.int32)
        else:
            kt = np.full((nb, B), -1, dtype=np.int64)
            it = np.zeros((nb, B), dtype=np.int32)
            kt[hs, slot] = keys[order]
            it[hs, slot] = ids[order]
        return BucketKmerIndex(keys=kt, ids=it, nb=nb, n=n, packed=packed)

    def lookup_np(self, query: np.ndarray) -> np.ndarray:
        h = (_mix64(query.astype(np.uint64)) & np.uint64(self.nb - 1)).astype(
            np.int64
        )
        rows_k = self.keys[h]  # [..., B]
        if self.packed:
            eq = (rows_k >> 16) == query[..., None]
            return ((rows_k & 0xFFFF) * eq).sum(axis=-1).astype(np.int32)
        rows_i = self.ids[h]
        eq = rows_k == query[..., None]
        return (rows_i * eq).sum(axis=-1).astype(np.int32)

    def device_arrays(self, device):
        return (
            torch.from_numpy(self.keys).to(device),
            torch.from_numpy(self.ids).to(device),
        )

    @staticmethod
    def lookup_packed(ptbl, nb: int, query):
        """Packed-layout lookup: ONE row gather."""
        rows = ptbl[_bucket_of(query, nb)]  # [..., B] int64 — the only gather
        eq = (rows >> 16) == query[..., None]
        return ((rows & 0xFFFF) * eq).sum(dim=-1).to(torch.int32)

    @staticmethod
    def lookup(keys_tbl, ids_tbl, nb: int, query):
        """query int64 [...] -> id int32 [...]; exactly two gathers."""
        slot = _bucket_of(query, nb)
        rows_k = keys_tbl[slot]  # gather 1: [..., B] int64
        rows_i = ids_tbl[slot]  # gather 2: [..., B] int32
        eq = rows_k == query[..., None]
        return (rows_i * eq).sum(dim=-1).to(torch.int32)


def _as_int64(c: int) -> int:
    """A 64-bit unsigned constant as the signed int64 of the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_M1 = _as_int64(0xBF58476D1CE4E5B9)
_M2 = _as_int64(0x94D049BB133111EB)


def _srl(h, s: int):
    """Logical right shift of int64 bits."""
    return (h >> s) & ((1 << (64 - s)) - 1)


def mix64_t(h: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 tensors: the bits of _mix64 on the
    host, read as signed (wrapping multiplies, logical shifts)."""
    h = h ^ _srl(h, 30)
    h = h * _M1
    h = h ^ _srl(h, 27)
    h = h * _M2
    return h ^ _srl(h, 31)


def _bucket_of(query, nb: int):
    """splitmix64(query) & (nb - 1), the bucket of _mix64 on the host."""
    return mix64_t(query) & (nb - 1)
