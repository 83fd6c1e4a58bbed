"""Tadpole — k-mer extension assembler (BASELINE config #5a, contig mode).

Re-design of assemble/Tadpole.java:49 + Tadpole1.java:34. The reference's
per-thread greedy contig building (makeContig :705, extendToRight with
ownership claims) becomes a LOCKSTEP batched walk: every live contig
extends one base per step, with neighbor counts looked up by vectorized
binary search into the sorted k-mer spectrum and ownership claims resolved
deterministically (higher id wins, mirroring AbstractKmerTable.setOwner
race semantics :316-328).

Extension decision semantics are exact (SURVEY.md Appendix A.8):
  - DEAD_END if rightMax < minCountExtend
  - isJunction(max, second) = NOT(second<1 || second*branchMult1<max ||
      (second<=branchLowerConst && max>=max(minCountExtend,
      second*branchMult2)))  (Tadpole.java:2556-2560)
  - F_BRANCH / B_BRANCH / D_BRANCH / hidden-branch (left max != evicted)
  - LOOP via ownership self-collision; BAD_OWNER on losing a claim
  - contigs kept when length >= seedlen+minExtension and >= minContigLen
Defaults: minCountSeed=3, minCountExtend=2, branchMult1=20, branchMult2=3,
branchLowerConst=3, minExtension=2, minContigLen=max(124, 2k)
(Tadpole.java:2659-2680, :582).

The PyTorch port of bbtools_tpu/models/tadpole.py. The load counts on
the tool's device (`device=`, cuda by default): k <= 31 through
`count_batch` (the sort-reduce on the card, into the host
`KmerSpectrum`, as the JAX package pairs them), k > 31 through the
W-word device sort into the host `WordSpectrum`. The contig walk, the
graph cleanup and the error correction are host numpy, as in the JAX
package. With shards=N (k <= 31) the load counts into a spectrum
hash-sharded over N devices (parallel/sharded_spectrum.py).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np

from ..core.dna import CODE_TO_BASE
from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fasta import write_fasta
from ..io.stream import read_batches
from ..ops.kmer_count import KmerSpectrum, count_batch

# stop codes
DEAD_END, LOOP, BAD_SEED, BAD_OWNER, F_BRANCH, B_BRANCH, D_BRANCH = range(7)
RUNNING = 99


@dataclass
class TadpoleConfig:
    in1: str | None = None
    out: str | None = None
    k: int = 31
    min_count_seed: int = 3
    min_count_extend: int = 2
    branch_mult1: float = 20.0
    branch_mult2: float = 3.0
    branch_lower_const: int = 3
    min_extension: int = 2
    min_contig_len: int = -1
    max_contig_len: int = 1_000_000
    batch_reads: int = 16384
    walk_batch: int = 4096
    mode: str = "contig"  # contig | correct
    ecc_pincer: bool = True
    ecc_tail: bool = True
    extend_left: int = 0  # mode=extend: bases to extend on the left
    extend_right: int = 0  # mode=extend: bases to extend on the right
    shave: bool = False  # remove dead-end hair chains (Shaver.java role)
    rinse: bool = False  # remove bubble branches
    shave_depth: int = 1
    shave_len: int = 150
    #: shards=N: multi-chip load phase — kmer%N hash-sharded counting
    #: over a dp mesh (the reference's WAYS table split,
    #: kmer/KmerTableSet.java:273-285); byte-identical spectrum
    shards: int = 0
    #: the device of the load phase's counting: cuda or cpu
    device: str = "cuda"

    def resolve(self):
        if self.min_contig_len < 0:
            self.min_contig_len = max(124, 2 * self.k)
        return self


def parse_args(argv):
    a = tokenize(argv)
    c = TadpoleConfig()
    c.in1 = a.get("in", "in1")
    c.out = a.get("out", "outc", "contigs")
    c.k = a.get_int("k", default=31)
    mc = a.get_int("mincount", default=None)
    if mc is not None:
        c.min_count_seed = c.min_count_extend = mc
    c.min_count_seed = a.get_int("mincountseed", "mcs", default=c.min_count_seed)
    c.min_count_extend = a.get_int("mincountextend", "mce", default=c.min_count_extend)
    c.branch_mult1 = a.get_float("branchmult1", "bm1", default=20.0)
    c.branch_mult2 = a.get_float("branchmult2", "bm2", default=3.0)
    c.branch_lower_const = a.get_int("branchlower", "blc", default=3)
    c.min_contig_len = a.get_int("mincontig", default=-1) or -1
    c.min_extension = a.get_int("minextension", default=2)
    m = (a.get("mode") or "contig").lower()
    if m in ("correct", "ecc"):
        c.mode = "correct"
    elif m == "extend":
        c.mode = "extend"
    c.extend_left = a.get_int("el", "extendleft", default=0)
    c.extend_right = a.get_int("er", "extendright", default=0)
    if (c.extend_left or c.extend_right) and c.mode == "contig":
        c.mode = "extend"
    if a.get_bool("ecc", default=False):
        c.mode = "correct"
    c.ecc_pincer = a.get_bool("eccpincer", "pincer", default=True)
    c.ecc_tail = a.get_bool("ecctail", "tail", default=True)
    c.shave = a.get_bool("shave", default=False)
    c.rinse = a.get_bool("rinse", default=False)
    c.shave_depth = a.get_int("shavedepth", default=1)
    c.shave_len = a.get_int("shavelen", default=150)
    c.shards = a.get_int("shards", "tpshards", default=0)
    c.device = a.get("device") or "cuda"
    return c.resolve()


class SpectrumTable:
    """Sorted canonical-kmer counts with ownership (host)."""

    def __init__(self, spectrum: KmerSpectrum, k: int):
        spectrum.flush()
        self.k = k
        self.keys = spectrum.keys
        self.counts = spectrum.counts.astype(np.int64)
        self.owner = np.full(len(self.keys), -1, dtype=np.int64)
        self.mask = (1 << (2 * k)) - 1
        self.shift2 = 2 * (k - 1)

    def find(self, keys: np.ndarray) -> np.ndarray:
        """Index of each key in the table, or -1."""
        pos = np.searchsorted(self.keys, keys)
        pos = np.minimum(pos, max(len(self.keys) - 1, 0))
        hit = len(self.keys) > 0
        ok = hit & (self.keys[pos] == keys) if hit else np.zeros(len(keys), bool)
        return np.where(ok, pos, -1)

    def count_of(self, keys: np.ndarray) -> np.ndarray:
        idx = self.find(keys)
        return np.where(idx >= 0, self.counts[np.maximum(idx, 0)], 0)


def rc_kmer_arr(kmers: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros_like(kmers)
    x = kmers.copy()
    for _ in range(k):
        out = (out << 2) | (3 - (x & 3))
        x >>= 2
    return out


def second_highest_position(counts: np.ndarray) -> np.ndarray:
    """Tools.secondHighestPosition, vectorized over [A, 4]."""
    a = counts
    first0 = a[:, 0] >= a[:, 1]
    maxP = np.where(first0, 0, 1)
    maxP2 = np.where(first0, 1, 0)
    for i in (2, 3):
        x = a[:, i]
        cur2 = a[np.arange(len(a)), maxP2]
        cur1 = a[np.arange(len(a)), maxP]
        better2 = x > cur2
        better1 = better2 & (x >= cur1)
        maxP2 = np.where(better1, maxP, np.where(better2, i, maxP2))
        maxP = np.where(better1, i, maxP)
    return maxP2




class SmallKmerEngine:
    """k <= 31: single int64 registers."""

    def __init__(self, table: SpectrumTable, k: int):
        self.t = table
        self.k = k

    def from_buf(self, buf, lengths):
        A = len(lengths)
        kmer = np.zeros(A, dtype=np.int64)
        for j in range(self.k):
            col = lengths - self.k + j
            kmer = (kmer << 2) | buf[np.arange(A), np.maximum(col, 0)]
        kmer &= self.t.mask
        return {"k": kmer, "r": rc_kmer_arr(kmer, self.k)}

    def key(self, st, sel=None):
        k = st["k"] if sel is None else st["k"][sel]
        r = st["r"] if sel is None else st["r"][sel]
        return np.maximum(k, r)

    def advance_right(self, st, sel, x):
        t = self.t
        st["k"][sel] = ((st["k"][sel] << 2) | x) & t.mask
        st["r"][sel] = (st["r"][sel] >> 2) | ((3 - x) << t.shift2)

    def evicted(self, st, sel):
        return st["k"][sel] >> self.t.shift2

    def neighbor_counts(self, st, sel, side):
        t = self.t
        kmer = st["k"][sel]
        rkmer = st["r"][sel]
        if side == "right":
            km = (kmer << 2) & t.mask
            rk = rkmer >> 2
            cand_k = km[:, None] | np.arange(4, dtype=np.int64)[None, :]
            cand_r = rk[:, None] | (
                (3 - np.arange(4, dtype=np.int64))[None, :] << t.shift2
            )
        else:
            rk = (rkmer << 2) & t.mask
            km = kmer >> 2
            cand_r = rk[:, None] | (3 - np.arange(4, dtype=np.int64))[None, :]
            cand_k = km[:, None] | (
                np.arange(4, dtype=np.int64)[None, :] << t.shift2
            )
        keys = np.maximum(cand_k, cand_r)
        return t.count_of(keys.reshape(-1)).reshape(-1, 4)


class WordSpectrumTable:
    """Sorted exact W-word keys (big-endian byte strings) with counts and
    ownership — the KmerTableSetU analog for k > 31. No hashing: distinct
    k-mers can never collide (ukmer/Kmer.java:17 multi-long exactness)."""

    def __init__(self, spectrum, k: int):
        spectrum.flush()
        self.k = k
        self.W = spectrum.W
        self.keys = spectrum.keys  # 'S8W', sorted
        self.counts = spectrum.counts.astype(np.int64)
        self.owner = np.full(len(self.keys), -1, dtype=np.int64)

    def find(self, keys: np.ndarray) -> np.ndarray:
        if len(self.keys) == 0:
            return np.full(len(keys), -1, np.int64)
        pos = np.searchsorted(self.keys, keys)
        pos = np.minimum(pos, len(self.keys) - 1)
        ok = self.keys[pos] == keys
        return np.where(ok, pos, -1)

    def count_of(self, keys: np.ndarray) -> np.ndarray:
        idx = self.find(keys)
        return np.where(idx >= 0, self.counts[np.maximum(idx, 0)], 0)


class WordKmerEngine:
    """k > 31: exact W-word registers [A, W] (word 0 = newest 31 bases,
    top word = oldest t bases), rc registers in the same layout. All walk
    lookups use the exact sorted byte-key table — the hashed-canon engine
    this replaces could silently merge distinct kmers on collisions."""

    def __init__(self, table: WordSpectrumTable, k: int):
        from ..ops.kmers2 import n_words

        self.t = table
        self.k = k
        self.W = n_words(k)
        self.tbits = 2 * (k - 31 * (self.W - 1))  # top word bits
        self.full_mask = np.int64((1 << 62) - 1)
        self.top_mask = np.int64((1 << self.tbits) - 1)

    def _shift_left(self, w, x):
        """Append base x at the new end (words shift left one base)."""
        out = np.empty_like(w)
        for i in range(self.W - 1, 0, -1):
            m = self.top_mask if i == self.W - 1 else self.full_mask
            out[:, i] = ((w[:, i] << 2) | (w[:, i - 1] >> 60)) & m
        out[:, 0] = ((w[:, 0] << 2) | x) & self.full_mask
        return out

    def _shift_right(self, w, x_top):
        """Drop the newest base; push x_top in at the old end."""
        out = np.empty_like(w)
        for i in range(self.W - 1):
            out[:, i] = (w[:, i] >> 2) | ((w[:, i + 1] & 3) << 60)
        out[:, self.W - 1] = (w[:, self.W - 1] >> 2) | (
            np.asarray(x_top, dtype=np.int64) << (self.tbits - 2)
        )
        return out

    def from_buf(self, buf, lengths):
        A = len(lengths)
        w = np.zeros((A, self.W), dtype=np.int64)
        rw = np.zeros((A, self.W), dtype=np.int64)
        rows = np.arange(A)
        for j in range(self.k):
            col = lengths - self.k + j
            b = buf[rows, np.maximum(col, 0)].astype(np.int64)
            w = self._shift_left(w, b)
            rw = self._shift_right(rw, 3 - b)
        return {"w": w, "rw": rw}

    def key(self, st, sel=None):
        from ..ops.kmers2 import canonical_words, words_to_bytes

        w = st["w"] if sel is None else st["w"][sel]
        rw = st["rw"] if sel is None else st["rw"][sel]
        return words_to_bytes(canonical_words(w, rw))

    def advance_right(self, st, sel, x):
        st["w"][sel] = self._shift_left(st["w"][sel], x)
        st["rw"][sel] = self._shift_right(st["rw"][sel], 3 - x)

    def evicted(self, st, sel):
        return st["w"][sel][:, self.W - 1] >> (self.tbits - 2)

    def neighbor_counts(self, st, sel, side):
        from ..ops.kmers2 import canonical_words, words_to_bytes

        w, rw = st["w"][sel], st["rw"][sel]
        counts = np.zeros((len(w), 4), dtype=np.int64)
        for x in range(4):
            if side == "right":
                nw = self._shift_left(w, np.int64(x))
                nrw = self._shift_right(rw, np.int64(3 - x))
            else:
                nw = self._shift_right(w, np.int64(x))
                nrw = self._shift_left(rw, np.int64(3 - x))
            keys = words_to_bytes(canonical_words(nw, nrw))
            counts[:, x] = self.t.count_of(keys)
        return counts


class Tadpole:
    def __init__(self, cfg: TadpoleConfig):
        self.cfg = cfg
        self.table: SpectrumTable | None = None
        self.contigs: list[bytes] = []
        self.cov: list[float] = []

    # ------------------------------------------------------------------
    def load_kmers(self, path: str):
        device = resolve_device(self.cfg.device)
        t0 = time.time()
        # load phase counts kmers only — skip the ascii AND quality
        # planes (the correction/extend passes later re-read with quals)
        reader = read_batches(path, batch_reads=self.cfg.batch_reads,
                              with_ascii=False, with_quals=False)
        big = self.cfg.k > 31
        if big:
            from ..ops.kmers2 import WordSpectrum, count_batchw_exact

            spec = WordSpectrum(self.cfg.k)
            for b in reader:
                keys, c = count_batchw_exact(
                    b.bases, b.lengths.astype(np.int64), self.cfg.k, device
                )
                spec.add_batch(keys, c)
            spec.flush()
            self.reads_in = reader.reads_in
            self.table = WordSpectrumTable(spec, self.cfg.k)
            self.engine = WordKmerEngine(self.table, self.cfg.k)
        else:
            spec = KmerSpectrum(self.cfg.k)
            if self.cfg.shards > 1:
                # multi-device load: hash-sharded spectrum over a dp mesh
                # (kmer%N ownership, the reference's WAYS split,
                # kmer/KmerTableSet.java:273-285); the merged spectrum is
                # the same, so everything downstream is unchanged
                from ..parallel.mesh import local_devices, make_mesh
                from ..parallel.sharded_spectrum import ShardedSpectrum

                mesh = make_mesh(
                    n_dp=self.cfg.shards,
                    devices=local_devices(device)[: self.cfg.shards],
                )
                sspec = ShardedSpectrum(mesh, self.cfg.k)
                for b in reader:
                    sspec.add_batch(b.bases, b.lengths)
                kk, cc = sspec.spectrum()
                if len(kk):
                    spec.add_batch(kk, cc)
            else:
                for b in reader:
                    v, c = count_batch(b.bases, b.lengths, self.cfg.k, device)
                    spec.add_batch(v, c)
            spec.flush()
            self.reads_in = reader.reads_in
            self.table = SpectrumTable(spec, self.cfg.k)
            if self.cfg.shave or self.cfg.rinse:
                removed = self.shave_rinse()
                if removed:
                    print(f"Shaved kmers:        \t{removed}",
                          file=sys.stderr)
            self.engine = SmallKmerEngine(self.table, self.cfg.k)
        self.in_path = path
        #: the load's wall seconds (count, spectrum, shave/rinse)
        self.load_seconds = time.time() - t0

    def shave_rinse(self) -> int:
        """Graph cleanup before assembly (assemble/Shaver.java role):
        shave removes dead-end 'hair' — maximal unbranched chains of
        low-count kmers ending in a tip — and rinse removes low-count
        bubble branches (unbranched chains bounded by branch nodes on
        both sides). Operates directly on the sorted spectrum arrays;
        neighbor degrees come from batched canonical lookups."""
        cfg = self.cfg
        t = self.table
        k = cfg.k
        keys = t.keys
        counts = t.counts
        low = counts <= cfg.shave_depth
        if not low.any():
            return 0
        fwd = keys.astype(np.int64)
        rkm = rc_kmer_arr(fwd, k)

        lc, lcanon = self._neighbor_counts(fwd, rkm, "left")
        rc_, rcanon = self._neighbor_counts(fwd, rkm, "right")
        ldeg = (lc > 0).sum(axis=1)
        rdeg = (rc_ > 0).sum(axis=1)
        # walk from tips (shave) and from branch-adjacent low chains (rinse)
        key_index = {int(x): i for i, x in enumerate(keys[low])}
        # global index map for chain walking
        all_index = {int(x): i for i, x in enumerate(keys)}
        dead = np.zeros(len(keys), dtype=bool)
        starts = []
        if cfg.shave:
            starts += list(np.flatnonzero(low & ((ldeg == 0) | (rdeg == 0))))
        if cfg.rinse:
            starts += list(
                np.flatnonzero(low & (ldeg >= 1) & (rdeg >= 1))
            )
        for si in starts:
            if dead[si]:
                continue
            chain = [si]
            ok = True
            # walk in both open directions while unbranched and low
            for side0 in ("left", "right"):
                cur = si
                steps = 0
                while steps < cfg.shave_len:
                    deg = ldeg[cur] if side0 == "left" else rdeg[cur]
                    if deg == 0:
                        break  # tip end
                    if deg > 1:
                        break  # bounded by a branch: chain ends here
                    canon_row = (lcanon if side0 == "left" else rcanon)[cur]
                    crow = (lc if side0 == "left" else rc_)[cur]
                    nxt_key = int(canon_row[int(np.argmax(crow > 0))])
                    j = all_index.get(nxt_key, -1)
                    if j < 0 or not low[j]:
                        break  # enters solid graph: stop (boundary)
                    if j in chain[-3:] or dead[j]:
                        break
                    chain.append(j)
                    cur = j
                    steps += 1
                else:
                    ok = False  # chain too long: not hair
            if ok and len(chain) <= cfg.shave_len:
                dead[chain] = True
        n = int(dead.sum())
        if n:
            keep = ~dead
            t.keys = keys[keep]
            t.counts = counts[keep]
        return n

    # ------------------------------------------------------------------
    def _neighbor_counts(self, kmer, rkmer, side: str):
        """counts [A,4] + candidate keys for left/right neighbors."""
        t = self.table
        k = self.cfg.k
        if side == "right":
            km = (kmer << 2) & t.mask
            rk = rkmer >> 2
            cand_k = km[:, None] | np.arange(4, dtype=np.int64)[None, :]
            cand_r = rk[:, None] | (
                (3 - np.arange(4, dtype=np.int64))[None, :] << t.shift2
            )
        else:
            rk = (rkmer << 2) & t.mask
            km = kmer >> 2
            cand_r = rk[:, None] | (3 - np.arange(4, dtype=np.int64))[None, :]
            cand_k = km[:, None] | (
                np.arange(4, dtype=np.int64)[None, :] << t.shift2
            )
        keys = np.maximum(cand_k, cand_r)
        counts = t.count_of(keys.reshape(-1)).reshape(-1, 4)
        return counts, keys

    def _extend_right_lockstep(self, buf, lengths, ids, active):
        """Extend all active contigs rightward until each stops.

        buf: uint8 [A, maxlen] contig bases (codes); lengths [A];
        ids [A] ownership ids. Returns stop codes [A].
        """
        cfg = self.cfg
        t = self.table
        k = cfg.k
        A = len(lengths)
        eng = self.engine
        status = np.full(A, RUNNING, dtype=np.int64)
        status[~active] = BAD_SEED
        st = eng.from_buf(buf, lengths)
        key = eng.key(st)
        idx = t.find(key)
        cnt = np.where(idx >= 0, t.counts[np.maximum(idx, 0)], 0)
        status[(status == RUNNING) & (cnt < cfg.min_count_seed)] = BAD_SEED
        # initial owner check: owner > id -> BAD_OWNER
        own = np.where(idx >= 0, t.owner[np.maximum(idx, 0)], -1)
        status[(status == RUNNING) & (own > ids)] = BAD_OWNER
        live = status == RUNNING
        # initial neighbor counts
        lc = eng.neighbor_counts(st, slice(None), "left")
        rc = eng.neighbor_counts(st, slice(None), "right")
        l_max_pos = np.argmax(lc, axis=1)
        l_max = lc[np.arange(A), l_max_pos]
        l_second = lc[np.arange(A), second_highest_position(lc)]
        r_max_pos = np.argmax(rc, axis=1)
        r_max = rc[np.arange(A), r_max_pos]
        r_second = rc[np.arange(A), second_highest_position(rc)]
        jr = self._is_junction(r_max, r_second)
        jl = self._is_junction(l_max, l_second)
        dead = live & (r_max < cfg.min_count_extend)
        status[dead] = DEAD_END
        live &= ~dead
        br = live & jr
        status[br] = np.where(jl[br], D_BRANCH, F_BRANCH)
        live &= ~br
        bl = live & jl
        status[bl] = B_BRANCH
        live &= ~bl
        # claim the seed kmer: higher id wins
        self._claim(idx, ids, live)
        claimed_ok = np.where(idx >= 0, t.owner[np.maximum(idx, 0)], -1) == ids
        lost = live & ~claimed_ok
        status[lost] = BAD_OWNER
        live &= ~lost
        maxlen = buf.shape[1]
        while live.any():
            la = np.flatnonzero(live)
            # advance kmer by the chosen right base
            x = r_max_pos[la]
            evicted = eng.evicted(st, la)
            eng.advance_right(st, la, x)
            key = eng.key(st, la)
            idx_n = t.find(key)
            lc = eng.neighbor_counts(st, la, "left")
            rc = eng.neighbor_counts(st, la, "right")
            lmp = np.argmax(lc, axis=1)
            lmx = lc[np.arange(len(la)), lmp]
            lsc = lc[np.arange(len(la)), second_highest_position(lc)]
            rmp = np.argmax(rc, axis=1)
            rmx = rc[np.arange(len(la)), rmp]
            rsc = rc[np.arange(len(la)), second_highest_position(rc)]
            fbranch = self._is_junction(rmx, rsc)
            bbranch = self._is_junction(lmx, lsc)
            hbranch = (lmp != evicted) & (cfg.branch_mult1 > 0)
            stop_b = bbranch | hbranch
            code_b = np.where(fbranch, D_BRANCH, B_BRANCH)
            status[la[stop_b]] = code_b[stop_b]
            go = ~stop_b
            ga = la[go]
            # append base
            can_append = lengths[ga] < maxlen
            status[ga[~can_append]] = DEAD_END
            ga = ga[can_append]
            buf[ga, lengths[ga]] = x[go][can_append]
            lengths[ga] += 1
            # ownership: loop detection + claim
            ii = idx_n[go][can_append]
            cur_owner = np.where(ii >= 0, t.owner[np.maximum(ii, 0)], -1)
            is_loop = cur_owner == ids[ga]
            status[ga[is_loop]] = np.where(
                fbranch[go][can_append][is_loop], F_BRANCH, LOOP
            )
            rest = ~is_loop
            ra = ga[rest]
            self._claim(ii[rest], ids[ra], np.ones(len(ra), bool))
            lost = np.where(ii[rest] >= 0, t.owner[np.maximum(ii[rest], 0)], -1) != ids[ra]
            status[ra[lost]] = BAD_OWNER
            keep = ra[~lost]
            # forward branch / dead-end checks (post-append)
            fb = fbranch[go][can_append][rest][~lost]
            de = rmx[go][can_append][rest][~lost] < cfg.min_count_extend
            status[keep[fb]] = F_BRANCH
            status[keep[~fb & de]] = DEAD_END
            # update live set and rolling state
            live = status == RUNNING
            # carry decision state for next iteration (only live entries used)
            r_max_pos_full = np.zeros(A, dtype=np.int64)
            r_max_pos_full[la] = rmp
            r_max_pos = r_max_pos_full
        return status

    def _is_junction(self, mx, second):
        cfg = self.cfg
        not_j = (
            (second < 1)
            | (second * cfg.branch_mult1 < mx)
            | (
                (second <= cfg.branch_lower_const)
                & (mx >= np.maximum(cfg.min_count_extend, second * cfg.branch_mult2))
            )
        )
        return ~not_j

    def _claim(self, idx, ids, mask):
        """Higher id wins (setOwner semantics). Resolves same-step
        conflicts deterministically via np.maximum.at."""
        t = self.table
        ok = mask & (idx >= 0)
        np.maximum.at(t.owner, idx[ok], ids[ok])

    # ------------------------------------------------------------------
    def build_contigs(self):
        if self.cfg.k > 31:
            return self.build_contigs_bigk()
        cfg = self.cfg
        t = self.table
        seeds = np.flatnonzero(t.counts >= cfg.min_count_seed)
        # process highest-count seeds first (deterministic; reference order
        # is hash-table iteration, which is arbitrary but fixed)
        order = np.argsort(-t.counts[seeds], kind="stable")
        seeds = seeds[order]
        k = cfg.k
        maxlen = cfg.max_contig_len
        contig_id = 1
        W = cfg.walk_batch
        next_id = 1
        for w0 in range(0, len(seeds), W):
            chunk = seeds[w0 : w0 + W]
            # skip seeds already claimed
            unclaimed = t.owner[chunk] < 0
            chunk = chunk[unclaimed]
            if not len(chunk):
                continue
            A = len(chunk)
            ids = np.arange(next_id, next_id + A, dtype=np.int64)
            next_id += A
            buf = np.zeros((A, min(maxlen, 1 << 20)), dtype=np.uint8)
            lengths = np.full(A, k, dtype=np.int64)
            keys = t.keys[chunk]
            for j in range(k):
                buf[:, k - 1 - j] = (keys >> (2 * j)) & 3
            active = np.ones(A, bool)
            self._extend_right_lockstep(buf, lengths, ids, active)
            # reverse-complement in place, extend again
            for a in range(A):
                n = int(lengths[a])
                seg = buf[a, :n]
                buf[a, :n] = 3 - seg[::-1]
            self._extend_right_lockstep(buf, lengths, ids, active)
            for a in range(A):
                n = int(lengths[a])
                if n >= k + cfg.min_extension and n >= cfg.min_contig_len:
                    seg = buf[a, :n]
                    rcseg = 3 - seg[::-1]
                    cov = float(
                        t.count_of(
                            _contig_keys(rcseg, k, t.mask)
                        ).mean()
                    )
                    self.contigs.append(bytes(CODE_TO_BASE[rcseg]))
                    self.cov.append(cov)
        # sort by length desc (processContigs)
        order = sorted(
            range(len(self.contigs)),
            key=lambda i: (-len(self.contigs[i]), self.contigs[i]),
        )
        self.contigs = [self.contigs[i] for i in order]
        self.cov = [self.cov[i] for i in order]

    def build_contigs_bigk(self):
        """k > 31: seeds come from reads (the word table is byte-keyed so
        kmer text is recoverable, but read windows are cheaper); one best
        seed window per read, claims dedupe the rest."""
        from ..ops.kmers2 import (
            canonical_words,
            rolling_kmersw_np,
            words_to_bytes,
        )

        cfg = self.cfg
        t = self.table
        k = cfg.k
        W = cfg.walk_batch
        next_id = 1
        pend_bufs = []
        reader = read_batches(self.in_path, batch_reads=cfg.batch_reads)
        for b in reader:
            words, rwords, runlen = rolling_kmersw_np(b.bases, k)
            i_idx = np.arange(b.bases.shape[1])[None, :]
            valid = (runlen >= k) & (i_idx < b.lengths[:, None])
            keys = words_to_bytes(canonical_words(words, rwords))
            counts = np.where(
                valid, t.count_of(keys.reshape(-1)).reshape(keys.shape), 0
            )
            best_pos = counts.argmax(axis=1)
            best_cnt = counts[np.arange(b.n), best_pos]
            for i in np.flatnonzero(best_cnt >= cfg.min_count_seed):
                end = int(best_pos[i])
                seed = b.bases[i, end - k + 1 : end + 1]
                pend_bufs.append(np.array(seed, dtype=np.uint8))
            while len(pend_bufs) >= W:
                next_id = self._walk_seed_batch(pend_bufs[:W], next_id)
                pend_bufs = pend_bufs[W:]
        if pend_bufs:
            next_id = self._walk_seed_batch(pend_bufs, next_id)
        order = sorted(
            range(len(self.contigs)),
            key=lambda i: (-len(self.contigs[i]), self.contigs[i]),
        )
        self.contigs = [self.contigs[i] for i in order]
        self.cov = [self.cov[i] for i in order]

    def _walk_seed_batch(self, seeds: list, next_id: int) -> int:
        cfg = self.cfg
        t = self.table
        k = cfg.k
        A = len(seeds)
        # skip claimed seeds
        st = None
        ids = np.arange(next_id, next_id + A, dtype=np.int64)
        next_id += A
        buf = np.zeros((A, min(cfg.max_contig_len, 1 << 20)), dtype=np.uint8)
        lengths = np.full(A, k, dtype=np.int64)
        for a, seed in enumerate(seeds):
            buf[a, :k] = seed
        active = np.ones(A, bool)
        # drop seeds whose key is already owned
        key = self.engine.key(self.engine.from_buf(buf, lengths))
        idx = t.find(key)
        owned = np.where(idx >= 0, t.owner[np.maximum(idx, 0)], -1) >= 0
        active &= ~owned
        if active.any():
            self._extend_right_lockstep(buf, lengths, ids, active)
            for a in range(A):
                n = int(lengths[a])
                seg = buf[a, :n]
                buf[a, :n] = 3 - seg[::-1]
            self._extend_right_lockstep(buf, lengths, ids, active)
            from ..ops.kmers2 import (
                canonical_words,
                rolling_kmersw_np,
                words_to_bytes,
            )

            for a in np.flatnonzero(active):
                n = int(lengths[a])
                if n >= k + cfg.min_extension and n >= cfg.min_contig_len:
                    seg = buf[a, :n]
                    rcseg = 3 - seg[::-1]
                    w, rw, rl = rolling_kmersw_np(rcseg[None, :], k)
                    ck = words_to_bytes(canonical_words(w, rw))[0][rl[0] >= k]
                    cov = float(t.count_of(ck).mean()) if len(ck) else 0.0
                    self.contigs.append(bytes(CODE_TO_BASE[rcseg]))
                    self.cov.append(cov)
        return next_id

    # ------------------------------------------------------------------
    def run(self):
        cfg = self.cfg
        if cfg.mode == "correct":
            return self.run_correct()
        if cfg.mode == "extend":
            return self.run_extend()
        t0 = time.time()
        self.load_kmers(cfg.in1)
        self.build_contigs()
        if cfg.out:
            write_fasta(
                cfg.out,
                [
                    (
                        b"contig_%d,length=%d,cov=%.1f" % (i + 1, len(c), cv),
                        c,
                    )
                    for i, (c, cv) in enumerate(zip(self.contigs, self.cov))
                ],
            )
        self.elapsed = time.time() - t0
        return self

    def run_correct(self):
        """mode=correct: count input kmers, then stream the reads back
        through the ecc engine (Tadpole.java processReadPair ecc path
        :1800-1812) and write corrected reads."""
        from ..io.fastq import FastqWriter
        from .tadpole_ecc import EccConfig, EccEngine

        cfg = self.cfg
        t0 = time.time()
        self.load_kmers(cfg.in1)
        ecc = EccEngine(
            self.table,
            cfg.k,
            EccConfig(pincer=cfg.ecc_pincer, tail=cfg.ecc_tail),
        )
        self.ecc = ecc
        writer = FastqWriter(cfg.out) if cfg.out else None
        reader = read_batches(cfg.in1, batch_reads=cfg.batch_reads)
        total_corr = 0
        for b in reader:
            nc = ecc.correct_batch(b.bases, b.lengths, b.quals)
            total_corr += int(nc.sum())
            if writer is not None:
                changed = nc > 0
                if changed.any():
                    from ..core.dna import CODE_TO_BASE

                    for i in np.nonzero(changed)[0]:
                        L = int(b.lengths[i])
                        if b.ascii_bases is not None:
                            b.ascii_bases[i, :L] = CODE_TO_BASE[
                                np.minimum(b.bases[i, :L], 4)
                            ]
                writer.add(b)
        if writer is not None:
            writer.close()
        self.errors_corrected = total_corr
        self.elapsed = time.time() - t0
        print(
            f"Errors corrected:     \t{total_corr} "
            f"(pincer {ecc.stats['errors_corrected_pincer']}, "
            f"tail {ecc.stats['errors_corrected_tail']}, "
            f"reassemble {ecc.stats.get('errors_corrected_reassemble', 0)}, "
            f"rollbacks {ecc.stats['rollbacks']})",
            file=sys.stderr,
        )
        return self

    def print_stats(self, stream=None):
        if stream is None:
            stream = sys.stderr
        if self.cfg.mode == "correct":
            print(f"Reads In:             \t{self.reads_in}", file=stream)
            return
        lens = np.array([len(c) for c in self.contigs], dtype=np.int64)
        total = int(lens.sum())
        print(f"Contigs generated:    \t{len(self.contigs)}", file=stream)
        print(f"Contig length sum:    \t{total}", file=stream)
        if len(lens):
            half = total / 2
            csum = np.cumsum(lens)
            n50 = int(lens[np.searchsorted(csum, half)])
            print(f"Contig N50:           \t{n50}", file=stream)


def _contig_keys(codes: np.ndarray, k: int, mask: int) -> np.ndarray:
    from ..ops.kmers import rolling_kmers_np

    fwd, rkm, runlen = rolling_kmers_np(codes[None, :], k)
    valid = runlen[0] >= k
    return np.maximum(fwd[0][valid], rkm[0][valid])


def _tadpole_extend_impl(self):
    """mode=extend (Tadpole.java extendRead role): greedily extend each
    read left/right through the kmer graph (el=/er=), stopping at
    branches or dead ends — the engine behind bbmerge extend2, exposed
    as a read-mode tool."""
    cfg = self.cfg
    t0 = time.time()
    self.load_kmers(cfg.in1)
    from ..io.fastq import FastqWriter
    from .tadpole_ecc import EccEngine

    eng = EccEngine(self.table, cfg.k)
    k = cfg.k
    mask = (1 << (2 * k)) - 1
    n_ext = 0
    reader = read_batches(cfg.in1, batch_reads=cfg.batch_reads)
    with FastqWriter(cfg.out) as w:
        for b in reader:
            seqs, quals, ids = [], [], []
            for i in range(b.n):
                n = int(b.lengths[i])
                codes = b.bases[i, :n].copy()
                q = b.quals[i, :n].copy() if b.quals is not None else None
                ext_r = ext_l = 0
                if cfg.extend_right > 0 and n >= k and (codes[-k:] < 4).all():
                    km = 0
                    for x in codes[-k:]:
                        km = ((km << 2) | int(x)) & mask
                    bases_r, ext_r = eng._extend_right(km, cfg.extend_right)
                    if ext_r:
                        codes = np.concatenate(
                            [codes, np.array(bases_r[:ext_r], np.uint8)]
                        )
                if cfg.extend_left > 0 and n >= k and (codes[:k] < 4).all():
                    rcodes = np.where(codes < 4, 3 - codes, 4)[::-1]
                    km = 0
                    for x in rcodes[-k:]:
                        km = ((km << 2) | int(x)) & mask
                    bases_l, ext_l = eng._extend_right(km, cfg.extend_left)
                    if ext_l:
                        add = np.where(
                            np.array(bases_l[:ext_l], np.uint8) < 4,
                            3 - np.array(bases_l[:ext_l], np.uint8), 4,
                        )[::-1]
                        codes = np.concatenate([add, codes])
                if ext_r or ext_l:
                    n_ext += 1
                from ..core.dna import CODE_TO_BASE

                seqs.append(CODE_TO_BASE[np.minimum(codes, 4)].tobytes())
                if q is not None:
                    quals.append(
                        bytes([30 + 33] * ext_l)
                        + (q + 33).tobytes()
                        + bytes([30 + 33] * (len(codes) - n - ext_l))
                    )
                ids.append(b.ids[i])
            from ..io.batch import ReadBatch

            nb = ReadBatch.from_sequences(
                seqs, quals=quals if quals else None, ids=ids,
                ordinal=b.ordinal,
            )
            w.add(nb)
    self.reads_in = reader.reads_in
    self.elapsed = time.time() - t0
    print(f"Reads Extended:      \t{n_ext}", file=sys.stderr)
    return self


Tadpole.run_extend = _tadpole_extend_impl


def main(argv=None):
    cfg = parse_args(argv if argv is not None else sys.argv[1:])
    tool = Tadpole(cfg)
    tool.run()
    tool.print_stats()
    return tool


if __name__ == "__main__":
    main()
