"""Micro-aligner: lightweight alignment of reads against a tiny reference
(phiX-style side channel).

The PyTorch port of bbtools_tpu/ops/microalign.py, itself a re-design of
aligner/MicroIndex3.java (indexRef :113-151, map :165-237) +
MicroAligner3.java (map :67-92, quickAlign :156-190) + SideChannel4.java
(:24-135). The reference maps each read by scanning its k-mers until the
first index hit, derives a single candidate (offset, strand), then
verifies with a direct base comparison (quickAlign) or a flat-penalty
glocal DP fallback. Here the whole batch resolves in one bucketed table
lookup + one windowed gather, torch on the device of its tensors:

  micro_map_batch  — rolling canonical kmers -> ONE batched lookup
                     (ops/kmer_index.BucketKmerIndex.lookup) -> first-hit
                     selection + orientation/offset decode
  quick_align_batch — per-read ref window gather + vectorized compare
                     (subs/Ns/clip counts, flat identity)

The index build (`MicroIndex.build`) and the DP fallback
(SingleStateAlignerFlat2 analog, host, for the few reads that kmer-hit
but fail the quick gate) are the JAX package's, unchanged. All device
arithmetic is int32/int64 and float64 in the JAX package's order, so the
two agree to the bit.

Deviation note: the reference's quickAlign computes `id` as an error
ratio yet compares it to minIdentity (MicroAligner3.java:184), which
makes the fast path almost never accept and routes everything to the DP.
We implement the evident intent (flat identity = (m + 0.25*N) /
(m + subs + N), Read.identityFlat :1916-1983) so the fast path works;
the accepted read set is gated on the same minid either way.
"""


from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .kmer_index import BucketKmerIndex
from .kmers import middle_mask, rolling_kmers, rolling_kmers_np

NO_HIT = np.int32(-(1 << 30))


@dataclass(frozen=True)
class MicroCfg:
    k: int
    mid_mask: int  # middle-mask bits (already a bitmask), -1 = none
    nb: int
    min_id: float
    ref_len: int


@dataclass
class MicroIndex:
    """Tiny-reference kmer index: canonical masked kmer -> (end_pos<<1|neg).

    Mirrors MicroIndex3.indexRef: value holds the position of the kmer's
    LAST base in the reference plus a strand bit (the reference adds
    MINUS_CODE when rkmer>kmer at index time; we pack a low bit instead).
    First insertion wins on duplicate keys.
    """

    cfg: MicroCfg
    index: BucketKmerIndex
    ref_codes: np.ndarray  # uint8 [ref_len]
    name: bytes

    @staticmethod
    def build(
        ref_codes: np.ndarray,
        k: int,
        mid_mask_len: int = 0,
        min_id: float = 0.66,
        name: bytes = b"ref",
    ) -> "MicroIndex":
        ref_codes = np.asarray(ref_codes, dtype=np.uint8)
        mm = middle_mask(k, mid_mask_len) if mid_mask_len > 0 else -1
        fwd, rkm, runlen = rolling_kmers_np(ref_codes[None, :], k)
        fwd, rkm, runlen = fwd[0], rkm[0], runlen[0]
        valid = runlen >= k
        pos = np.nonzero(valid)[0]
        f, r = fwd[pos], rkm[pos]
        keys = (np.maximum(f, r) & np.int64(mm)).astype(np.int64)
        neg = (r > f).astype(np.int64)
        vals = ((pos.astype(np.int64) << 1) | neg).astype(np.int32)
        # first insertion wins; +1 so value 0 stays the miss sentinel
        uk, first = np.unique(keys, return_index=True)
        idx = BucketKmerIndex.build(uk, vals[first] + 1)
        cfg = MicroCfg(
            k=k, mid_mask=mm, nb=idx.nb, min_id=min_id,
            ref_len=len(ref_codes),
        )
        return MicroIndex(cfg=cfg, index=idx, ref_codes=ref_codes, name=name)

    def device_tables(self, device):
        """(keys, ids, ref_codes) as tensors on `device`."""
        return self.index.device_arrays(device) + (
            torch.from_numpy(self.ref_codes).to(device),
        )


def micro_map_batch(cfg: MicroCfg, keys_tbl, ids_tbl, bases, lengths):
    """MicroIndex3.map for a whole batch: first kmer hit in scan order
    decides (offset, strand). bases uint8 [B, L], lengths int32 [B], the
    tables of `MicroIndex.device_tables`, all on one device. Returns
    (hit bool [B], offset int32 [B], strand int32 [B])."""
    B, L = bases.shape
    dev = bases.device
    fwd, rkm, runlen = rolling_kmers(bases, cfg.k)
    i_idx = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    eligible = (runlen >= cfg.k) & (i_idx < lengths[:, None])
    mx = torch.maximum(fwd, rkm)
    q = mx & cfg.mid_mask
    v = BucketKmerIndex.lookup(keys_tbl, ids_tbl, cfg.nb, q)
    hitpos = eligible & (v > 0)
    any_hit = hitpos.any(dim=1)
    # scan order: the first maximal index of an int8 plane
    first = torch.argmax(hitpos.to(torch.int8), dim=1)
    rows = torch.arange(B, device=dev)
    val = v[rows, first] - 1  # undo the +1 sentinel shift
    end_pos = val >> 1
    stored_neg = (val & 1) == 1
    plus_q = fwd[rows, first] >= rkm[rows, first]
    i = first.to(torch.int32)
    Ln = lengths.to(torch.int32)
    k2 = cfg.k - 1
    # orientation table (MicroIndex3.map :196-221):
    #   stored_neg &  plus_q -> strand 1, offset = end - k2 - (L - i - 1)
    #   stored_neg & !plus_q -> strand 0, offset = end - i
    #  !stored_neg &  plus_q -> strand 0, offset = end - i
    #  !stored_neg & !plus_q -> strand 1, offset = end - k2 - (L - i - 1)
    minus = stored_neg == plus_q
    off_minus = end_pos - k2 - (Ln - i - 1)
    off_plus = end_pos - i
    offset = torch.where(minus, off_minus, off_plus).to(torch.int32)
    strand = minus.to(torch.int32)
    return any_hit, torch.where(any_hit, offset, int(NO_HIT)), strand


def quick_align_batch(cfg: MicroCfg, ref_codes, bases, lengths, offsets,
                      strand):
    """MicroAligner3.quickAlign, batched: compare each read (rcomp'd when
    strand=1) against ref[offset : offset+L]; reference positions outside
    the reference count as clipped. Returns per read:
      quick_ok  — subs<=3 and matches*4 >= len (fast accept gate)
      identity  — flat identity (m + 0.25*N)/(m + subs + N), float64
      subs, ns, clipped counts (for match-string rebuild on host)
    """
    B, L = bases.shape
    dev = bases.device
    i32 = torch.int32
    codes = bases.to(i32)
    # reverse-complement the read for minus-strand candidates; padding
    # (beyond length) stays at the tail either way
    pos = torch.arange(L, dtype=i32, device=dev)[None, :]
    rc_idx = torch.clamp(lengths[:, None] - 1 - pos, 0, L - 1).long()
    rc = torch.gather(codes, 1, rc_idx)
    rc = torch.where(rc < 4, 3 - rc, rc)
    eff = torch.where(strand[:, None] == 1, rc, codes)
    j = offsets[:, None] + pos  # ref coordinate per read base
    inb = (j >= 0) & (j < cfg.ref_len)
    jc = torch.clamp(j, 0, cfg.ref_len - 1).long()
    refb = ref_codes[jc].to(i32)  # one gather
    live = pos < lengths[:, None]
    is_n = live & inb & (eff >= 4)
    is_clip = live & ~inb
    is_m = live & inb & ~is_n & ((refb >= 4) | (refb == eff))
    is_s = live & inb & ~is_n & ~is_m
    subs = is_s.sum(dim=1, dtype=i32)
    ns = is_n.sum(dim=1, dtype=i32)
    clip = is_clip.sum(dim=1, dtype=i32)
    m = is_m.sum(dim=1, dtype=i32)
    quick_ok = (subs <= 3) & (m * 4 >= lengths)
    # float64, as the JAX package computes it (int32 + a Python float
    # under its 64-bit mode)
    good2 = m.double() + 0.25 * ns.double()
    bad2 = subs.double() + 0.75 * ns.double()
    identity = good2 / torch.clamp(good2 + bad2, min=1.0)
    return {
        "quick_ok": quick_ok,
        "identity": identity,
        "subs": subs,
        "ns": ns,
        "clip": clip,
        "matches": m,
    }


def quick_match_string(read_codes: np.ndarray, ref_codes: np.ndarray,
                       offset: int) -> bytes:
    """Host rebuild of the quickAlign match string (m/S/N/C) for SAM
    emission of one accepted read."""
    out = bytearray()
    for i, q in enumerate(read_codes):
        j = offset + i
        if j < 0 or j >= len(ref_codes):
            out.append(ord("C"))
        elif q >= 4:
            out.append(ord("N"))
        else:
            r = ref_codes[j]
            out.append(ord("m") if (r >= 4 or r == q) else ord("S"))
    return bytes(out)


def glocal_flat_align(read_codes: np.ndarray, ref_codes: np.ndarray,
                      a: int, b: int) -> tuple[bytes, int]:
    """SingleStateAlignerFlat2 analog: glocal (read-global, ref-local)
    flat-penalty DP over ref[a:b+1]; returns (match_string, ref_start).
    Host path for the rare quick-gate failures."""
    a = max(0, a)
    b = min(len(ref_codes) - 1, b)
    ref = ref_codes[a : b + 1]
    n, m = len(read_codes), len(ref)
    if m == 0 or n == 0:
        return b"C" * n, a
    POINTS_MATCH, POINTS_SUB, POINTS_INDEL = 1, -1, -2
    score = np.zeros((n + 1, m + 1), dtype=np.int32)
    score[1:, 0] = POINTS_INDEL * np.arange(1, n + 1)  # read must be consumed
    # score[0, :] = 0 -> free start anywhere in ref (glocal)
    ptr = np.zeros((n + 1, m + 1), dtype=np.uint8)  # 0 diag, 1 up(ins), 2 left(del)
    q = read_codes.astype(np.int32)
    r = ref.astype(np.int32)
    for i in range(1, n + 1):
        is_n = q[i - 1] >= 4
        sub = np.where(
            (r >= 4) | is_n | (r == q[i - 1]), POINTS_MATCH, POINTS_SUB
        )
        diag = score[i - 1, :-1] + sub
        up = score[i - 1, 1:] + POINTS_INDEL
        row = np.maximum(diag, up)
        p = np.where(diag >= up, 0, 1).astype(np.uint8)
        # left (deletion in read = gap over ref) needs a serial pass
        prev = score[i, 0]
        for jx in range(m):
            left = prev + POINTS_INDEL
            if left > row[jx]:
                row[jx] = left
                p[jx] = 2
            prev = row[jx]
        score[i, 1:] = row
        ptr[i, 1:] = p
    jend = int(np.argmax(score[n, 1:])) + 1
    # traceback
    out = bytearray()
    i, jx = n, jend
    while i > 0:
        if jx == 0:
            out.append(ord("X"))
            i -= 1
            continue
        p = ptr[i, jx]
        if p == 0:
            qq, rr = q[i - 1], r[jx - 1]
            if qq >= 4:
                out.append(ord("N"))
            elif rr >= 4:
                out.append(ord("N"))
            else:
                out.append(ord("m") if qq == rr else ord("S"))
            i -= 1
            jx -= 1
        elif p == 1:
            out.append(ord("I"))
            i -= 1
        else:
            out.append(ord("D"))
            jx -= 1
    out.reverse()
    return bytes(out), a + jx


def identity_flat(match: bytes, penalize_n: bool = True) -> float:
    """Read.identityFlat (:1916-1983) over a raw (non-RLE) match string."""
    good = bad = n = 0
    for c in match:
        ch = chr(c)
        if ch == "m":
            good += 1
        elif ch in "RN":
            n += 1
        elif ch in "CV":
            pass
        elif ch in "SDIXYid":
            bad += 1
    good2 = good + (0.25 * n if penalize_n else 0.0)
    bad2 = bad + (0.75 * n if penalize_n else 0.0)
    return good2 / max(good2 + bad2, 1.0)
