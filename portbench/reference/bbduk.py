"""Plain NumPy reference of BBDuk's adapter trim: `ktrim=r k= mink=
hdist=` with `tpe tbo` on pairs, and the final `minlen=` filter.

Written from BBTools' own loops (bbduk/BBDukIndexMod.addToMap and its
short-kmer shifts, BBDukProcessorS.ktrim :1993-2140, the tpe and tbo
blocks :1022-1034 and :1100-1145; BBMergeOverlapper.findBestRatio and
mateByOverlapRatioJava :368-505 for tbo), vectorised over reads. It
takes the adapter sequences and the reads as the benchmark made them
and nothing that the program built. Imports nothing of the program.

`trim(...)` returns, for every read (or pair), its kept length(s) and
whether it is removed; what the program wrote is judged against that.
"""

from __future__ import annotations

import numpy as np

N_CODE = 4
#: BBDuk's tbo call of the overlap (BBDukProcessorS: minOverlap0 8,
#: minOverlap 14, minInsert0 13, minInsert 16, maxRatio 0.09,
#: minSecondRatio 0.1, margin 5.5, offset 0.55; BBMerge's increments)
TBO = dict(mo0=8, mo=14, min_insert0=13, min_insert=16, max_ratio=0.09,
           min_second=0.1, margin=5.5, offset=0.55, g_incr=0.95, b_incr=0.95)


def read_fasta_codes(path: str) -> list[np.ndarray]:
    """The sequences of a FASTA file (plain or gzipped) as codes 0-4."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    seqs, cur = [], []
    with opener(path, "rb") as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(b">"):
                if cur:
                    seqs.append(b"".join(cur))
                cur = []
            elif line:
                cur.append(line)
    if cur:
        seqs.append(b"".join(cur))
    lut = np.full(256, N_CODE, np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
        lut[c + 32] = i
    return [lut[np.frombuffer(s, np.uint8)] for s in seqs]


def _rc(kmer: np.ndarray, ln: int) -> np.ndarray:
    out = np.zeros_like(kmer)
    x = kmer.copy()
    for _ in range(ln):
        out = (out << 2) | (3 - (x & 3))
        x >>= 2
    return out


def _canon(kmer: np.ndarray, ln: int) -> np.ndarray:
    """max(kmer, rc) tagged with a bit above the kmer for its length."""
    return np.maximum(kmer, _rc(kmer, ln)) | (np.int64(1) << (2 * ln))


def _mutants(kmers: np.ndarray, ln: int, hdist: int) -> np.ndarray:
    """Every kmer within `hdist` substitutions (the kmers themselves
    included)."""
    out = kmers
    for _ in range(hdist):
        i = np.arange(ln, dtype=np.int64)
        j = np.arange(4, dtype=np.int64)
        clear = ~(np.int64(3) << (2 * i))
        out = ((out[:, None, None] & clear[None, None, :]) | (j[None, :, None] << (2 * i[None, None, :])))
        out = np.unique(out.reshape(-1))
    return out


def _pack(codes: np.ndarray) -> int:
    v = 0
    for c in codes:
        v = (v << 2) | int(c)
    return v


def ref_keys(seqs: list[np.ndarray], k: int, mink: int, hdist: int) -> np.ndarray:
    """The sorted key set of the reference sequences: every full k-mer
    with no N, and the prefixes (of the first k-mer) and suffixes (of the
    last) of lengths mink..k-1 where those k-mers have no N, each with its
    hamming ball, canonical and length-tagged."""
    keys = []
    for s in seqs:
        if len(s) < k:
            continue
        win = np.lib.stride_tricks.sliding_window_view(s, k)
        ok = (win < 4).all(axis=1)
        w = win[ok].astype(np.int64)
        if len(w):
            km = np.zeros(len(w), np.int64)
            for t in range(k):
                km = (km << 2) | w[:, t]
            keys.append(_canon(_mutants(km, k, hdist), k))
        if mink and mink < k:
            for at_start, ok_end in ((True, ok[0]), (False, ok[-1])):
                if not ok_end:
                    continue
                for ln in range(k - 1, mink - 1, -1):
                    part = s[:ln] if at_start else s[len(s) - ln:]
                    keys.append(_canon(_mutants(np.array([_pack(part)], np.int64), ln, hdist), ln))
    return np.unique(np.concatenate(keys)) if keys else np.zeros(0, np.int64)


def _member(keys: np.ndarray, q: np.ndarray) -> np.ndarray:
    if len(keys) == 0:
        return np.zeros(q.shape, bool)
    pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    return keys[pos] == q


def ktrim_right(codes: np.ndarray, lengths: np.ndarray, keys: np.ndarray,
                k: int, mink: int) -> np.ndarray:
    """Right k-mer trim of each read: its length afterwards. The first
    full k-mer with no N found in the key set trims from its start; with
    none, the longest suffix of mink..k-1 bases found (an N read as A
    there) trims from its start; a trim to nothing keeps one base."""
    n, L = codes.shape
    ln = lengths.astype(np.int64)
    mask = np.int64((1 << (2 * k)) - 1)
    fwd = np.where(codes < 4, codes, 0).astype(np.int64)
    rev = np.where(codes < 4, 3 - codes.astype(np.int64), 0)
    # N-free windows: no N among the k bases ending at each position
    n_before = np.concatenate([np.zeros((n, 1), np.int64), np.cumsum(codes >= 4, axis=1)], axis=1)
    any_hit = np.zeros(n, bool)
    first = np.zeros(n, np.int64)
    km = np.zeros(n, np.int64)
    rk = np.zeros(n, np.int64)
    for i in range(L):
        km = ((km << 2) | fwd[:, i]) & mask
        rk = (rk >> 2) | (rev[:, i] << (2 * (k - 1)))
        if i < k - 1:
            continue
        w = i - k + 1
        clean = (n_before[:, i + 1] == n_before[:, w]) & (i < ln) & ~any_hit
        if not clean.any():
            continue
        hit = clean.copy()
        hit[clean] = _member(keys, np.maximum(km[clean], rk[clean]) | (np.int64(1) << (2 * k)))
        first[hit] = w
        any_hit |= hit
    min_loc = np.where(any_hit, first, -1)
    if mink and mink < k:
        # BBDuk's suffix scan reads an N as A on the forward strand and
        # as A on the reverse one too, so its two words are not each
        # other's complement there
        fwd = np.where(codes < 4, codes, 0).astype(np.int64)
        rev = np.where(codes < 4, 3 - codes.astype(np.int64), 0)
        for s in range(mink, k):
            # the suffix of s bases ends at the read's end
            st = ln - s
            okr = (~any_hit) & (st >= 0)
            idx = np.clip(st[:, None] + np.arange(s)[None, :], 0, L - 1)
            pf = np.take_along_axis(fwd, idx, 1)
            pr = np.take_along_axis(rev, idx, 1)
            km = np.zeros(n, np.int64)
            rk = np.zeros(n, np.int64)
            for t in range(s):
                km = (km << 2) | pf[:, t]
                rk |= pr[:, t] << (2 * t)
            key = np.maximum(km, rk) | (np.int64(1) << (2 * s))
            hit = okr & _member(keys, key)
            min_loc = np.where(hit, st, min_loc)
    min_needed = max(1, min(k, mink) if mink else k)
    act = (min_loc >= 0) & (ln >= min_needed)
    out = np.where(act, np.where(min_loc == 0, np.minimum(ln, 1), min_loc), ln)
    return out


def _incr(incr: float, n: int) -> np.ndarray:
    t = np.zeros(n + 1, np.float32)
    for i in range(1, n + 1):
        t[i] = np.float32(t[i - 1] + np.float32(incr))
    return t


def overlap_inserts(a: np.ndarray, alen: np.ndarray, b: np.ndarray, blen: np.ndarray,
                    live: np.ndarray, p=TBO):
    """BBMerge's ratio-mode mate detection (no qualities) for each pair:
    (insert, ambiguous), insert -1 where there is none. a is read 1,
    b the reverse complement of read 2, both left-aligned codes."""
    f32 = np.float32
    n, L = a.shape
    alen = alen.astype(np.int64)
    blen = blen.astype(np.int64)
    mo = max(4, p["mo0"], p["mo"])
    mo0 = sorted((4, p["mo0"], mo))[1]
    top = int((alen + blen).max(initial=0))
    gt, bt = _incr(p["g_incr"], 2 * L + 2), _incr(p["b_incr"], 2 * L + 2)
    # b right-justified and padded, so insert `ins` reads one static
    # slice: read position i of a faces column i + L - ins; the padding
    # (9) and a's N as 11 equal nothing, so the window needs no mask
    src = np.clip(np.arange(L)[None, :] - (L - blen)[:, None], 0, L - 1)
    b_rj = np.where(np.arange(L)[None, :] >= (L - blen)[:, None],
                    np.take_along_axis(b, src, 1), 9).astype(np.uint8)
    P = max(top - L, 0) + 1
    b_pad = np.concatenate([np.full((n, P), 9, np.uint8), b_rj, np.full((n, L + 1), 9, np.uint8)], 1)
    a_good = np.where(a < 4, a, 11).astype(np.uint8)
    a_n = a == 4
    nn_rows = np.flatnonzero(a_n.any(1) & (b_rj == 4).any(1))
    counts = {}

    def count(ins: int):
        if ins not in counts:
            seg = b_pad[:, P + L - ins: P + 2 * L - ins]
            good = np.count_nonzero(a_good == seg, axis=1)
            same = good.copy()
            if len(nn_rows):
                same[nn_rows] += np.count_nonzero(a_n[nn_rows] & (seg[nn_rows] == 4), axis=1)
            ol = np.maximum(np.minimum(alen, ins) - np.maximum(ins - blen, 0), 0)
            counts[ins] = (good, ol - same, ol)
        return counts[ins]

    # findBestRatio
    max_ratio = f32(p["max_ratio"])
    best = np.full(n, f32(max_ratio + f32(0.0001)), np.float32)
    halfmax = f32(max_ratio * f32(0.5))
    done = ~live.copy()
    x = np.full(n, np.nan, np.float32)
    for ins in range(top - mo, p["min_insert"] - 1, -1):
        on = ~done & (ins <= alen + blen - mo)
        if not on.any():
            continue
        g_c, b_c, ol = count(ins)
        g, bb, olf = gt[g_c], bt[b_c], ol.astype(np.float32)
        ok = on & (bb <= f32(1) * best * olf)
        r100 = ok & (b_c == 0) & (g > f32(mo0)) & (g < f32(mo))
        x[r100] = f32(100.0)
        done |= r100
        ok &= ~r100
        ratio = ((bb + f32(p["offset"])) / np.maximum(olf, f32(1))).astype(np.float32)
        imp = ok & (ratio < best)
        best = np.where(imp, ratio, best)
        early = imp & (g >= f32(mo)) & (ratio < halfmax)
        x[early] = best[early]
        done |= early
    x = np.where(np.isnan(x), best, x).astype(np.float32)
    live = live & ~(x > max_ratio)
    maxr = np.minimum(max_ratio, x).astype(np.float32)
    margin = f32(p["margin"])
    min_len = np.minimum(alen, blen).astype(np.float32)
    margin2 = ((margin + f32(p["offset"])) / np.maximum(min_len, f32(1))).astype(np.float32)
    best_ins = np.full(n, -1, np.int64)
    best_r = np.full(n, f32(1), np.float32)
    second_r = np.full(n, f32(1), np.float32)
    ambig = np.zeros(n, bool)
    failed = np.zeros(n, bool)
    done = ~live.copy()
    for ins in range(top - mo0, p["min_insert0"] - 1, -1):
        on = ~done & (ins <= alen + blen - mo0)
        if not on.any():
            continue
        g_c, b_c, ol = count(ins)
        g, bb, olf = gt[g_c], bt[b_c], ol.astype(np.float32)
        badlimit = (f32(1.2) * ((np.minimum(best_r, maxr) * margin) * olf) + f32(1.0)).astype(np.float32)
        ok = on & (bb <= badlimit)
        ret = ok & (b_c == 0) & (g > f32(mo0)) & (g < f32(mo))
        failed |= ret
        done |= ret
        ok &= ~ret
        ratio = ((bb + f32(p["offset"])) / np.maximum(olf, f32(1))).astype(np.float32)
        cand = ok & (ratio < (best_r * margin).astype(np.float32))
        ambig = np.where(cand, ((ratio * margin).astype(np.float32) >= best_r) | (g < f32(mo)), ambig)
        better = cand & (ratio < best_r)
        second_only = cand & ~better & (ratio < second_r)
        second_r = np.where(better, best_r, np.where(second_only, ratio, second_r))
        best_ins = np.where(better, ins, best_ins)
        best_r = np.where(better, ratio, best_r)
        stop = cand & ((ambig & (best_r < margin2)) | (second_r < f32(p["min_second"])))
        failed |= stop
        done |= stop
    ambig = ambig | (second_r < f32(p["min_second"]))
    best_ins = np.where(~ambig & (best_r > maxr), -1, best_ins)
    best_ins = np.where(failed | ~live, -1, best_ins)
    return best_ins, ambig & (best_ins > -1)


def trim(r1: np.ndarray, len1: np.ndarray, r2, len2, keys: np.ndarray, k: int, mink: int,
         minlen: int, tpe: bool, tbo: bool):
    """The kept lengths and the removal of each read or pair.
    Returns (len1, len2 or None, removed, the pair's lengths as tbo
    finds them or None)."""
    n1 = ktrim_right(r1, len1, keys, k, mink)
    if r2 is None:
        return n1, None, (n1 < minlen) | (len1 < minlen), None
    n2 = ktrim_right(r2, len2, keys, k, mink)
    removed = (len1 < minlen) | (len2 < minlen) | (n1 < minlen) | (n2 < minlen)
    if tpe:
        trimmed = (n1 < len1) | (n2 < len2)
        even = ~removed & trimmed & (n1 != n2)
        m = np.minimum(n1, n2)
        n1 = np.where(even, m, n1)
        n2 = np.where(even, m, n2)
    at_tbo = (n1.copy(), n2.copy())
    if tbo:
        L = r1.shape[1]
        pos = np.arange(L)[None, :]
        # read 2 reverse complemented, left-aligned, over its kept length
        src = np.clip(n2[:, None] - 1 - pos, 0, L - 1)
        rc2 = np.take_along_axis(r2, src, 1)
        rc2 = np.where(rc2 < 4, 3 - rc2, rc2).astype(np.uint8)
        rc2[pos >= n2[:, None]] = 9
        a = np.where(pos < n1[:, None], r1, 9).astype(np.uint8)
        ins, amb = overlap_inserts(a, n1, rc2, n2, ~removed)
        ok = (ins > 0) & ~amb & ~removed
        n1 = np.where(ok & (ins < n1), ins, n1)
        n2 = np.where(ok & (ins < n2), ins, n2)
    removed = removed | (n1 < minlen) | (n2 < minlen)
    return n1, n2, removed, at_tbo
