"""Big k-mers (31 < k <= 496) — the ukmer analog (ukmer/Kmer.java:17).

The PyTorch port of bbtools_tpu/ops/kmers2.py. The host half (the
two-word `rolling_kmers2_np` and `BigSpectrum`, the W-word
`rolling_kmersw_np`, `canonical_words`, the byte keys and
`WordSpectrum`) is a copy. The device half is torch:
`rolling_kmersw` / `canonical_words_t` build the W-word keys on any
device, and `count_words` sorts them lexicographically (W stable sorts,
least significant word first, carrying a permutation) and reduces the
runs. `count_batchw_exact` takes that device count on a CUDA device and
the host route (numpy windows, the native radix count) on the CPU; both
give the same 'S8W' keys and counts.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .kmer_count import PAD, _compact

from .kmer_index import _mix64

LO_BASES = 31
LO_MASK = (1 << (2 * LO_BASES)) - 1


def rolling_kmers2_np(codes: np.ndarray, k: int):
    """Per-position big-kmer pairs for codes [B, L].

    Returns (hi, lo, rhi, rlo, runlen): forward pair, reverse-complement
    pair, and the defined-run length, matching the k<=31 rolling semantics
    (undefined -> contributes 0 forward, resets the reverse registers).
    """
    assert LO_BASES < k <= 62
    hi_bases = k - LO_BASES
    hi_mask = (1 << (2 * hi_bases)) - 1
    codes = np.atleast_2d(codes)
    B, L = codes.shape
    defined = codes < 4
    code0 = np.where(defined, codes, 0).astype(np.int64)
    comp0 = np.where(defined, 3 - codes.astype(np.int64), 0)
    idx = np.arange(L, dtype=np.int64)
    marked = np.where(defined, np.int64(-1), idx[None, :])
    lastn = np.maximum.accumulate(marked, axis=-1)
    runlen = (idx[None, :] - lastn).astype(np.int32)
    hi = np.zeros((B, L), dtype=np.int64)
    lo = np.zeros((B, L), dtype=np.int64)
    rhi = np.zeros((B, L), dtype=np.int64)
    rlo = np.zeros((B, L), dtype=np.int64)
    # forward: source i-j goes to overall position j (0 = newest)
    for j in range(k):
        src = np.zeros((B, L), dtype=np.int64)
        if j == 0:
            src = code0
        else:
            src[:, j:] = code0[:, :-j]
        live = (idx[None, :] - j) > lastn
        csrc = np.zeros((B, L), dtype=np.int64)
        if j == 0:
            csrc = comp0
        else:
            csrc[:, j:] = comp0[:, :-j]
        csrc = np.where(live, csrc, 0)
        if j < LO_BASES:
            lo |= src << (2 * j)
        else:
            hi |= src << (2 * (j - LO_BASES))
        # reverse: source i-j at overall reverse position k-1-j
        rj = k - 1 - j
        if rj < LO_BASES:
            rlo |= csrc << (2 * rj)
        else:
            rhi |= csrc << (2 * (rj - LO_BASES))
    return hi & hi_mask, lo, rhi & hi_mask, rlo, runlen


def canonical_pair(hi, lo, rhi, rlo):
    """Lexicographic max of (hi, lo) vs (rhi, rlo)."""
    take_f = (hi > rhi) | ((hi == rhi) & (lo >= rlo))
    return np.where(take_f, hi, rhi), np.where(take_f, lo, rlo)


_C = np.uint64(0x9E3779B97F4A7C15)


def pair_hash(hi, lo) -> np.ndarray:
    """64-bit mixed hash of the pair (spectrum key)."""
    return (
        _mix64(np.asarray(hi).astype(np.uint64) * _C)
        ^ _mix64(np.asarray(lo).astype(np.uint64))
    ).astype(np.int64) & np.int64(0x7FFFFFFFFFFFFFFF)


def count_batch2(bases: np.ndarray, lengths: np.ndarray, k: int):
    """Host big-k counting: hashed canonical keys + counts for one batch."""
    hi, lo, rhi, rlo, runlen = rolling_kmers2_np(bases, k)
    i_idx = np.arange(bases.shape[1])[None, :]
    valid = (runlen >= k) & (i_idx < np.asarray(lengths)[:, None])
    chi, clo = canonical_pair(hi, lo, rhi, rlo)
    h = pair_hash(chi[valid], clo[valid])
    values, counts = np.unique(h, return_counts=True)
    return values, counts.astype(np.int64)


def count_batch2_exact(bases: np.ndarray, lengths: np.ndarray, k: int):
    """Exact big-k counting: canonical (hi, lo) word pairs + counts.

    The exact-table analog of ukmer's multi-word keys (Kmer.java): no
    64-bit hashing, so distinct k-mers can never collide. Returns
    (hi int64 [n], lo int64 [n], counts int64 [n]) sorted lexicographically
    by (hi, lo).
    """
    hi, lo, rhi, rlo, runlen = rolling_kmers2_np(bases, k)
    i_idx = np.arange(bases.shape[1])[None, :]
    valid = (runlen >= k) & (i_idx < np.asarray(lengths)[:, None])
    chi, clo = canonical_pair(hi, lo, rhi, rlo)
    chi = chi[valid]
    clo = clo[valid]
    order = np.lexsort((clo, chi))
    chi, clo = chi[order], clo[order]
    if len(chi) == 0:
        return chi, clo, np.zeros(0, np.int64)
    new = np.concatenate(
        [[True], (chi[1:] != chi[:-1]) | (clo[1:] != clo[:-1])]
    )
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, len(chi)))
    return chi[starts], clo[starts], counts.astype(np.int64)


class BigSpectrum:
    """Exact two-word k-mer spectrum with mergeable batches and a
    two-level (hi -> lo segment) exact lookup — the KmerTableSetU /
    HashArrayU analog with sorted arrays instead of probe chains."""

    def __init__(self, k: int):
        self.k = k
        self.hi = np.zeros(0, np.int64)
        self.lo = np.zeros(0, np.int64)
        self.counts = np.zeros(0, np.int64)

    def add_batch(self, hi, lo, counts):
        self.hi = np.concatenate([self.hi, hi])
        self.lo = np.concatenate([self.lo, lo])
        self.counts = np.concatenate([self.counts, counts])
        if len(self.hi) > 8_000_000:
            self.flush()

    def flush(self):
        if len(self.hi) == 0:
            return
        order = np.lexsort((self.lo, self.hi))
        hi, lo, c = self.hi[order], self.lo[order], self.counts[order]
        new = np.concatenate(
            [[True], (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])]
        )
        starts = np.flatnonzero(new)
        self.hi, self.lo = hi[starts], lo[starts]
        self.counts = np.add.reduceat(c, starts)
        # two-level index: unique hi values -> lo segment bounds
        hnew = np.concatenate(
            [[True], self.hi[1:] != self.hi[:-1]]
        )
        self._hi_vals = self.hi[hnew]
        self._hi_starts = np.append(
            np.flatnonzero(hnew), len(self.hi)
        ).astype(np.int64)

    def count_of(self, hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
        """Exact count lookup, vectorized over queries."""
        if len(self.hi) == 0:
            return np.zeros(len(hi), np.int64)
        seg = np.searchsorted(self._hi_vals, hi)
        seg = np.minimum(seg, len(self._hi_vals) - 1)
        hit_hi = self._hi_vals[seg] == hi
        out = np.zeros(len(hi), np.int64)
        a = self._hi_starts[seg]
        b = self._hi_starts[seg + 1]
        # per-query binary search within the lo segment
        for i in np.flatnonzero(hit_hi):
            s, e = int(a[i]), int(b[i])
            j = s + np.searchsorted(self.lo[s:e], lo[i])
            if j < e and self.lo[j] == lo[i]:
                out[i] = self.counts[j]
        return out

    @property
    def n(self):
        return len(self.hi)

    @property
    def n_unique(self):
        return len(self.hi)

    def histogram(self, hist_max: int) -> np.ndarray:
        h = np.zeros(hist_max + 1, dtype=np.int64)
        np.add.at(h, np.minimum(self.counts, hist_max), 1)
        return h


# ---------------------------------------------------------------------------
# W-word kmers: 62 < k <= 496 (general multi-word, ukmer/Kmer.java:17-46)
# ---------------------------------------------------------------------------

WORD_BASES = 31
MAX_K = 496


def n_words(k: int) -> int:
    return (k + WORD_BASES - 1) // WORD_BASES


def rolling_kmersw_np(codes: np.ndarray, k: int):
    """Per-position W-word kmers for codes [B, L], 31 < k <= 496.

    Word layout: words[..., 0] = newest 31 bases, words[..., w] = bases
    older by 31*w; the top word holds t = k - 31*(W-1) bases. Derived from
    ONE 31-base rolling pass (O(L) per word): word w at position p is the
    31-mer ending at p-31w; the rc word w is the rc-31-mer ending at
    p-k+31(w+1) (top rc word: high t entries of the rc register at p).

    Returns (words [B,L,W] int64, rwords [B,L,W] int64, runlen [B,L]).
    """
    from .kmers import rolling_kmers_np

    assert WORD_BASES < k <= MAX_K
    codes = np.atleast_2d(codes)
    B, L = codes.shape
    W = n_words(k)
    t = k - WORD_BASES * (W - 1)
    f31, r31, runlen31 = rolling_kmers_np(codes, WORD_BASES)
    # full-k run length: recompute from defined runs
    defined = codes < 4
    idx = np.arange(L, dtype=np.int64)
    marked = np.where(defined, np.int64(-1), idx[None, :])
    lastn = np.maximum.accumulate(marked, axis=-1)
    runlen = (idx[None, :] - lastn).astype(np.int32)

    def shifted(arr, s):
        if s == 0:
            return arr
        out = np.zeros_like(arr)
        if s < L:
            out[:, s:] = arr[:, :-s]
        return out

    words = np.zeros((B, L, W), dtype=np.int64)
    rwords = np.zeros((B, L, W), dtype=np.int64)
    top_mask = np.int64((1 << (2 * t)) - 1)
    for w in range(W):
        if w < W - 1:
            words[:, :, w] = shifted(f31, WORD_BASES * w)
            rwords[:, :, w] = shifted(r31, k - WORD_BASES * (w + 1))
        else:
            words[:, :, w] = shifted(f31, WORD_BASES * w) & top_mask
            rwords[:, :, w] = r31 >> (2 * (WORD_BASES - t))
    return words, rwords, runlen


def canonical_words(words: np.ndarray, rwords: np.ndarray) -> np.ndarray:
    """Lexicographic max of the pair, comparing most-significant word
    (index W-1) first."""
    W = words.shape[-1]
    take_f = np.zeros(words.shape[:-1], dtype=bool)
    tied = np.ones(words.shape[:-1], dtype=bool)
    for w in range(W - 1, -1, -1):
        gt = words[..., w] > rwords[..., w]
        lt = words[..., w] < rwords[..., w]
        take_f |= tied & gt
        tied &= ~gt & ~lt
    take_f |= tied  # equal -> forward
    return np.where(take_f[..., None], words, rwords)


def words_to_bytes(words: np.ndarray) -> np.ndarray:
    """[..., W] int64 -> fixed-size big-endian byte keys ('S8W'): memcmp
    order == numeric order, so np.sort/searchsorted give exact multi-word
    tables with zero custom comparators."""
    W = words.shape[-1]
    be = np.ascontiguousarray(words[..., ::-1]).astype(">i8")
    return be.view(f"S{8 * W}")[..., 0]


def bytes_to_words(keys: np.ndarray, W: int) -> np.ndarray:
    return keys[..., None].view(">i8").astype(np.int64)[..., ::-1]


def count_batchw_exact(bases: np.ndarray, lengths: np.ndarray, k: int,
                       device="cuda"):
    """Exact W-word counting for one batch: returns (keys 'S8W' sorted,
    counts int64). On a CUDA device the whole extract+sort+reduce runs on
    the card (count_batchw_device); on the CPU the host route uses the
    native radix sort."""
    if torch.device(device).type != "cpu":
        return count_batchw_device(bases, lengths, k, device)
    words, rwords, runlen = rolling_kmersw_np(bases, k)
    i_idx = np.arange(bases.shape[1])[None, :]
    valid = (runlen >= k) & (i_idx < np.asarray(lengths)[:, None])
    cw = canonical_words(words, rwords)[valid]
    if len(cw):
        try:
            from ..native import radix_count_w_native
        except Exception:
            radix_count_w_native = None
        if radix_count_w_native is not None:
            # radix sorts word 0 primary; byte keys are word W-1 primary
            res = radix_count_w_native(cw[:, ::-1])
            if res is not None:
                vals, counts = res
                return (
                    words_to_bytes(vals.view(np.int64)[:, ::-1]),
                    counts,
                )
    keys = words_to_bytes(cw)
    keys.sort()
    if len(keys) == 0:
        return keys, np.zeros(0, np.int64)
    new = np.concatenate([[True], keys[1:] != keys[:-1]])
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, len(keys)))
    return keys[starts], counts.astype(np.int64)


class WordSpectrum:
    """Exact W-word k-mer spectrum: sorted byte keys + counts, mergeable
    batches (KmerTableSetU analog; sorted arrays instead of HashArrayU
    probe chains — the TPU/host-idiomatic layout)."""

    def __init__(self, k: int):
        self.k = k
        self.W = n_words(k)
        self._dt = f"S{8 * self.W}"
        self.keys = np.zeros(0, dtype=self._dt)
        self.counts = np.zeros(0, np.int64)
        self._pend_k: list[np.ndarray] = []
        self._pend_c: list[np.ndarray] = []
        self._pend_n = 0

    def add_batch(self, keys: np.ndarray, counts: np.ndarray):
        self._pend_k.append(keys)
        self._pend_c.append(counts)
        self._pend_n += len(keys)
        if self._pend_n > 8_000_000:
            self.flush()

    def flush(self):
        if not self._pend_k and len(self.keys):
            return
        ks = np.concatenate([self.keys] + self._pend_k) if self._pend_k else self.keys
        cs = (
            np.concatenate([self.counts] + self._pend_c)
            if self._pend_c
            else self.counts
        )
        self._pend_k, self._pend_c, self._pend_n = [], [], 0
        if len(ks) == 0:
            return
        order = np.argsort(ks, kind="stable")
        ks, cs = ks[order], cs[order]
        new = np.concatenate([[True], ks[1:] != ks[:-1]])
        starts = np.flatnonzero(new)
        self.keys = ks[starts]
        self.counts = np.add.reduceat(cs, starts)

    def count_of(self, keys: np.ndarray) -> np.ndarray:
        if len(self.keys) == 0:
            return np.zeros(len(keys), np.int64)
        pos = np.searchsorted(self.keys, keys)
        pos = np.minimum(pos, len(self.keys) - 1)
        ok = self.keys[pos] == keys
        return np.where(ok, self.counts[pos], 0)

    @property
    def n_unique(self):
        return len(self.keys)

    def histogram(self, hist_max: int) -> np.ndarray:
        h = np.zeros(hist_max + 1, dtype=np.int64)
        if len(self.counts):
            np.add.at(h, np.minimum(self.counts, hist_max), 1)
        return h




# ---------------------------------------------------------------------------
# Device W-word counting (sort-based; no scatters that collide)
# ---------------------------------------------------------------------------

PADW = PAD  # the same sentinel as the k <= 31 keys


def rolling_kmersw(bases: torch.Tensor, k: int):
    """Torch analog of rolling_kmersw_np on uint8 codes [B, L]: ([B,L,W]
    words, rwords, runlen). Same word layout; built from one 31-base
    rolling pass plus static shifts."""
    from .kmers import rolling_kmers

    assert WORD_BASES < k <= MAX_K
    B, L = bases.shape
    W = n_words(k)
    t = k - WORD_BASES * (W - 1)
    f31, r31, _ = rolling_kmers(bases, WORD_BASES)
    codes = bases.to(torch.int32)
    idx = torch.arange(L, dtype=torch.int32, device=bases.device)
    marked = torch.where(codes < 4, -1, idx[None, :])
    runlen = idx[None, :] - torch.cummax(marked, dim=-1).values

    def shifted(arr, s):
        if s == 0:
            return arr
        if s >= L:
            return torch.zeros_like(arr)
        return F.pad(arr[:, :-s], (s, 0))

    top_mask = (1 << (2 * t)) - 1
    words = []
    rwords = []
    for w in range(W):
        if w < W - 1:
            words.append(shifted(f31, WORD_BASES * w))
            rwords.append(shifted(r31, k - WORD_BASES * (w + 1)))
        else:
            words.append(shifted(f31, WORD_BASES * w) & top_mask)
            rwords.append(r31 >> (2 * (WORD_BASES - t)))
    return torch.stack(words, -1), torch.stack(rwords, -1), runlen


def canonical_words_t(words: torch.Tensor, rwords: torch.Tensor) -> torch.Tensor:
    """Lexicographic max of the pair (most-significant word first)."""
    W = words.shape[-1]
    take_f = torch.zeros(words.shape[:-1], dtype=torch.bool, device=words.device)
    tied = torch.ones_like(take_f)
    for w in range(W - 1, -1, -1):
        gt = words[..., w] > rwords[..., w]
        lt = words[..., w] < rwords[..., w]
        take_f |= tied & gt
        tied &= ~gt & ~lt
    take_f |= tied
    return torch.where(take_f[..., None], words, rwords)


def count_words(bases: torch.Tensor, lengths: torch.Tensor, k: int):
    """The W-word sort-reduce of one batch on bases' device: (words [n,
    W] int64, least-significant word first, padded with PADW past
    n_runs; counts [n] int64; n_runs, a device scalar), n = B*L rows.

    The lexicographic sort is W stable sorts, from the least significant
    word up, each reordering a carried permutation; runs are compacted
    by `kmer_count._compact`."""
    if bases.device.type == "cuda":
        count_words.device_calls += 1
    W = n_words(k)
    dev = bases.device
    words, rwords, runlen = rolling_kmersw(bases, k)
    i_idx = torch.arange(bases.shape[1], device=dev)[None, :]
    valid = (runlen >= k) & (i_idx < lengths[:, None])
    cw = canonical_words_t(words, rwords).reshape(-1, W)
    flat = torch.where(valid.reshape(-1, 1), cw, int(PADW))
    n = flat.shape[0]
    perm = torch.arange(n, device=dev)
    for w in range(W):
        order = torch.sort(flat[perm, w], stable=True).indices
        perm = perm[order]
    s = flat[perm]
    # sentinel rows: real top words are < 2^(2t) << PADW
    live_row = s[:, W - 1] != int(PADW)
    first = torch.ones(1, dtype=torch.bool, device=dev)
    boundary = torch.cat([first, (s[1:] != s[:-1]).any(dim=1)]) & live_row
    return _compact(s, boundary, torch.arange(n, device=dev), live_row.sum())


#: calls on CUDA tensors since the count was last set to 0
count_words.device_calls = 0


def count_batchw_device(bases, lengths, k: int, device="cuda"):
    """count_batchw_exact through `count_words` on `device` (any torch
    device: the CPU tests run it on CPU tensors). Returns the same ('S8W'
    sorted byte keys, int64 counts) as the host route."""
    dev = torch.device(device)
    words, counts, n_runs = count_words(
        torch.as_tensor(np.asarray(bases), device=dev),
        torch.as_tensor(np.asarray(lengths), device=dev), k,
    )
    n = int(n_runs)
    return words_to_bytes(words[:n].cpu().numpy()), counts[:n].cpu().numpy()
