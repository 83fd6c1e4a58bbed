"""Sliding-window sequence entropy — exact EntropyTracker semantics.

Replicates tracker/EntropyTracker.java (FAST mode, the default :1215):
  - window of `window` bases (default 50), k-mer length `k` (default 5)
  - k-mers use symbolToNumber0 (undefined -> 0); no reset at N; a k-mer is
    counted as soon as `len >= k`
  - entropy table: e[c] = (c/Wk) * ln(c/Wk), Wk = window-k+1 k-mer slots
  - running esum updated incrementally in double precision, in the exact
    order of the reference add() method (:873 add side, :925 evict side):
    esum = (esum + e[newCount]) - e[oldCount]
  - per-window value: float(esum * (-1/ln(Wk))), clamped to >= 0
  - averageEntropy (:657-700): first measurement after the prefill of
    min(window, len) bases, then one per subsequent base; mean in double
  - passes(): highPass XOR (avg < cutoff)

The incremental double accumulation order is part of observable behavior
(float rounding feeds a threshold), so this is computed with the same
operation sequence — vectorized across the batch, sequential over
positions. Host numpy implementation; the entropy filter is host-side in
this framework (it is off by default in BBDuk and cheap relative to IO).
"""

from __future__ import annotations

import numpy as np


class EntropyModel:
    def __init__(self, k: int = 5, window: int = 50):
        self.k = k
        self.window = window
        self.window_kmers = window - k + 1
        self.mask = (1 << (2 * k)) - 1
        self.kmer_space = 1 << (2 * k)
        # e[c] for c in 0..window_kmers+1; e[0] = 0
        mult = 1.0 / self.window_kmers
        c = np.arange(self.window_kmers + 2, dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            self.e = np.where(c > 0, c * mult * np.log(c * mult), 0.0)
        self.entropy_mult = -1.0 / np.log(self.window_kmers)

    def average_entropy_batch(
        self, codes: np.ndarray, lengths: np.ndarray
    ) -> np.ndarray:
        """Mean window entropy per read. codes uint8 [B, L] (N -> >=4)."""
        B, L = codes.shape
        k, W = self.k, self.window
        code0 = np.where(codes < 4, codes, 0).astype(np.int64)
        counts = np.zeros((B, self.kmer_space), dtype=np.int16)
        esum = np.zeros(B, dtype=np.float64)
        total = np.zeros(B, dtype=np.float64)
        divisor = np.zeros(B, dtype=np.int64)
        rows = np.arange(B)
        kmer = np.zeros(B, dtype=np.int64)
        kmer2 = np.zeros(B, dtype=np.int64)
        e = self.e
        emult = self.entropy_mult
        maxlen = int(lengths.max(initial=0))
        for i in range(min(maxlen, L)):
            alive = i < lengths
            kmer = ((kmer << 2) | code0[:, i]) & self.mask
            if i >= k - 1:
                old = counts[rows, kmer]
                upd = alive
                counts[rows, kmer] = np.where(upd, old + 1, old)
                esum = np.where(
                    upd, (esum + e[old + 1]) - e[old], esum
                )
            # evict: base leaving the window is at i-W; kmer2 tracks the
            # leftmost kmer, built from base at position i-W+k-1... the
            # reference uses a second rolling register fed by the base at
            # pos2 = i - (W - k + 1)
            j2 = i - (W - k + 1)
            if j2 >= 0:
                kmer2 = ((kmer2 << 2) | code0[:, j2]) & self.mask
            if i >= W:  # len > windowBases -> remove leftmost kmer
                old = counts[rows, kmer2]
                upd = alive
                counts[rows, kmer2] = np.where(upd, old - 1, old)
                esum = np.where(
                    upd, (esum + e[np.maximum(old - 1, 0)]) - e[old], esum
                )
            # measure after prefill (i == min(W, len) - 1) and every add
            # thereafter
            measure = alive & (i >= np.minimum(W, lengths) - 1)
            val = np.float32(esum * emult)
            val = np.where(val > 0, val, np.float32(0))
            total = np.where(measure, total + val.astype(np.float64), total)
            divisor = np.where(measure, divisor + 1, divisor)
        avg = np.where(divisor > 0, total / np.maximum(divisor, 1), 0.0)
        # reads shorter than k still get one measurement of the (empty)
        # prefill window in the reference; entropy is 0 there
        return avg.astype(np.float32)

    def average_entropy_read(self, codes: np.ndarray) -> float:
        """Scalar oracle: direct transliteration of averageEntropy()."""
        k, W = self.k, self.window
        n = len(codes)
        counts = np.zeros(self.kmer_space, dtype=np.int32)
        esum = 0.0
        kmer = 0
        kmer2 = 0
        total = 0.0
        divisor = 0
        e = self.e

        def add(i, kmer, kmer2, esum):
            c = int(codes[i]) if codes[i] < 4 else 0
            kmer = ((kmer << 2) | c) & self.mask
            ln = i + 1
            if ln >= k:
                old = counts[kmer]
                counts[kmer] = old + 1
                esum = (esum + e[old + 1]) - e[old]
            j2 = i - (W - k + 1)
            if j2 >= 0:
                c2 = int(codes[j2]) if codes[j2] < 4 else 0
                kmer2 = ((kmer2 << 2) | c2) & self.mask
            if ln > W:
                old = counts[kmer2]
                counts[kmer2] = old - 1
                esum = (esum + e[old - 1]) - e[old]
            return kmer, kmer2, esum

        i = 0
        lim = min(n, W)
        while i < lim:
            kmer, kmer2, esum = add(i, kmer, kmer2, esum)
            i += 1
        val = np.float32(esum * self.entropy_mult)
        total += float(val if val > 0 else 0)
        divisor += 1
        while i < n:
            kmer, kmer2, esum = add(i, kmer, kmer2, esum)
            val = np.float32(esum * self.entropy_mult)
            total += float(val if val > 0 else 0)
            divisor += 1
            i += 1
        return float(np.float32(total / divisor))

    def passes(
        self,
        codes: np.ndarray,
        lengths: np.ndarray,
        cutoff: float,
        highpass: bool = True,
    ) -> np.ndarray:
        avg = self.average_entropy_batch(codes, lengths)
        below = avg < np.float32(cutoff)
        return ~below if highpass else below
