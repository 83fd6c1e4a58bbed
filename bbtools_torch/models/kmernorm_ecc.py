"""KmerNormalize-style error correction over approximate counts (the
`ecc=` mode of BBNorm / ecc.sh).

Transliterated semantics from jgi/KmerNormalize.java:
  correctErrors :2338, correctErrorsFromLeft/Right :2521/2568,
  correctErrorFromLeft/Right :2667/2752, testRightSuffix :2847,
  testLeftSuffix :2891, countDiscontinuities :2450.

Per read: coverage plane cov[i] = CMS count of the canonical kmer starting
at i. A discontinuity (flanking min >= high while this kmer <= low or
ratio-collapsed) marks an error at the window edge; candidate bases are
scored as the MIN count over SUFFIX_LEN extension kmers, accepted when the
best lands inside [max(high, a/2), 2a] and the runner-up is collapsed.
On any failed/over-budget correction the read rolls back (reference
restores the cloned bases).

Batch flow: a vectorized discontinuity prefilter selects candidate reads
(typically a few %), which then run the sequential per-read fix loop —
the counting side stays on device (ops/cms.py)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.kmers import rolling_kmers_np

PREFIX_LEN = 3
SUFFIX_LEN = 3
FIXED_N_QUAL = 20


@dataclass
class EccNormConfig:
    low: int = 2  # EC_LTHRESH (KmerNormalize.java:3818)
    high: int = 22  # EC_HTHRESH (:3816)
    mult: int = 140  # ERROR_CORRECT_RATIO (:3814)
    max_errors: int = 3  # MAX_ERRORS_TO_CORRECT (:3849)
    max_qual: int = 127  # MAX_QUAL_TO_CORRECT (:3850)


class NormEccEngine:
    def __init__(self, cms, k: int, cfg: EccNormConfig | None = None):
        self.cms = cms
        self.k = k
        self.cfg = cfg or EccNormConfig()
        self.mask = (1 << (2 * k)) - 1
        self.stats = {"reads_corrected": 0, "errors_corrected": 0,
                      "rollbacks": 0}

    # ---- count planes ----
    def _kmers_cov(self, codes: np.ndarray):
        """kmers[i] = forward kmer STARTING at i (-1 if any undefined base
        in the window); cov[i] = canonical CMS count."""
        k = self.k
        fwd, rkm, runlen = rolling_kmers_np(codes[None, :], k)
        fwd, rkm, runlen = fwd[0], rkm[0], runlen[0]
        n = len(codes) - k + 1
        if n < 1:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        valid = runlen[k - 1 :] >= k
        km = np.where(valid, fwd[k - 1 :], -1)
        keys = np.maximum(fwd[k - 1 :], rkm[k - 1 :])
        cov = np.where(valid, self.cms.query(keys), 0)
        return km, cov

    def _canon_count(self, kmer: int) -> int:
        r = 0
        x = kmer
        for _ in range(self.k):
            r = (r << 2) | (3 - (x & 3))
            x >>= 2
        return int(self.cms.query(np.array([max(kmer, r)], np.int64))[0])

    def _test_right_suffix(self, kmer0: int, suffix: np.ndarray) -> int:
        kmer = kmer0 >> 2
        mn = 1 << 30
        for b in suffix:
            if b >= 4:
                return 0
            kmer = ((kmer << 2) | int(b)) & self.mask
            mn = min(mn, self._canon_count(kmer))
            if mn == 0:
                break
        return mn

    def _test_left_suffix(self, kmer0: int, suffix: np.ndarray) -> int:
        shift = 2 * (self.k - 1)
        kmer = (kmer0 << 2) & self.mask
        mn = 1 << 30
        for b in suffix:
            if b >= 4:
                return 0
            kmer = (kmer >> 2) | (int(b) << shift)
            mn = min(mn, self._canon_count(kmer))
            if mn == 0:
                break
        return mn

    # ---- single-base fixes ----
    def _fix_left(self, codes, quals, kmers, loc, low, t_lo, t_hi, mult):
        k = self.k
        L = len(codes)
        bnum = loc + k - 1
        suffix = np.full(SUFFIX_LEN, 4, np.uint8)
        for i in range(SUFFIX_LEN):
            j = bnum + i
            if j < L:
                suffix[i] = codes[j]
        defined = suffix[0] < 4
        kmer = int(kmers[loc])
        if not defined and loc > 0 and kmers[loc - 1] != -1:
            kmer = (int(kmers[loc - 1]) << 2) & self.mask
        if kmer == -1:
            return False
        scores = []
        for x in range(4):
            s = suffix.copy()
            s[0] = x
            scores.append(self._test_right_suffix(kmer, s))
        mx = max(scores)
        best = scores.index(mx)  # first of A,C,G,T on ties (if-chain order)
        if t_lo <= mx <= t_hi:
            mx2 = max(s for i, s in enumerate(scores) if i != best)
            if mx2 <= low or mx2 * mult <= mx:
                codes[bnum] = best
                if not defined and quals is not None:
                    quals[bnum] = FIXED_N_QUAL
                return True
        return False

    def _fix_right(self, codes, quals, kmers, loc, low, t_lo, t_hi, mult):
        suffix = np.full(SUFFIX_LEN, 4, np.uint8)
        for i in range(SUFFIX_LEN):
            j = loc - i
            if j >= 0:
                suffix[i] = codes[j]
        defined = suffix[0] < 4
        kmer = int(kmers[loc])
        if not defined and loc + 1 < len(kmers) and kmers[loc + 1] != -1:
            kmer = (int(kmers[loc + 1]) >> 2) & self.mask
        if kmer == -1:
            return False
        scores = []
        for x in range(4):
            s = suffix.copy()
            s[0] = x
            scores.append(self._test_left_suffix(kmer, s))
        mx = max(scores)
        best = scores.index(mx)
        if t_lo <= mx <= t_hi:
            mx2 = max(s for i, s in enumerate(scores) if i != best)
            if mx2 <= low or mx2 * mult <= mx:
                codes[loc] = best
                if not defined and quals is not None:
                    quals[loc] = FIXED_N_QUAL
                return True
        return False

    # ---- per-read scans ----
    def _scan_left(self, codes, quals, max_to_correct):
        cfg = self.cfg
        kmers, cov = self._kmers_cov(codes)
        found = corrected = uncorrected = 0
        i = PREFIX_LEN
        while i < len(cov):
            a = int(cov[max(0, i - PREFIX_LEN) : i].min())
            b = int(cov[i])
            if a >= cfg.high and (b <= cfg.low or a >= b * cfg.mult):
                found += 1
                loc = i + self.k - 1
                q = int(quals[loc]) if quals is not None else 10
                if found > max_to_correct or q > cfg.max_qual:
                    return -found, corrected
                ok = self._fix_left(
                    codes, quals, kmers, i, cfg.low,
                    max(cfg.high, a // 2), 2 * a, cfg.mult,
                )
                if ok:
                    corrected += 1
                    kmers, cov = self._kmers_cov(codes)
                else:
                    uncorrected += 1
                    break
            i += 1
        return (-found if uncorrected else corrected), corrected

    def _scan_right(self, codes, quals, max_to_correct):
        cfg = self.cfg
        kmers, cov = self._kmers_cov(codes)
        found = corrected = uncorrected = 0
        i = len(cov) - PREFIX_LEN - 1
        while i >= 0:
            a = int(cov[i + 1 : i + 1 + PREFIX_LEN].min())
            b = int(cov[i])
            if a >= cfg.high and (b <= cfg.low or a >= b * cfg.mult):
                found += 1
                q = int(quals[i]) if quals is not None else 10
                if found > max_to_correct or q > cfg.max_qual:
                    return -found, corrected
                ok = self._fix_right(
                    codes, quals, kmers, i, cfg.low,
                    max(cfg.high, a // 2), 2 * a, cfg.mult,
                )
                if ok:
                    corrected += 1
                    kmers, cov = self._kmers_cov(codes)
                else:
                    uncorrected += 1
                    break
            i -= 1
        return (-found if uncorrected else corrected), corrected

    def correct_read(self, codes: np.ndarray, quals) -> int:
        """correctErrors: returns corrections made (0 if clean, <0 means
        rolled back). Mutates codes/quals in place on success."""
        cfg = self.cfg
        copy = codes.copy()
        qcopy = quals.copy() if quals is not None else None
        budget = cfg.max_errors
        res_l, corr_l = self._scan_left(codes, quals, budget)
        if res_l < 0:
            codes[:] = copy
            if quals is not None:
                quals[:] = qcopy
            self.stats["rollbacks"] += 1
            return res_l
        budget -= res_l
        if budget > 0:
            copy2 = codes.copy()
            q2 = quals.copy() if quals is not None else None
            res_r, corr_r = self._scan_right(codes, quals, budget)
            if res_r < 0:
                codes[:] = copy2
                if quals is not None:
                    quals[:] = q2
                self.stats["rollbacks"] += 1
                return res_r
            res_l += res_r
        if res_l > 0:
            self.stats["reads_corrected"] += 1
            self.stats["errors_corrected"] += res_l
        return res_l

    # ---- batch driver ----
    def discontinuity_prefilter(self, bases: np.ndarray, lengths) -> np.ndarray:
        """Vectorized countDiscontinuities>0 over the batch (the cheap
        gate before the per-read loop)."""
        cfg = self.cfg
        k = self.k
        B, L = bases.shape
        fwd, rkm, runlen = rolling_kmers_np(bases, k)
        valid = (runlen >= k) & (
            np.arange(L)[None, :] < np.asarray(lengths)[:, None]
        )
        keys = np.maximum(fwd, rkm)
        cov = np.zeros((B, L), np.int64)
        flat_valid = valid.reshape(-1)
        if flat_valid.any():
            cov.reshape(-1)[flat_valid] = self.cms.query(
                keys.reshape(-1)[flat_valid]
            )
        # cov plane indexed by END position; discontinuity: min of prev 2
        # >= high while current collapses (countDiscontinuities uses a
        # 2-window; the scan proper uses PREFIX_LEN=3)
        c = cov
        a = np.minimum(
            np.roll(c, 1, axis=1), np.roll(c, 2, axis=1)
        )
        live = valid & np.roll(valid, 1, axis=1) & np.roll(valid, 2, axis=1)
        el = live & (a >= cfg.high) & ((c <= cfg.low) | (a >= c * cfg.mult))
        ar = np.minimum(np.roll(c, -1, axis=1), np.roll(c, -2, axis=1))
        liver = valid & np.roll(valid, -1, axis=1) & np.roll(valid, -2, axis=1)
        er = liver & (ar >= cfg.high) & ((c <= cfg.low) | (ar >= c * cfg.mult))
        return (el | er).any(axis=1)

    def correct_batch(self, bases: np.ndarray, lengths, quals) -> np.ndarray:
        """Correct flagged reads in place; returns per-read corrections."""
        out = np.zeros(len(lengths), np.int64)
        cand = self.discontinuity_prefilter(bases, lengths)
        for i in np.flatnonzero(cand):
            L = int(lengths[i])
            if L < self.k + PREFIX_LEN:
                continue
            codes = bases[i, :L]
            q = quals[i, :L] if quals is not None else None
            n = self.correct_read(codes, q)
            out[i] = max(n, 0)
        return out
