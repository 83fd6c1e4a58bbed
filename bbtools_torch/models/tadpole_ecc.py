"""Tadpole error correction (ecc) — pincer + tail modes with rollback.

Reference: assemble/Tadpole1.java errorCorrect (:1707-1800),
errorCorrectPincer (:1918-1973), errorCorrectTail (:1975-2032),
correctSingleBasePincer/Right (:2050-2120), with the shared predicates
from assemble/Tadpole.java: isError (:2445-2483, errorPath=1:
low*errorMult1*(1+q*errorMultQFactor) < high, or low<=errorLowerConst=4
and high>=max(minCountCorrect=3, low*errorMult2=2.6)), isSimilar
(:2393-2399: dif<pathSimilarityConstant=3 or dif<max*0.45),
countErrors (:2540-2556, skip k after a hit), hasErrorsFast
(:1663-1686, stride mid(1,k/2,9)), and the rollback rules
(:1765-1795: corrected>3 with remaining errors and
corrected>mult+expectedErrors, or any kmer count dropping non-similarly
below its original value).

Batch design: the cheap screens (hasErrorsFast, countErrors) and the
pincer/tail detectors are vectorized over whole read batches; only the
few reads that pass the screen take the per-error correction path
(extendToRight2-style walk re-using the sorted SpectrumTable lookups) —
the same work-skipping shape as the reference's per-thread fast path.

Deviation (round 1): extendToRight2's left-branch detection is omitted
(leftCounts=null in the reference's ecc call sites too); reassemble mode
falls back to an extra pincer+tail pass.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .tadpole import SpectrumTable, rc_kmer_arr

# Tadpole.java defaults (:2675-2694)
ERROR_MULT1 = 16.0
ERROR_MULT2 = 2.6
ERROR_MULT_Q_FACTOR = 0.002
ERROR_LOWER_CONST = 4
MIN_COUNT_CORRECT = 3
PATH_SIM_CONST = 3
PATH_SIM_FRACTION = 0.45
MIN_COUNT_SEED = 3
MIN_COUNT_EXTEND = 2
BRANCH_MULT1 = 20.0
BRANCH_LOWER_CONST = 3


@dataclass
class EccConfig:
    pincer: bool = True
    tail: bool = True
    reassemble: bool = True  # ECC_REASSEMBLE (:895, runs when the other
    # passes leave suspected errors)
    ecc_all: bool = True  # tail scan from position 0
    rollback: bool = True
    error_extension_pincer: int = 5
    error_extension_tail: int = 9
    error_extension_reassemble: int = 5
    dead_zone: int = 0


def is_error(high, low, q=20.0):
    """isError (:2469-2483, errorPath=1), vectorized."""
    high = np.asarray(high, np.float64)
    low = np.asarray(low, np.float64)
    em1 = ERROR_MULT1 * (1.0 + np.asarray(q, np.float64) * ERROR_MULT_Q_FACTOR)
    return (low * em1 < high) | (
        (low <= ERROR_LOWER_CONST)
        & (high >= np.maximum(MIN_COUNT_CORRECT, low * ERROR_MULT2))
    )


def is_similar(a, b):
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    mn = np.minimum(a, b)
    mx = np.maximum(a, b)
    dif = mx - mn
    return (dif < PATH_SIM_CONST) | (dif < mx * PATH_SIM_FRACTION)


def count_errors(counts: np.ndarray, quals, k: int) -> int:
    """countErrors: adjacent-count jumps, skipping k after each hit."""
    n = len(counts)
    possible = 0
    i = 1
    while i < n:
        a, b = int(counts[i - 1]), int(counts[i])
        qa = float(quals[i - 1]) if quals is not None else 20.0
        qb = float(quals[i + k - 1]) if quals is not None else 20.0
        err = (
            is_error(a, b, qb) if a >= b else is_error(b, a, qa)
        )
        if err:
            possible += 1
            i += k
        i += 1
    return possible


class _SmallKOps:
    """k <= 31 kmer primitives: state = (fwd:int, rc:int) rolling
    registers (kmer/HashBuffer-style single-long canonical keys)."""

    def __init__(self, table, k: int):
        self.t = table
        self.k = k
        self.mask = (1 << (2 * k)) - 1
        self.shift2 = 2 * (k - 1)

    def read_states(self, codes: np.ndarray):
        from ..ops.kmers import rolling_kmers_np

        k = self.k
        fwd, rkm, runlen = rolling_kmers_np(codes[None, :], k)
        valid = runlen[0] >= k
        keys = np.maximum(fwd[0], rkm[0])
        counts = np.where(valid, self.t.count_of(keys), -1)
        return counts[k - 1 :], (fwd[0][k - 1 :], rkm[0][k - 1 :])

    def at(self, states, a: int):
        return (int(states[0][a]), int(states[1][a]))

    def from_int(self, kmer: int):
        f = kmer & self.mask
        return (f, int(rc_kmer_arr(np.array([f], dtype=np.int64), self.k)[0]))

    def advance(self, st, x: int):
        f, r = st
        return (
            ((f << 2) | x) & self.mask,
            (r >> 2) | ((3 - x) << self.shift2),
        )

    def count(self, st) -> int:
        f, r = st
        return int(self.t.count_of(np.array([max(f, r)], dtype=np.int64))[0])

    def right_counts(self, st) -> np.ndarray:
        """Counts of the 4 right-neighbor kmers in one table lookup."""
        f, r = st
        nf = (f << 2) & self.mask
        nr = r >> 2
        cand_f = nf | np.arange(4, dtype=np.int64)
        cand_r = nr | ((3 - np.arange(4, dtype=np.int64)) << self.shift2)
        return self.t.count_of(np.maximum(cand_f, cand_r))


class _WordKOps:
    """k > 31 primitives over exact W-word registers (ukmer/Kmer.java
    multi-long analog): state = {"w": [1,W], "rw": [1,W]} int64, reusing
    WordKmerEngine's shift machinery and the sorted byte-key table."""

    def __init__(self, table, k: int):
        from .tadpole import WordKmerEngine

        self.t = table
        self.k = k
        self.eng = WordKmerEngine(table, k)

    def read_states(self, codes: np.ndarray):
        from ..ops.kmers2 import (
            canonical_words,
            rolling_kmersw_np,
            words_to_bytes,
        )

        k = self.k
        words, rwords, runlen = rolling_kmersw_np(codes[None, :], k)
        valid = runlen[0] >= k
        keys = words_to_bytes(canonical_words(words[0], rwords[0]))
        counts = np.where(valid, self.t.count_of(keys), -1)
        return counts[k - 1 :], (words[0][k - 1 :], rwords[0][k - 1 :])

    def at(self, states, a: int):
        return {
            "w": states[0][a : a + 1].copy(),
            "rw": states[1][a : a + 1].copy(),
        }

    def from_int(self, kmer: int):
        raise NotImplementedError("int kmers only exist for k<=31")

    def advance(self, st, x: int):
        st2 = {"w": st["w"].copy(), "rw": st["rw"].copy()}
        self.eng.advance_right(st2, slice(None), np.int64(x))
        return st2

    def count(self, st) -> int:
        return int(self.t.count_of(self.eng.key(st))[0])

    def right_counts(self, st) -> np.ndarray:
        keys = np.concatenate(
            [self.eng.key(self.advance(st, x)) for x in range(4)]
        )
        return self.t.count_of(keys)


class EccEngine:
    def __init__(self, table: SpectrumTable, k: int, cfg: EccConfig = None):
        self.table = table
        self.k = k
        self.cfg = cfg or EccConfig()
        self.ops = (
            _WordKOps(table, k) if k > 31 else _SmallKOps(table, k)
        )
        self.stats = {
            "reads_corrected": 0,
            "errors_corrected_pincer": 0,
            "errors_corrected_tail": 0,
            "rollbacks": 0,
        }

    # ---- count planes ----
    def read_counts(self, codes: np.ndarray):
        """counts[i] for kmer starting at position i (-1 for kmers with
        undefined bases, fillKmers semantics), plus opaque per-position
        kmer states usable via self.ops.at(states, i)."""
        return self.ops.read_states(codes)

    def has_errors_fast(self, counts: np.ndarray) -> bool:
        k = self.k
        n = len(counts)
        if n < 1:
            return False
        incr = min(max(1, k // 2), 9)
        idx = list(range(0, n, incr))
        if idx[-1] != n - 1:
            idx.append(n - 1)
        prev = -1
        for j, i in enumerate(idx):
            c = int(counts[i])
            if c < 0:
                return True
            mn, mx = min(c, prev), max(c, prev)
            if c < MIN_COUNT_CORRECT or (
                j > 0 and is_error(mx + 1, mn - 1)
            ):
                return True
            prev = c
        return False

    # ---- extendToRight2-style walk (:1363-1470) ----
    def _extend_right(self, kmer_or_state, distance: int) -> tuple:
        """Greedy extension; returns (bases_list, extension). Accepts a
        plain int kmer (k<=31 callers) or an ops state."""
        ops = self.ops
        st = (
            ops.from_int(int(kmer_or_state))
            if isinstance(kmer_or_state, (int, np.integer))
            else kmer_or_state
        )
        out = []
        if ops.count(st) < MIN_COUNT_SEED:
            return out, 0
        for _ in range(distance):
            cnts = ops.right_counts(st)
            order = np.argsort(-cnts, kind="stable")
            mx, second = int(cnts[order[0]]), int(cnts[order[1]])
            if mx < MIN_COUNT_EXTEND:
                break
            # isJunction (branchMult1): a strong second path stops us
            if second > BRANCH_LOWER_CONST and second * BRANCH_MULT1 > mx:
                break
            out.append(int(order[0]))
            st = ops.advance(st, int(order[0]))
        return out, len(out)

    def _similar_after_sub(self, state, new_code: int, a_count: int):
        c = self.ops.count(self.ops.advance(state, new_code))
        return bool(is_similar(a_count, c))

    # ---- per-read correction ----
    def correct_read(self, codes: np.ndarray, quals) -> int:
        """Mutates codes in place; returns corrections applied."""
        cfg, k = self.cfg, self.k
        counts, states = self.read_counts(codes)
        n = len(counts)
        if n < 2 or not self.has_errors_fast(counts):
            return 0
        counts0 = counts.copy()
        codes0 = codes.copy()
        corrected_p = corrected_t = 0

        if cfg.pincer:
            corrected_p = self._pincer_pass(codes, quals, counts, states)
        if cfg.tail:
            corrected_t = self._tail_pass(codes, quals)
            # reverse orientation (:1739-1743)
            rc = np.where(codes0 < 4, 3 - codes, 4)[::-1].copy()
            rc_q = quals[::-1] if quals is not None else None
            ct2 = self._tail_pass(rc, rc_q)
            if ct2:
                codes[:] = np.where(rc < 4, 3 - rc, 4)[::-1]
                corrected_t += ct2

        corrected_r = 0
        if cfg.reassemble:
            # only when the cheaper passes left work (:1745-1748)
            counts_now, _ = self.read_counts(codes)
            if (corrected_p + corrected_t) < 1 or count_errors(
                counts_now, quals, self.k
            ) > 0:
                corrected_r = self._reassemble_pass(codes, quals)

        total = corrected_p + corrected_t + corrected_r
        if total == 0:
            return 0

        if cfg.rollback:
            counts_new, _ = self.read_counts(codes)
            rollback = False
            if quals is not None and total > 3:
                L = len(codes)
                mult = max(1.0, 0.5 * (0.5 + 0.01 * L))
                from ..core.qualtools import PROB_ERROR

                expected = float(
                    PROB_ERROR[np.clip(quals, 0, 127)].sum()
                )
                if count_errors(counts_new, quals, k) > 0 and (
                    total > mult + expected
                ):
                    rollback = True
                elif total > 2.5 * mult + expected:
                    rollback = True
            if not rollback:
                a = np.maximum(counts0, 0)
                b = np.maximum(counts_new, 0)
                bad = (b < a - 1) & ~is_similar(a, b)
                rollback = bool(bad.any())
            if rollback:
                codes[:] = codes0
                self.stats["rollbacks"] += 1
                return 0

        self.stats["reads_corrected"] += 1
        self.stats["errors_corrected_pincer"] += corrected_p
        self.stats["errors_corrected_tail"] += corrected_t
        self.stats["errors_corrected_reassemble"] = (
            self.stats.get("errors_corrected_reassemble", 0) + corrected_r
        )
        return total

    def _pincer_pass(self, codes, quals, counts, states) -> int:
        """errorCorrectPincer (:1918-1973): error between kmers a and d
        where d = a+k+1; the suspect base is at a+k."""
        cfg, k = self.cfg, self.k
        n = len(counts)
        if n < k + 2:
            return 0
        corrected = 0
        a_idx = np.arange(0, n - k - 1)
        aC = counts[a_idx]
        bC = counts[a_idx + 1]
        cC = counts[a_idx + k]
        dC = counts[a_idx + k + 1]
        qb = (
            quals[a_idx + k].astype(np.float64)
            if quals is not None
            else np.full(len(a_idx), 20.0)
        )
        det = (
            is_error(aC, bC, qb) & is_error(dC, cC, qb) & is_similar(aC, dC)
            & (aC >= 0) & (dC >= 0)
        )
        for a in np.nonzero(det)[0]:
            loc = a + k
            st_a = self.ops.at(states, a)
            ext_bases, ext = self._extend_right(
                st_a, cfg.error_extension_pincer
            )
            if ext < cfg.error_extension_pincer:
                continue
            # extension must agree with the read downstream of the error
            ok = all(
                loc + i >= len(codes) or ext_bases[i] == codes[loc + i]
                for i in range(1, ext)
            )
            if not ok:
                continue
            repl = ext_bases[0]
            if repl == codes[loc]:
                continue
            if not self._similar_after_sub(st_a, repl, int(counts[a])):
                continue
            codes[loc] = repl
            counts, states = self.read_counts(codes)
            corrected += 1
        return corrected

    def _tail_pass(self, codes, quals) -> int:
        """errorCorrectTail (:1975-2032) in the current orientation."""
        cfg, k = self.cfg, self.k
        counts, states = self.read_counts(codes)
        n = len(counts)
        ee = cfg.error_extension_tail
        if len(codes) < k + 2 + ee + cfg.dead_zone:
            return 0
        corrected = 0
        start = 0 if cfg.ecc_all else max(0, n - k - 1)
        a = max(start, ee)
        lim = n - cfg.dead_zone - 1
        while a < lim:
            aC, bC = int(counts[a]), int(counts[a + 1])
            qb = float(quals[a + k]) if quals is not None else 20.0
            lo1 = max(a - ee, 0)
            sim_left = bool(
                is_similar(aC, counts[lo1 : a]).all()
            ) if a > lo1 else True
            hi2 = min(a + k, n - 1)
            err_right = bool(
                is_error(aC, counts[a + 2 : hi2 + 1], qb).all()
            ) if a + 2 <= hi2 else True
            if (
                aC >= 0
                and is_error(aC, bC, qb)
                and sim_left
                and err_right
            ):
                loc = a + k
                dist = min(ee, len(codes) - loc)
                st_a = self.ops.at(states, a)
                ext_bases, ext = self._extend_right(st_a, dist)
                if ext >= dist and ext > 0:
                    ok = all(
                        loc + i >= len(codes)
                        or ext_bases[i] == codes[loc + i]
                        for i in range(1, ext)
                    )
                    repl = ext_bases[0]
                    if (
                        ok
                        and repl != codes[loc]
                        and self._similar_after_sub(st_a, repl, aC)
                    ):
                        codes[loc] = repl
                        corrected += 1
                        counts, states = self.read_counts(codes)
            a += 1
        return corrected

    def _reassemble_pass(self, codes, quals) -> int:
        """reassemble_inner (Tadpole1.java:2255-2330): at each suspected
        substitution, replace the base with the strongest right-extension
        of the preceding kmer when that consensus is unambiguous."""
        cfg, k = self.cfg, self.k
        ee = cfg.error_extension_reassemble
        counts, states = self.read_counts(codes)
        n = len(counts)
        if len(codes) < k + 1 + cfg.dead_zone:
            return 0
        corrected = 0
        ca = 0
        lim = n - cfg.dead_zone - 1
        while ca < lim:
            aC, bC = int(counts[ca]), int(counts[ca + 1])
            b = ca + k  # read position of the suspect base
            qb = float(quals[b]) if quals is not None else 20.0
            lo1 = max(ca - ee, 0)
            sim_left = (
                bool(is_similar(aC, counts[lo1:ca]).all()) if ca > lo1 else True
            )
            hi2 = min(ca + k, n - 1)
            err_right = (
                bool(is_error(aC, counts[ca + 2 : hi2 + 1], qb).all())
                if ca + 2 <= hi2
                else True
            )
            if aC >= 0 and is_error(aC, bC, qb) and sim_left and err_right:
                cnts = self.ops.right_counts(self.ops.at(states, ca))
                order = np.argsort(-cnts, kind="stable")
                mx, second = int(cnts[order[0]]), int(cnts[order[1]])
                obs = int(codes[b])
                if (
                    mx >= MIN_COUNT_EXTEND
                    and obs != int(order[0])
                    and (
                        is_error(mx, second, qb)
                        or not (
                            second > BRANCH_LOWER_CONST
                            and second * BRANCH_MULT1 > mx
                        )
                    )
                    and is_similar(aC, mx)
                ):
                    codes[b] = int(order[0])
                    corrected += 1
                    counts, states = self.read_counts(codes)
            ca += 1
        return corrected

    # ---- batch driver ----
    def correct_batch(self, bases: np.ndarray, lengths: np.ndarray, quals):
        """Vectorized screen, then per-flagged-read correction.
        Returns corrections per read [B]."""
        B = bases.shape[0]
        out = np.zeros(B, dtype=np.int64)
        for i in range(B):
            L = int(lengths[i])
            if L < self.k + 2:
                continue
            codes = bases[i, :L].copy()
            q = quals[i, :L] if quals is not None else None
            nc = self.correct_read(codes, q)
            if nc > 0:
                bases[i, :L] = codes
                out[i] = nc
        return out
