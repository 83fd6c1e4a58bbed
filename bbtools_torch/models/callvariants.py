"""CallVariants — pileup-free variant calling from SAM (BASELINE config #5b).

Re-design of var2/CallVariants.java:51 (process :753, makeVarMap :804):
per-read Var extraction from long match strings (Var.toVars :408,
transcribed exactly), hash-merged VarMap, per-scaffold coverage arrays,
the full statistical scoring model (Var.java — coverageScore :1560,
edistScore, baseQualityScore with the recalibration fudge, mapQualityScore,
pairedScore, strand/read biasScore via the VarProb cumulative-binomial
matrix :155-183, identityScore, homopolymerScore; composite = geometric
mean^0.2, phred = 2.5*probErrorToPhred(1-0.998*score)), the VarFilter
tier stack (VarFilter.passesFilter, defaults :323-346), and VCF output
with the reference's INFO fields.

The PyTorch port of bbtools_tpu/models/callvariants.py: host numpy but
for two device steps on the tool's device (`device=`, cuda by default),
the realignment's fill (`ops.msa.realign_batch`, realign=t) and the
scoring net (`ml.cellnet`, nn=t). The bundled nets are read by path
from bbtools_tpu/resources/.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fasta import Reference, load_reference
from ..io.readwrite import open_output
from ..io.sam_read import cigar_to_match, iter_sam, parse_cigar
from ..core.dna import CODE_TO_BASE

SUB, INS, DEL, NOCALL, LJUNCT, RJUNCT = 0, 1, 2, 3, 4, 5
TYPE_NAMES = ["SUB", "INS", "DEL", "NOCALL", "LJUNCT", "RJUNCT"]

# Var.java statics
LOW_COVERAGE_PENALTY = 0.8
N_SCAN = 600
MIN_END_DIST_FOR_BIAS = 200
PROBLEN = 100


def _make_prob_matrix():
    """VarProb cumulative binomial matrix (:155-183)."""
    binom = np.zeros((PROBLEN + 1, PROBLEN + 1))
    for n in range(PROBLEN + 1):
        binom[n, 0] = 1.0
        for k in range(1, n + 1):
            binom[n, k] = binom[n - 1, k - 1] + (binom[n - 1, k] if k <= n - 1 else 0)
    prob = []
    mult = 2.0
    for n in range(PROBLEN + 1):
        kmax = n // 2
        arr = np.zeros(kmax + 1)
        for k in range(kmax + 1):
            arr[k] = binom[n, k] * mult
        for k in range(kmax + 1):
            arr[k] = min(1.0, (arr[k - 1] if k > 0 else 0.0) + arr[k])
        prob.append(arr)
        mult *= 0.5
    return prob


_PROB = _make_prob_matrix()


def event_prob(a: int, b: int) -> float:
    """VarProb.eventProb — strand/read bias significance."""
    allowed_bias = 0.75
    slop_mult = 0.95
    n = float(a + b)
    k = float(min(a, b))
    slop = n * (allowed_bias * 0.5)
    dif = n - k * 2
    dif = dif - (min(slop, dif) * slop_mult)
    n = k * 2 + dif
    if n > PROBLEN:
        mult = PROBLEN / n
        n = PROBLEN
        k = int(k * mult)
    n2 = int(round(n))
    k2 = min(n2 // 2, int(k + 1))
    result = _PROB[n2][k2]
    if result < 1 or a == b or a + 1 == b or a == b + 1:
        return result
    slope = min(a, b) / max(a, b, 1)
    return 0.998 + slope * 0.002


def prob_error_to_phred_double(prob: float) -> float:
    if prob >= 1:
        return 0.0
    if prob <= 0.000001:
        return 60.0
    return -10.0 * math.log10(prob)


def to_phred_score(score: float) -> float:
    if score == 0:
        return 0.0
    score = score * 0.998
    return 2.5 * prob_error_to_phred_double(1 - score)


@dataclass
class Var:
    scafnum: int
    start: int
    stop: int
    allele: bytes  # ascii bases; b"" for DEL
    type: int
    r1plus: int = 0
    r1minus: int = 0
    r2plus: int = 0
    r2minus: int = 0
    properPairCount: int = 0
    lengthSum: int = 0
    mapQSum: int = 0
    mapQMax: int = 0
    baseQSum: int = 0
    baseQMax: int = 0
    endDistSum: int = 0
    endDistMax: int = 0
    idSum: int = 0
    idMax: int = 0
    coverage: int = -1
    #: forced-variant mode (var2/CallVariants.java invcf= :275): vars
    #: loaded from an input VCF always pass filtering (VarMap.java:140
    #: pass = v.forced() || passesFilter) and skip the nearby gate
    forced: bool = False

    def key(self):
        return (self.scafnum, self.start, self.stop, self.allele, self.type)

    def allele_count(self):
        return self.r1plus + self.r1minus + self.r2plus + self.r2minus

    def allele_plus(self):
        return self.r1plus + self.r2plus

    def allele_minus(self):
        return self.r1minus + self.r2minus

    def reflen(self):
        return self.stop - self.start

    def readlen(self):
        return len(self.allele) if self.type != DEL else 0

    def merge(self, o: "Var"):
        self.r1plus += o.r1plus
        self.r1minus += o.r1minus
        self.r2plus += o.r2plus
        self.r2minus += o.r2minus
        self.properPairCount += o.properPairCount
        self.lengthSum += o.lengthSum
        self.mapQSum += o.mapQSum
        self.mapQMax = max(self.mapQMax, o.mapQMax)
        self.baseQSum += o.baseQSum
        self.baseQMax = max(self.baseQMax, o.baseQMax)
        self.endDistSum += o.endDistSum
        self.endDistMax = max(self.endDistMax, o.endDistMax)
        self.idSum += o.idSum
        self.idMax = max(self.idMax, o.idMax)

    # ---- scoring (Var.java formulas, transcribed) ----
    def coverage_score(self, ploidy, rarity, read_length_avg):
        count = self.allele_count()
        if count == 0:
            return 0.0
        raw = count / (LOW_COVERAGE_PENALTY + count)
        ratio = 0.98
        if self.coverage > 0:
            dif = self.coverage - count
            if dif > 0:
                dif = dif - self.coverage * 0.01 - min(0.5, self.coverage * 0.1)
                dif = max(0.1, dif)
            ratio = (self.coverage - dif) / self.coverage
            if rarity < 1 and ratio > rarity:
                min_expected = 1.0 / ploidy
                if ratio < min_expected:
                    ratio = min_expected - ((min_expected - ratio) * 0.1)
        ratio2 = min(1.0, ploidy * ratio)
        return raw * ratio2

    def edist_score(self):
        count = self.allele_count()
        length_avg = self.lengthSum / max(count, 1)
        edist_avg = (self.endDistSum / max(count, 1) * 2 + self.endDistMax) * 0.333333333333
        constant = 5 + min(20, length_avg * 0.1) + length_avg * 0.01
        weighted = max(0.05, edist_avg - min(constant, edist_avg * 0.95))
        weighted = weighted * weighted
        return weighted / (weighted + 4)

    def base_quality_score(self, total_baseq_avg):
        count = self.allele_count()
        bq_avg = self.baseQSum / max(count, 1)
        if total_baseq_avg < 32 and bq_avg < 32:
            f1 = 0.75 * (32 - total_baseq_avg)
            f2 = 0.75 * (32 - bq_avg)
            total_baseq_avg += f1
            bq_avg += min(f1, f2)
        delta = total_baseq_avg - bq_avg
        if delta > 0:
            bq_avg = max(bq_avg * 0.5, bq_avg - 0.5 * delta)
        mult = 0.25
        thresh = 12
        if bq_avg > thresh:
            bq_avg = bq_avg - thresh + thresh * mult
        else:
            bq_avg = bq_avg * mult
        p = 1 - 10 ** (-0.1 * bq_avg)
        return p * p

    def map_quality_score(self):
        count = self.allele_count()
        mq_avg = 0.5 * (self.mapQSum / max(count, 1) + self.mapQMax)
        return 1 - 10 ** (-0.1 * (mq_avg + 2))

    def modify_by_end_dist(self, x, scaf_end_dist):
        if x >= 0.99 or scaf_end_dist >= N_SCAN:
            return x
        if scaf_end_dist < MIN_END_DIST_FOR_BIAS:
            return max(x, 0.98 + 0.02 * x)
        delta = 1 - x
        delta = delta * (scaf_end_dist * scaf_end_dist) / (N_SCAN * N_SCAN)
        return 1 - delta

    def paired_score(self, proper_pair_rate, scaf_end_dist):
        if proper_pair_rate < 0.5:
            return 0.98
        count = self.allele_count()
        if count == 0:
            return 0.0
        rate = self.properPairCount / count
        rate = rate * (count / (0.1 + count))
        if rate * 1.05 >= proper_pair_rate:
            return max(rate, 1 - 0.001 * proper_pair_rate)
        score = ((rate * 1.05) / proper_pair_rate) * 0.5 + 0.5
        score = max(0.1, score)
        return self.modify_by_end_dist(score, scaf_end_dist)

    def strand_bias_score(self, scaf_end_dist):
        plus = self.allele_plus()
        minus = self.allele_minus()
        x = event_prob(plus, minus)
        x2 = self.modify_by_end_dist(x, scaf_end_dist)
        result = x2
        if plus + minus >= 20 and x2 < 0.9:
            mn, mx = min(plus, minus), max(plus, minus)
            if mn > 1 and mn > 0.06 * mx:
                y = 0.15 + (0.2 * mn) / mx
                result = y + (1 - y) * x2
        return result

    def read_bias_score(self, proper_pair_rate):
        if proper_pair_rate < 0.5:
            return 0.95
        r1 = self.r1plus + self.r1minus
        r2 = self.r2plus + self.r2minus
        x = event_prob(r1, r2)
        x2 = 0.10 + 0.90 * x
        result = x2
        if r1 + r2 >= 20 and x2 < 0.9:
            mn, mx = min(r1, r2), max(r1, r2)
            if mn > 1 and mn > 0.07 * mx:
                y = 0.15 + (0.2 * mn) / mx
                result = y + (1 - y) * x2
        return result

    def bias_score(self, proper_pair_rate, scaf_end_dist):
        return math.sqrt(
            self.strand_bias_score(scaf_end_dist)
            * self.read_bias_score(proper_pair_rate)
        )

    def identity_score(self):
        count = self.allele_count()
        length_avg = self.lengthSum / max(count, 1)
        id_avg = 0.001 * ((self.idSum / max(count, 1) + self.idMax) * 0.5)
        weighted = min(
            1.0,
            (id_avg * length_avg + 0.65 * max(1, self.readlen())) / max(length_avg, 1),
        )
        return 0.75 + 0.25 * weighted

    def homopolymer_count(self, ref: Reference):
        bases = ref.scaffold_codes(self.scafnum)
        if self.type == SUB:
            if len(self.allele) != 1:
                return 0
            base = _code(self.allele[0])
            return _hp_sub(bases, self.start, base)
        if self.type == INS:
            if not self.allele:
                return 0
            b1, b2 = _code(self.allele[0]), _code(self.allele[-1])
            i = 0
            while i < len(self.allele) and _code(self.allele[i]) == b1:
                i += 1
            while i < len(self.allele) and _code(self.allele[i]) == b2:
                i += 1
            if i < len(self.allele):
                return 0
            left = _hp_left(bases, self.start, b1)
            right = _hp_right(bases, self.stop + 1, b2)
            return left + right + 1
        if self.type == DEL:
            if self.start < 0 or self.start + 1 >= len(bases) or self.stop <= 0 or self.stop >= len(bases):
                return 0
            b1, b2 = bases[self.start + 1], bases[self.stop - 1]
            pos = self.start + 1
            while pos <= self.stop and bases[pos] == b1:
                pos += 1
            while pos <= self.stop and bases[pos] == b2:
                pos += 1
            if pos <= self.stop:
                return 0
            # DEL_ANCHOR_EXCLUSIVE=true in CallVariants
            left = _hp_left(bases, self.start - 1, b1)
            right = _hp_right(bases, self.stop, b2)
            return left + right + 1
        return 0

    def homopolymer_score(self, ref):
        count = self.homopolymer_count(ref)
        if count < 2:
            return 1.0
        return 1.0 - count * 0.1 / 9

    def contig_end_dist(self, ref: Reference):
        scaflen = int(ref.lengths[self.scafnum])
        return min(self.start, max(0, scaflen - self.stop))

    def score(self, proper_pair_rate, total_quality_avg, total_mapq_avg,
              read_length_avg, rarity, ploidy, ref):
        scaf_end_dist = self.contig_end_dist(ref)
        cs = self.coverage_score(ploidy, rarity, read_length_avg)
        if cs == 0:
            return 0.0
        es = self.edist_score()
        qs = self.base_quality_score(total_quality_avg) * self.map_quality_score()
        ps = self.paired_score(proper_pair_rate, scaf_end_dist)
        bs = self.bias_score(proper_pair_rate, scaf_end_dist)
        iscore = self.identity_score()
        hs = self.homopolymer_score(ref)
        return (es * qs * ps * bs * cs * iscore * hs) ** 0.2

    def phred_score(self, *args):
        return to_phred_score(self.score(*args))

    def allele_fraction(self):
        count = self.allele_count()
        cov = max(count, self.coverage, 1)
        return count / cov

    def strand_ratio(self):
        plus, minus = self.allele_plus(), self.allele_minus()
        if plus == minus:
            return 1.0
        return (min(plus, minus) + 1) / max(plus, minus)

    def revised_allele_fraction(self, af, read_length_avg):
        """Var.adjustForInsertionLength (Var.java:1696-1707): long
        insertions near read ends underreport AF; adjust upward."""
        if self.type != INS:
            return af
        ilen = self.readlen()
        if ilen < 2:
            return af
        rlen = max(ilen * 1.2 + 6, read_length_avg)
        sites = rlen + ilen - 1
        good_sites = rlen - ilen * 1.1 - 6
        expected = good_sites / sites
        if expected <= 0:
            return af
        return min(af / expected, 1 - (1 - af) * 0.1)


def scale_net_score(output: float, cutoff: float) -> float:
    """Var.scaleNetScore (Var.java:1374): QUAL 20 at the net cutoff,
    linear ramps below and above."""
    if output <= cutoff:
        return 20.0 * output / max(cutoff, 1e-9)
    return 20.0 + 20.0 * (output - cutoff) / max(1.0 - cutoff, 1e-9)


def count_nearby_vars(svars: list, dist: int = 20, gap: int = 2) -> list[int]:
    """VarMap.countNearbyVars (VarMap.java:178-215) over the sorted
    variant list: neighbors within `dist` of the target, chained with
    inter-variant gaps <= `gap` (defaults VarFilter.java:351-353)."""
    out = [0] * len(svars)
    for i, v0 in enumerate(svars):
        nearby = 0
        prev = v0
        for j in range(i - 1, -1, -1):
            v = svars[j]
            if v.scafnum != v0.scafnum:
                break
            if prev.start - v.stop > gap or v0.start - v.stop > dist:
                break
            nearby += 1
            prev = v
        prev = v0
        for j in range(i + 1, len(svars)):
            v = svars[j]
            if v.scafnum != v0.scafnum:
                break
            if v.start - prev.stop > gap or v.start - v0.stop > dist:
                break
            nearby += 1
            prev = v
        out[i] = nearby
    return out


def _log2p1(x: float) -> float:
    import math

    return math.log(max(x, 0) + 1) / math.log(2)


def make_ump45_vector(v: Var, pairing_rate, total_quality_avg,
                      total_mapq_avg, read_length_avg, ploidy, ref,
                      nearby: int, platform: int = 0) -> np.ndarray:
    """VectorUMP45.makeVector (var2/VectorUMP45.java:32-120): the 33-dim
    feature vector the bundled callvars_*.bbnet models consume."""
    vec = np.zeros(33, np.float32)
    count = v.allele_count()
    af = v.allele_fraction()
    vec[0] = 1.0 / ploidy
    if v.type == SUB:
        vec[1] = 1
    elif v.type == INS:
        vec[2] = 1
    elif v.type == DEL:
        vec[3] = 1
    vec[4 + min(max(platform, 0), 3)] = 1
    vec[8] = _log2p1(max(v.coverage, 0)) / 8
    vec[9] = _log2p1(count) / 8
    vec[10] = af
    vec[11] = v.revised_allele_fraction(af, read_length_avg)
    vec[12] = (v.mapQSum / count / 40) if count > 0 else 0
    vec[13] = v.mapQMax / 40
    vec[14] = (v.baseQSum / count / 40) if count > 0 else 0
    vec[15] = v.baseQMax / 40
    vec[16] = (2 * (v.idSum / count) * 0.001 - 1) if count > 0 else 0
    vec[17] = 2 * v.idMax * 0.001 - 1
    vec[18] = _log2p1(v.endDistSum / count) / 4 if count > 0 else 0
    vec[19] = _log2p1(v.endDistMax) / 4
    vec[20] = _log2p1(v.lengthSum / count if count > 0 else 0) / 4
    vec[21] = _log2p1(max(v.reflen(), v.readlen())) / 8
    vec[22] = v.strand_ratio()
    vec[23] = event_prob(v.allele_plus(), v.allele_minus())
    r1 = v.r1plus + v.r1minus
    r2 = v.r2plus + v.r2minus
    vec[24] = 1.0 if r1 + r2 == 0 else (min(r1, r2) + 1) / max(r1, r2)
    vec[25] = event_prob(r1, r2)
    vec[26] = 1.0 / (max(nearby, 0) + 1)
    vec[27] = 0 if count == 0 else v.properPairCount / count
    vec[28] = 1.0 / (v.homopolymer_count(ref) + 1)
    # vec[29] composite score: disabled by default (includeScore=false)
    vec[30] = _log2p1(v.contig_end_dist(ref)) / 8
    vec[31] = 0  # reserved
    vec[32] = 1.0 if ploidy > 1 else 0.0
    return vec


def _code(ascii_b):
    from ..core.dna import BASE_TO_CODE

    return int(BASE_TO_CODE[ascii_b])


def _hp_sub(bases, pos, base):
    if pos < 0 or pos >= len(bases):
        return 0
    if base >= 4:
        return 0
    c1 = 0
    for i in range(pos - 1, max(0, pos - 4) - 1, -1):
        if bases[i] == base:
            c1 += 1
        else:
            break
    c2 = 0
    for i in range(pos + 1, min(len(bases), pos + 5)):
        if bases[i] == base:
            c2 += 1
        else:
            break
    return c1 + c2 + (1 if c1 > 0 and c2 > 0 else 0)


def _hp_left(bases, pos, base):
    if pos < 0 or pos >= len(bases) or bases[pos] != base or base >= 4:
        return 0
    c = 0
    for i in range(pos, max(0, pos - 3) - 1, -1):
        if bases[i] == base:
            c += 1
        else:
            break
    return c


def _hp_right(bases, pos, base):
    if pos < 0 or pos >= len(bases) or bases[pos] != base or base >= 4:
        return 0
    c = 0
    for i in range(pos, min(len(bases), pos + 4)):
        if bases[i] == base:
            c += 1
        else:
            break
    return c


@dataclass
class VarFilter:
    """VarFilter defaults (:323-346)."""

    min_allele_depth: int = 2
    min_cov: int = -1
    min_max_quality: int = 15
    min_max_edist: int = 20
    min_max_mapq: int = 0
    min_max_identity: float = 0
    min_pairing_rate: float = 0.1
    min_strand_ratio: float = 0.1
    min_score: float = 20
    min_avg_quality: float = 12
    min_avg_edist: float = 10
    min_avg_mapq: float = 0
    min_identity: float = 0
    min_allele_fraction: float = 0.1
    rarity: float = 1.0

    def passes(self, v: Var, pairing_rate, total_quality_avg, total_mapq_avg,
               read_length_avg, ploidy, ref):
        count = v.allele_count()
        if count < self.min_allele_depth:
            return False
        if v.coverage < self.min_cov:
            return False
        if v.baseQMax < self.min_max_quality:
            return False
        if v.endDistMax < self.min_max_edist:
            return False
        if v.mapQMax < self.min_max_mapq:
            return False
        if v.idMax * 0.001 < self.min_max_identity:
            return False
        if pairing_rate > 0 and self.min_pairing_rate > 0 and count * self.min_pairing_rate > v.properPairCount:
            return False
        if self.min_avg_quality > 0 and count * self.min_avg_quality > v.baseQSum:
            return False
        if self.min_avg_edist > 0 and count * self.min_avg_edist > v.endDistSum:
            return False
        if self.min_avg_mapq > 0 and count * self.min_avg_mapq > v.mapQSum:
            return False
        if self.min_strand_ratio > 0 and v.strand_ratio() < self.min_strand_ratio:
            return False
        if self.min_allele_fraction > 0 and v.coverage > 0:
            if v.allele_fraction() < self.min_allele_fraction:
                return False
        if self.min_score > 0:
            ps = v.phred_score(
                pairing_rate, total_quality_avg, total_mapq_avg,
                read_length_avg, self.rarity, ploidy, ref,
            )
            if ps < self.min_score:
                return False
        return True


def identity_skewed(match: bytes) -> int:
    """Read.identitySkewed(match, false, false, false, true)*1000."""
    good = bad = 0
    mode = 0
    current = 0
    for m in match:
        if mode == m:
            current = max(current + 1, 2)
        else:
            current = max(current, 1)
            if mode == ord("m"):
                good += current
            elif mode == ord("D"):
                bad += min(1, current)
            elif mode in (ord("R"), ord("N")):
                pass
            elif mode in (ord("C"), ord("V")):
                pass
            elif mode != 0:
                bad += current
            mode = m
            current = 0
    if current > 0 or True:
        current = max(current, 1)
        if mode == ord("m"):
            good += current
        elif mode in (ord("R"), ord("N"), ord("C"), ord("V")):
            pass
        elif mode == ord("D"):
            bad += min(1, current)
        elif mode != 0:
            bad += current
    r = good / max(good + bad, 1)
    return int(1000 * r)


def extract_vars(rec, match: bytes, scafnum: int, quals: np.ndarray,
                 call_ns=False):
    """Var.toSubsAndIndels (:446-560) transliteration. quals = phred ints."""
    out = []
    rpos0 = rec.pos - 1
    bases = rec.seq
    readlen = len(bases)
    mode = -1
    bstart = rstart = -1
    bpos, rpos = 0, rpos0
    mlen = len(match)

    def add_evidence(v, b0, b1):
        if rec.strand == 0:
            v.r1plus += 1 if rec.pairnum == 0 else 0
            v.r2plus += 0 if rec.pairnum == 0 else 1
        else:
            v.r1minus += 1 if rec.pairnum == 0 else 0
            v.r2minus += 0 if rec.pairnum == 0 else 1
        v.lengthSum += readlen
        v.properPairCount += 1 if rec.proper_pair else 0
        v.mapQSum += rec.mapq
        v.mapQMax = max(v.mapQMax, rec.mapq)
        baseq = _calc_baseq(v, b0, b1, quals, readlen)
        v.baseQSum += baseq
        v.baseQMax = max(v.baseQMax, baseq)
        ed = min(b0, readlen - b1)
        v.endDistSum += ed
        v.endDistMax = max(v.endDistMax, ed)
        iid = identity_skewed(match)
        v.idSum += iid
        v.idMax = max(v.idMax, iid)

    for mpos in range(mlen + 1):
        m = match[mpos] if mpos < mlen else -1
        if m != mode:
            if mode == ord("D"):
                v = Var(scafnum, rstart, rpos, b"", DEL)
                add_evidence(v, bstart, bpos)
                out.append(v)
                bstart = rstart = -1
            elif mode == ord("I"):
                v = Var(scafnum, rstart, rpos, bases[bstart:bpos], INS)
                add_evidence(v, bstart, bpos)
                out.append(v)
                bstart = rstart = -1
        if mpos >= mlen:
            break
        if m == ord("C"):
            bpos += 1
        elif m in (ord("m"), ord("S"), ord("N")):
            if m == ord("S") or (m == ord("N") and call_ns):
                v = Var(scafnum, rpos, rpos + 1, bases[bpos : bpos + 1], SUB)
                add_evidence(v, bpos, bpos + 1)
                out.append(v)
            bpos += 1
            rpos += 1
        elif m == ord("D"):
            if mode != m:
                rstart = rpos
                bstart = bpos
            rpos += 1
        elif m == ord("I"):
            if mode != m:
                rstart = rpos
                bstart = bpos
        elif m in (ord("X"), ord("Y")):
            # off-end insertions: treat like clipping for var purposes
            bpos += 1
        if m == ord("I"):
            bpos += 1
        mode = m
    return out


def extract_junctions(rec, match: bytes, scafnum: int, quals, min_clip=8):
    """VarHelper.toJunctions (VarHelper.java:372-421): clipped read ends
    >= min_clip become junction variants at the clip boundary — the
    breakpoint evidence CallVariants emits with junctions=t. The left
    junction sits at the first aligned base (pos-1), the right at
    one past the last aligned base; the allele is the clipped base
    adjacent to the boundary."""
    C = ord("C")
    n = len(match)
    left = 0
    while left < n and match[left] == C:
        left += 1
    right = 0
    while right < n and match[n - 1 - right] == C:
        right += 1
    out = []
    bases = rec.seq
    reflen = sum(
        1 for ch in match if ch in (ord("m"), ord("S"), ord("N"), ord("D"))
    )
    if left >= min_clip:
        bpos = left - 1
        jpos = rec.pos - 1
        v = Var(scafnum, jpos, jpos + 1, bases[bpos : bpos + 1], LJUNCT)
        out.append((v, bpos, bpos + 1))
    if right >= min_clip:
        bpos = len(bases) - right
        jpos = rec.pos - 1 + reflen
        v = Var(scafnum, jpos, jpos + 1, bases[bpos : bpos + 1], RJUNCT)
        out.append((v, bpos, bpos + 1))
    readlen = len(bases)
    iid = identity_skewed(match)
    for v, b0, b1 in out:
        if rec.strand == 0:
            v.r1plus += 1 if rec.pairnum == 0 else 0
            v.r2plus += 0 if rec.pairnum == 0 else 1
        else:
            v.r1minus += 1 if rec.pairnum == 0 else 0
            v.r2minus += 0 if rec.pairnum == 0 else 1
        v.lengthSum += readlen
        v.properPairCount += 1 if rec.proper_pair else 0
        v.mapQSum += rec.mapq
        v.mapQMax = max(v.mapQMax, rec.mapq)
        bq = _calc_baseq(v, b0, b1, quals, readlen)
        v.baseQSum += bq
        v.baseQMax = max(v.baseQMax, bq)
        ed = min(b0, readlen - b1)
        v.endDistSum += ed
        v.endDistMax = max(v.endDistMax, ed)
        v.idSum += iid
        v.idMax = max(v.idMax, iid)
    return [v for v, _b0, _b1 in out]


def _calc_baseq(v, bstart, bstop, quals, readlen):
    """Var.calcBaseQ (swapped orientation assumed — SAM is ref-oriented)."""
    if quals is None or len(quals) == 0:
        return 30
    if v.type == DEL:
        if bstart == 0:
            return int(quals[0])
        if bstop >= readlen - 1:
            return int(quals[readlen - 1])
        return (int(quals[bstart]) + int(quals[min(bstop + 1, readlen - 1)])) // 2
    s = quals[bstart:bstop]
    return int(np.sum(s)) // max(len(s), 1)


PLATFORMS = {"illumina": 0, "pacbio": 1, "nanopore": 2, "roche": 3}


def choose_net(platform: int, ploidy: int) -> str:
    """NNChooser.choose analog over the bundled nets."""
    import os

    # the JAX package's bundled nets, read by path, not copied
    here = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "bbtools_tpu", "resources")
    if platform == 1:
        name = "callvars_pacbio.bbnet"
    elif ploidy > 2:
        name = "callvars_illumina_polyploid.bbnet"
    else:
        name = "callvars_illumina_hap_dip.bbnet"
    return os.path.join(here, name)


def parse_vcf_var(chrom_idx: int, pos: int, ref_al: bytes, alt_al: bytes,
                  info: bytes = b"") -> Var:
    """One VCF row -> Var, inverting write_vcf's encoding (and the
    reference's Var(VCFLine) constructor, var2/Var.java:219-258): a
    shared leading base marks an indel; TYP= in INFO overrides when
    present (round-trips our own output exactly)."""
    typ = None
    for fld in info.split(b";"):
        if fld.startswith(b"TYP="):
            name = fld[4:].decode()
            typ = {n: i for i, n in enumerate(TYPE_NAMES)}.get(name)
    if len(ref_al) == len(alt_al) == 1:
        t = SUB if typ is None else typ
        return Var(chrom_idx, pos - 1, pos, alt_al, t, forced=True)
    if len(alt_al) > len(ref_al) and len(ref_al) == 1:
        return Var(chrom_idx, pos, pos, alt_al[1:],
                   INS if typ is None else typ, forced=True)
    if len(ref_al) > len(alt_al) and len(alt_al) == 1:
        return Var(chrom_idx, pos, pos + len(ref_al) - 1, b"",
                   DEL if typ is None else typ, forced=True)
    # complex rows: treat as substitution block over the ref span
    return Var(chrom_idx, pos - 1, pos - 1 + len(ref_al), alt_al,
               SUB if typ is None else typ, forced=True)


def load_forced_vcf(paths: str, cv: "CallVariants") -> int:
    """AnalyzeVars.loadForcedVCF (var2/AnalyzeVars.java:287-305): load
    VCF rows as evidence-cleared forced Vars into the varmap BEFORE SAM
    processing, so observed evidence merges into them and they always
    emit. Comma-separated multi-file input as in the reference."""
    from ..io.readwrite import open_input

    n = 0
    for path in paths.split(","):
        path = path.strip()
        if not path:
            continue
        with open_input(path) as fh:
            for line in fh:
                if line.startswith(b"#"):
                    continue
                f = line.rstrip(b"\n").split(b"\t")
                if len(f) < 5:
                    continue
                idx = cv.name_to_idx.get(f[0])
                if idx is None:
                    idx = cv.name_to_idx.get(f[0].decode())
                if idx is None:
                    continue
                for alt in f[4].split(b","):
                    v = parse_vcf_var(
                        idx, int(f[1]), f[3].upper(), alt.upper(),
                        f[7] if len(f) > 7 else b"",
                    )
                    if v.key() not in cv.varmap:
                        cv.varmap[v.key()] = v
                    else:
                        cv.varmap[v.key()].forced = True
                    n += 1
    return n


class CallVariants:
    def __init__(self, ref: Reference, vfilter: VarFilter | None = None,
                 ploidy: int = 1, nn: bool = False,
                 net_file: str | None = None, platform: int = 0,
                 call_junctions: bool = False, device="cuda"):
        self.ref = ref
        self.device = resolve_device(device)
        self.call_junctions = call_junctions
        self.filter = vfilter or VarFilter()
        self.ploidy = ploidy
        self.net = None
        self.platform = platform
        if nn:
            from ..ml.cellnet import parse_bbnet

            self.net = parse_bbnet(net_file or choose_net(platform, ploidy))
            self.net.device = self.device
            self.net_cutoff = self.net.cutoff
        self.varmap: dict = {}
        self.coverage = [
            np.zeros(int(length), dtype=np.int32) for length in ref.lengths
        ]
        self.name_to_idx = {n.split()[0]: i for i, n in enumerate(ref.names)}
        self.reads = 0
        self.paired = 0
        self.proper = 0
        self.qual_sum = 0
        self.qual_n = 0
        self.mapq_sum = 0
        self.len_sum = 0
        self.realigned = 0

    REALIGN_PAD = 200  # var2/Realigner.java:208 defaultPadding

    def add_sam(self, path: str, realign: bool = False):
        pending = []
        for rec in iter_sam(path):
            if not rec.mapped or rec.secondary:
                continue
            scafnum = self.name_to_idx.get(rec.rname)
            if scafnum is None:
                continue
            self.reads += 1
            quals = (
                np.frombuffer(rec.qual, dtype=np.uint8).astype(np.int32) - 33
                if rec.qual != b"*"
                else None
            )
            ref_codes = self.ref.scaffold_codes(scafnum)
            match = cigar_to_match(rec, ref_codes)
            if realign and self._should_realign(match):
                pending.append((rec, match, scafnum, quals))
                if len(pending) >= 128:
                    self._realign_flush(pending)
                    pending = []
                continue
            self._tally(rec, match, scafnum, quals, rec.pos)
        if pending:
            self._realign_flush(pending)
        return self

    # ---- realignment (var2/Realigner.java :36-160) ----
    @staticmethod
    def _should_realign(match: bytes) -> bool:
        """Realigner gate (:80-88): clips, or many mismatches, or a
        complex indel pattern."""
        mS = match.count(b"S")
        mC = match.count(b"C")
        runs_i = match.count(b"Im") + match.endswith(b"I")
        runs_d = match.count(b"Dm") + match.endswith(b"D")
        sum_indel = runs_i + runs_d
        sum_bad = mS + sum_indel
        if mC > 0:
            pass
        elif sum_bad > 3:
            pass
        elif sum_indel > 1 or (sum_indel > 0 and mS > 1):
            pass
        else:
            return False
        if mS < 3 and mC == 0 and runs_i < 2 and runs_d < 2 and sum_bad < 3                 and sum_indel < 2:
            return False
        return True

    def _realign_flush(self, pending):
        """MSA the pending reads against padded windows; keep the new
        alignment when it has fewer bad symbols (score-improvement
        acceptance, :140-155)."""
        from ..core.dna import BASE_TO_CODE
        from ..ops.msa import realign_batch

        pad = self.REALIGN_PAD
        R = max(len(rec.seq) for rec, _, _, _ in pending)
        starts = []
        wins = []
        wlens = []
        reads = np.full((len(pending), R), 4, dtype=np.uint8)
        rlens = np.zeros(len(pending), dtype=np.int32)
        W = 0
        metas = []
        for t, (rec, match, scafnum, quals) in enumerate(pending):
            codes = BASE_TO_CODE[np.frombuffer(rec.seq, np.uint8)]
            reads[t, : len(codes)] = codes
            rlens[t] = len(codes)
            ref_codes = self.ref.scaffold_codes(scafnum)
            rlen_ref = sum(
                1 for m in match if m in b"mSND"
            )
            a = max(0, rec.pos - 1 - pad)
            bnd = min(len(ref_codes), rec.pos - 1 + rlen_ref + pad)
            wins.append(ref_codes[a:bnd])
            starts.append(a)
            wlens.append(bnd - a)
            W = max(W, bnd - a)
            metas.append((rec, match, scafnum, quals))
        winarr = np.full((len(pending), W), 4, dtype=np.uint8)
        for t, wv in enumerate(wins):
            winarr[t, : len(wv)] = wv
        matches2, start_cols, _sc = realign_batch(
            reads, rlens, winarr, np.asarray(wlens, np.int32), self.device
        )

        def badness(m):
            return (
                m.count(b"S") + m.count(b"C")
                + 2 * (m.count(b"I") + m.count(b"D"))
            )

        for t, (rec, match, scafnum, quals) in enumerate(metas):
            m2 = matches2[t]
            if m2 and badness(m2) < badness(match):
                new_pos = starts[t] + int(start_cols[t]) + 1
                self.realigned += 1
                self._tally(rec, m2, scafnum, quals, new_pos)
            else:
                self._tally(rec, match, scafnum, quals, rec.pos)

    def _tally(self, rec, match, scafnum, quals, pos):
        import dataclasses

        if pos != rec.pos:
            rec = dataclasses.replace(rec, pos=pos)
        rlen_ref = sum(1 for m in match if m in b"mSND")
        a = rec.pos - 1
        b = min(a + rlen_ref, len(self.coverage[scafnum]))
        self.coverage[scafnum][max(a, 0) : b] += 1
        if rec.flag & 0x1:
            self.paired += 1
            if rec.proper_pair:
                self.proper += 1
        if quals is not None:
            self.qual_sum += int(quals.sum())
            self.qual_n += len(quals)
        self.mapq_sum += rec.mapq
        self.len_sum += len(rec.seq)
        vs = extract_vars(rec, match, scafnum, quals)
        if self.call_junctions:
            vs += extract_junctions(rec, match, scafnum, quals)
        for v in vs:
            cur = self.varmap.get(v.key())
            if cur is None:
                self.varmap[v.key()] = v
            else:
                cur.merge(v)

    def finish(self):
        for v in self.varmap.values():
            ca = self.coverage[v.scafnum]
            if v.type in (SUB, DEL, NOCALL, LJUNCT, RJUNCT):
                span = ca[v.start : max(v.stop, v.start + 1)]
                v.coverage = int(round(float(span.sum()) / max(v.reflen(), 1)))
            else:  # INS
                a = min(v.start, len(ca) - 1)
                b = min(v.stop, len(ca) - 1)
                v.coverage = int(math.ceil((int(ca[a]) + int(ca[b])) / 2))
        self.pairing_rate = self.proper / max(self.paired, 1)
        self.total_quality_avg = self.qual_sum / max(self.qual_n, 1)
        self.total_mapq_avg = self.mapq_sum / max(self.reads, 1)
        self.read_length_avg = self.len_sum / max(self.reads, 1)
        return self

    def sample_column(self, key):
        """GT:DP:AD:AF column text for one var key ('.' when absent)."""
        v = self.varmap.get(key)
        if v is None:
            return b"0:.:0:0.0000"
        count = v.allele_count()
        gt = b"1" if v.allele_fraction() > 0.5 else b"0/1"
        return b"%s:%d:%d:%.4f" % (
            gt, max(v.coverage, count), count, v.allele_fraction()
        )

    def write_vcf(self, path: str, samples=None):
        """Single-sample VCF, or — with `samples` = [(name, CallVariants),
        ...] — a multisample VCF whose variant set is the union over
        samples and whose FORMAT columns are per-sample
        (CallVariants.java multisample mode; this instance provides the
        pooled INFO stats)."""
        f = self.filter
        args = (
            self.pairing_rate,
            self.total_quality_avg,
            self.total_mapq_avg,
            self.read_length_avg,
            f.rarity,
            self.ploidy,
            self.ref,
        )
        n_pass = 0
        with open_output(path) as fh:
            fh.write(b"##fileformat=VCFv4.2\n")
            fh.write(b"##source=bbtools_torch.callvariants\n")
            for i, name in enumerate(self.ref.names):
                fh.write(
                    b"##contig=<ID=%s,length=%d>\n"
                    % (name.split()[0], int(self.ref.lengths[i]))
                )
            if samples:
                header_cols = b"\t".join(
                    nm.encode() if isinstance(nm, str) else nm
                    for nm, _ in samples
                )
                fh.write(
                    b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
                    b"\tFORMAT\t" + header_cols + b"\n"
                )
            else:
                fh.write(
                    b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
                    b"\tFORMAT\tSAMPLE\n"
                )
            svars = [self.varmap[key] for key in sorted(self.varmap)]
            nearby = count_nearby_vars(svars)
            nn_scores = None
            if self.net is not None and svars:
                feats = np.stack(
                    [
                        make_ump45_vector(
                            v, self.pairing_rate, self.total_quality_avg,
                            self.total_mapq_avg, self.read_length_avg,
                            self.ploidy, self.ref, nearby[i], self.platform,
                        )
                        for i, v in enumerate(svars)
                    ]
                )
                raw = np.maximum(self.net.apply(feats).reshape(-1), 0)
                nn_scores = [
                    scale_net_score(float(x), self.net_cutoff) for x in raw
                ]
            for vi, v in enumerate(svars):
                # QUAL = composite phred, or the cutoff-scaled NN score
                # when a net is loaded (Var.java:1040)
                phred = (
                    nn_scores[vi] if nn_scores is not None
                    else v.phred_score(*args)
                )
                if nn_scores is not None and f.min_score > 0:
                    # with a net, the score gate uses the scaled NN score
                    # INSTEAD of the composite (VarFilter.passesFilter
                    # net path); other filter tiers still apply
                    ms = f.min_score
                    f.min_score = 0
                    try:
                        passes = f.passes(
                            v, self.pairing_rate, self.total_quality_avg,
                            self.total_mapq_avg, self.read_length_avg,
                            self.ploidy, self.ref,
                        ) and phred >= ms
                    finally:
                        f.min_score = ms
                else:
                    passes = f.passes(
                        v, self.pairing_rate, self.total_quality_avg,
                        self.total_mapq_avg, self.read_length_avg,
                        self.ploidy, self.ref,
                    )
                # forced vars always pass (VarMap.java:140)
                passes = passes or v.forced
                scaf_codes = self.ref.scaffold_codes(v.scafnum)
                name = self.ref.names[v.scafnum].split()[0]
                indel = v.type in (INS, DEL)
                vcf_pos = v.start + (0 if indel else 1)
                prev = CODE_TO_BASE[
                    min(scaf_codes[min(max(v.start - 1, 0), len(scaf_codes) - 1)], 4)
                ]
                ref_al = b""
                if v.reflen() == 0 or len(v.allele) < 1:
                    ref_al += bytes([prev])
                ref_al += bytes(
                    CODE_TO_BASE[np.minimum(scaf_codes[v.start : v.stop], 4)]
                )
                alt_al = b""
                if v.reflen() == 0 or len(v.allele) < 1:
                    alt_al += bytes([prev])
                alt_al += v.allele
                count = v.allele_count()
                info = (
                    b"SN=%d;STA=%d;STO=%d;TYP=%s;R1P=%d;R1M=%d;R2P=%d;R2M=%d;"
                    b"AD=%d;DP=%d;PPC=%d;AF=%.4f;MQS=%d;MQM=%d;BQS=%d;BQM=%d;"
                    b"EDS=%d;EDM=%d;IDS=%d;IDM=%d;SB=%.4f;SCR=%.2f"
                    % (
                        v.scafnum, v.start, v.stop,
                        TYPE_NAMES[v.type].encode(),
                        v.r1plus, v.r1minus, v.r2plus, v.r2minus,
                        count, max(v.coverage, count), v.properPairCount,
                        v.allele_fraction(),
                        v.mapQSum, v.mapQMax, v.baseQSum, v.baseQMax,
                        v.endDistSum, v.endDistMax, v.idSum, v.idMax,
                        v.strand_bias_score(v.contig_end_dist(self.ref)),
                        phred,
                    )
                )
                if samples:
                    sample = b"\t".join(
                        cv.sample_column(v.key()) for _, cv in samples
                    )
                else:
                    sample = self.sample_column(v.key())
                fh.write(
                    b"%s\t%d\t.\t%s\t%s\t%.2f\t%s\t%s\tGT:DP:AD:AF\t%s\n"
                    % (
                        name, vcf_pos, ref_al, alt_al, phred,
                        b"PASS" if passes else b"FAIL", info, sample,
                    )
                )
                n_pass += 1 if passes else 0
        return n_pass


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    sam = a.get("in", "in1")
    ref_path = a.get("ref")
    out = a.get("vcf", "out")
    ploidy = a.get_int("ploidy", default=1)
    device = resolve_device(a.get("device"))
    t0 = time.time()
    ref = load_reference(ref_path)
    f = VarFilter()
    f.rarity = a.get_float("rarity", default=1.0)
    f.min_allele_fraction = a.get_float("minallelefraction", "maf", default=0.1)
    f.min_score = a.get_float("minscore", default=20.0)
    f.min_allele_depth = a.get_int("minreads", "minad", default=2)
    realign = a.get_bool("realign", default=False)
    nn = a.get_bool("nn", "usenet", "usenn", "useann", default=False)
    junctions = a.get_bool("junctions", "calljunctions", default=False)
    net_file = a.get("net", "netfile")
    platform = PLATFORMS.get(
        (a.get("platform") or "illumina").lower(), 0
    )
    multi = a.get_bool("multisample", "multi", default=False)
    invcf = a.get("invcf", "vcfin", "forced")
    sams = [p.strip() for p in (sam or "").split(",") if p.strip()]
    if multi and len(sams) > 1:
        # pooled instance drives the union + INFO; per-sample instances
        # provide the FORMAT columns (CallVariants multisample mode)
        import os

        cv = CallVariants(ref, f, ploidy=ploidy, nn=nn, net_file=net_file,
                          platform=platform, device=device)
        if invcf:
            n_forced = load_forced_vcf(invcf, cv)
            print(f"Forced variants:     \t{n_forced}", file=sys.stderr)
        per = []
        for p in sams:
            cvs = CallVariants(ref, f, ploidy=ploidy, device=device)
            cvs.add_sam(p, realign=realign).finish()
            per.append((os.path.basename(p).split(".")[0], cvs))
            cv.add_sam(p, realign=realign)
        cv.finish()
        n_pass = cv.write_vcf(out, samples=per) if out else 0
    else:
        cv = CallVariants(ref, f, ploidy=ploidy, nn=nn, net_file=net_file,
                          platform=platform, call_junctions=junctions,
                          device=device)
        if invcf:
            n_forced = load_forced_vcf(invcf, cv)
            print(f"Forced variants:     \t{n_forced}", file=sys.stderr)
        for p in sams:
            cv.add_sam(p, realign=realign)
        cv.finish()
        n_pass = cv.write_vcf(out) if out else 0
    print(f"Reads:               \t{cv.reads}", file=sys.stderr)
    if cv.realigned:
        print(f"Realigned:           \t{cv.realigned}", file=sys.stderr)
    print(f"Variants found:      \t{len(cv.varmap)}", file=sys.stderr)
    print(f"Passing:             \t{n_pass}", file=sys.stderr)
    print(f"Time:                \t{time.time() - t0:.3f} seconds.", file=sys.stderr)
    return cv


if __name__ == "__main__":
    main()
