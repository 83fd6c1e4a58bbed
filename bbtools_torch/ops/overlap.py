"""BBMerge overlap detection: batched counts on the device, exact decision
in float32 reference order.

The PyTorch port of bbtools_tpu/ops/overlap.py, a re-implementation of
jgi/BBMergeOverlapper.java: mateByOverlapRatioJava (:368-505) and its
quality variant (:158-397), findBestRatio (:560-612), expectedMismatches
(:1139-1176), probability (:1186-1230), calcMinOverlapByEntropyHead/Tail
(:1303-1400) and the probCorrect tables (:1484).

The early exits of the reference's per-insert loops never change its
result, so the per-insert counts are computed for all inserts at once
(ops/overlap_scan.py, kernel csrc/overlap_scan.cu on the GPU) and the
sequential best/second/ambiguity state machine runs over the insert axis,
vectorized across reads. This module follows the JAX package's device
path (`overlap_and_mate`): the [B, D] count planes stay on the tensors'
device and only the [B] winners are returned. The constant-table reads
(increment tables, probCorrect4) go through ops/lane_table.py (kernel
csrc/lane_table.cu on the GPU).

Float parity: every f32 result is the reference's to the bit. The
quality scan, the mate selection and the efilter/pfilter sums are plain
torch loops over positions or inserts, one elementwise op per step in
the reference's order: no reduction over the accumulation axis (torch
would reorder it), and no fused multiply-add (eager torch runs each op
as its own kernel, rounding every result to f32). Constants are rounded
to f32 on the host first, so a Python scalar operand carries the f32
value. Unlike XLA, torch keeps f32 subnormals, so `probability_torch`
equals the host oracle `probability_np` everywhere.

The host functions (`*_np`, the tables) are copies of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .lane_table import lookup as table_lookup, pack_table
from .overlap_scan import overlap_counts

MAX_READ = 1024

#: BBMergeOverlapper.probCorrect4 (:1484), copied verbatim
PROB_CORRECT4 = np.array(
    [0.0000, 0.2501, 0.3690, 0.4988, 0.6019, 0.6838, 0.7488, 0.8005, 0.8415,
     0.8741, 0.9000, 0.9206, 0.9369, 0.9499, 0.9602, 0.9684, 0.9749, 0.9800,
     0.9842, 0.9874, 0.9900, 0.9921, 0.9937, 0.9950, 0.9960, 0.9968, 0.9975,
     0.9980, 0.9984, 0.9987, 0.9990, 0.9992, 0.9994, 0.9995, 0.9996, 0.9997,
     0.9997, 0.9998, 0.9998, 0.9999] + [0.9999] * 20,
    dtype=np.float32,
)


#: BBMergeOverlapper.probCorrect3 (the quality-mode table, used by
#: mateByOverlapRatioJava_WithQualities :173-174), copied verbatim
PROB_CORRECT3 = np.array(
    [0.000, 0.251, 0.369, 0.499, 0.602, 0.684, 0.749, 0.800, 0.842, 0.874,
     0.900, 0.921, 0.937, 0.950, 0.960, 0.968, 0.975, 0.980, 0.984, 0.987,
     0.990, 0.992, 0.994, 0.995, 0.996, 0.997, 0.997, 0.998, 0.998, 0.999,
     0.999, 0.999, 0.999, 0.999] + [1.0] * 36,
    dtype=np.float32,
)


def _incr_table(incr: float, n: int) -> np.ndarray:
    """t[c] = float32 result of adding `incr` c times sequentially."""
    t = np.zeros(n + 1, dtype=np.float32)
    for i in range(1, n + 1):
        t[i] = np.float32(t[i - 1] + np.float32(incr))
    return t

_INCR_CACHE: dict[tuple[float, int], np.ndarray] = {}


def incr_table(incr: float, n: int = MAX_READ) -> np.ndarray:
    key = (incr, n)
    if key not in _INCR_CACHE:
        _INCR_CACHE[key] = _incr_table(incr, n)
    return _INCR_CACHE[key]

def right_justify_np(b_rc: np.ndarray, blens: np.ndarray, L: int) -> np.ndarray:
    """Host-side right-justification: b_rj[:, L-1-t] = b_rc[:, blen-1-t]
    (identical to the device formulation in overlap_counts_jnp). Done on
    the host so the TPU path never pays a per-element device gather."""
    b_rc = np.asarray(b_rc)
    blens = np.asarray(blens)
    if b_rc.shape[1] == L and (blens == L).all():
        return b_rc  # uniform full-length reads: already justified
    i_idx = np.arange(L, dtype=np.int32)[None, :]
    src = i_idx - (L - blens[:, None]).astype(np.int32)
    return np.take_along_axis(b_rc, np.clip(src, 0, L - 1), axis=1)

def right_justify_torch(b_rc, blens, L: int):
    """right_justify_np on the tensors' device: b_rj[:, L-1-t] =
    b_rc[:, blen-1-t], leading columns replicating column 0."""
    i_idx = torch.arange(L, dtype=torch.int64, device=b_rc.device)[None, :]
    src = (i_idx - (L - blens.to(torch.int64)[:, None])).clamp(0, L - 1)
    return torch.gather(b_rc, 1, src)


def overlap_counts_quality_np(
    a, b_rc, aq, bq_rev, alens, blens, min_insert0: int, n_inserts: int
):
    """Per-insert quality-weighted overlap sums, host oracle.

    Reference: mateByOverlapRatioJava_WithQualities inner loop
    (jgi/BBMergeOverlapper.java:229-242): x = aprob[i]*bprob[j];
    match -> good += x, mismatch -> bad += x (and badInt++), all in
    float32, i ascending. N==N counts as a (zero-weight) match; N vs
    base is a mismatch whose x carries the actual quals.

    Returns (good f32 [B,D], bad f32 [B,D], bad_int i32 [B,D],
    olen i32 [B,D]). Bit-exact f32: the i-ascending accumulation order
    is preserved by looping over i and adding a masked (0.0) term per
    step — adding +0.0f is an exact identity, so skipped positions
    change nothing.
    """
    f32 = np.float32
    a = np.asarray(a)
    b_rc = np.asarray(b_rc)
    alens = np.asarray(alens).astype(np.int64)
    blens = np.asarray(blens).astype(np.int64)
    B, L = a.shape
    aprob = PROB_CORRECT3[np.clip(np.asarray(aq), 0, 69)]
    bprob = PROB_CORRECT3[np.clip(np.asarray(bq_rev), 0, 69)]
    b_rj = right_justify_np(b_rc, blens, L)
    bprob_rj = right_justify_np(bprob, blens, L)
    max_ins = min_insert0 + n_inserts - 1
    P = max(max_ins - L, 0) + 1
    R = max(L - min_insert0, 0) + 1
    b_pad = np.pad(b_rj, ((0, 0), (P, R)), constant_values=9)
    p_pad = np.pad(bprob_rj, ((0, 0), (P, R)))
    ins = (min_insert0 + np.arange(n_inserts, dtype=np.int64))[None, :]
    good = np.zeros((B, n_inserts), np.float32)
    bad = np.zeros((B, n_inserts), np.float32)
    bad_int = np.zeros((B, n_inserts), np.int32)
    olen = np.zeros((B, n_inserts), np.int32)
    rows = np.arange(B)[:, None]
    for i in range(L):
        # mate column for insert `ins` at read position i (see
        # overlap_counts_jnp docstring): b_pad[P + L - ins + i]
        cols = P + L - ins + i
        cb = b_pad[rows, cols]  # [B, D]
        pb = p_pad[rows, cols]
        valid = (i < np.minimum(alens[:, None], ins)) & (
            i >= np.maximum(ins - blens[:, None], 0)
        )
        ca = a[:, i : i + 1]
        x = np.where(valid, aprob[:, i : i + 1] * pb, f32(0.0)).astype(
            np.float32
        )
        eq = ca == cb
        good = (good + np.where(eq, x, f32(0.0))).astype(np.float32)
        bad = (bad + np.where(eq, f32(0.0), x)).astype(np.float32)
        bad_int += (valid & ~eq).astype(np.int32)
        olen += valid.astype(np.int32)
    return good, bad, bad_int, olen

def overlap_counts_quality_torch(a, b_rc, aq, bq_rev, alens, blens,
                                 min_insert0: int, n_inserts: int):
    """overlap_counts_quality_np on the tensors' device (the JAX
    package's `_overlap_counts_quality`): a loop over read positions i
    with [B, D] f32 sums keeps the reference's i-ascending accumulation
    order; columns are inserts, as in the np version. Returns (good f32,
    bad f32, bad_int i32, olen i32), each [B, n_inserts]."""
    f32 = torch.float32
    B, L = a.shape
    dev = a.device
    m0, ni = min_insert0, n_inserts
    pc3 = torch.from_numpy(PROB_CORRECT3).to(dev)
    aprob = pc3[aq.to(torch.int64).clamp(0, 69)]
    bprob = pc3[bq_rev.to(torch.int64).clamp(0, 69)]
    b_rj = right_justify_torch(b_rc.to(torch.int32), blens, L)
    bprob_rj = right_justify_torch(bprob, blens, L)
    max_ins = m0 + ni - 1
    P = max(max_ins - L, 0) + 1
    R = max(L - m0, 0) + 1
    b_pad = F.pad(b_rj, (P, R), value=9)
    p_pad = F.pad(bprob_rj, (P, R))
    ins = (m0 + torch.arange(ni, dtype=torch.int64, device=dev))[None, :]
    lo = (ins - blens.to(torch.int64)[:, None]).clamp(min=0)
    hi = torch.minimum(alens.to(torch.int64)[:, None], ins)
    a32 = a.to(torch.int32)
    good = torch.zeros((B, ni), dtype=f32, device=dev)
    bad = torch.zeros((B, ni), dtype=f32, device=dev)
    bad_int = torch.zeros((B, ni), dtype=torch.int32, device=dev)
    olen = torch.zeros((B, ni), dtype=torch.int32, device=dev)
    # positions at or past the longest read add exact zeros: skip them
    for i in range(min(L, int(alens.max())) if B else 0):
        # mate column of insert `ins` at read position i is P + L - ins + i:
        # for all inserts, one reversed slice
        s = P + L - max_ins + i
        seg = b_pad[:, s : s + ni].flip(1)
        pseg = p_pad[:, s : s + ni].flip(1)
        valid = (i < hi) & (i >= lo)
        x = torch.where(valid, aprob[:, i : i + 1] * pseg, 0.0)
        eq = a32[:, i : i + 1] == seg
        good = good + torch.where(eq, x, 0.0)
        bad = bad + torch.where(eq, 0.0, x)
        bad_int = bad_int + (valid & ~eq).to(torch.int32)
        olen = olen + valid.to(torch.int32)
    return good, bad, bad_int, olen


def find_best_ratio_np(
    good_c, bad_c, olen, alens, blens, min_insert0: int,
    min_overlap0, min_overlap, min_insert: int, max_ratio: float,
    offset: float, g_incr: float = 0.95, b_incr: float = 0.95,
    good_f=None, bad_f=None,
):
    """findBestRatio (non-quality) vectorized over reads.

    good_c/bad_c/olen: [B, D] int counts (column d -> insert min_insert0+d).
    min_overlap0/min_overlap may be per-read arrays. Returns float32 [B].

    With good_f/bad_f given ([B, D] float32 quality-weighted sums from
    overlap_counts_quality_np), this is findBestRatio_WithQualities
    (jgi/BBMergeOverlapper.java:642-693): g/b come from the planes and
    the bad==0 test is on the float32 sum (a mismatch pair with q=0
    weight keeps bad at exactly 0.0f, as in the reference).
    """
    f32 = np.float32
    B, D = good_c.shape
    gt = incr_table(g_incr)
    bt = incr_table(b_incr)
    best = np.full(B, f32(f32(max_ratio) + f32(0.0001)), dtype=np.float32)
    halfmax = f32(f32(max_ratio) * f32(0.5))
    returned = np.zeros(B, dtype=bool)
    result = np.zeros(B, dtype=np.float32)
    mo0 = np.broadcast_to(np.asarray(min_overlap0), (B,))
    mo = np.broadcast_to(np.asarray(min_overlap), (B,))
    largest = alens + blens - mo  # per-read loop start
    for insert in range(int(largest.max(initial=0)), min_insert - 1, -1):
        d = insert - min_insert0
        if d < 0 or d >= D:
            continue
        inrange = (insert <= largest) & ~returned
        if not inrange.any():
            continue
        if good_f is not None:
            g = good_f[:, d]
            b = bad_f[:, d]
            bad_zero = bad_f[:, d] == np.float32(0.0)
        else:
            g = gt[good_c[:, d]]
            b = bt[bad_c[:, d]]
            bad_zero = bad_c[:, d] == 0
        ol = olen[:, d].astype(np.float32)
        badlimit = best * ol  # f32*f32, extraBadlimit=0
        ok = inrange & (b <= badlimit)
        # bad==0 && good in (minOverlap0, minOverlap) -> return 100
        ret100 = ok & bad_zero & (g > mo0) & (g < mo)
        result[ret100] = f32(100.0)
        returned |= ret100
        ok &= ~ret100
        ratio = np.where(ol > 0, (b + f32(offset)) / np.maximum(ol, 1), f32(1))
        ratio = ratio.astype(np.float32)
        improve = ok & (ratio < best)
        best = np.where(improve, ratio, best)
        early = improve & (g >= mo) & (ratio < halfmax)
        result[early] = best[early]
        returned |= early
    result[~returned] = best[~returned]
    return result

def mate_by_overlap_ratio_np(
    good_c, bad_c, olen, alens, blens, min_insert0_col: int,
    min_overlap0, min_overlap, min_insert0: int, min_insert: int,
    max_ratio: float, min_second_ratio: float, margin: float,
    offset: float, g_incr: float = 0.95, b_incr: float = 0.95,
    extra_mult: float = 1.2, collect: bool = False,
    good_f=None, bad_f=None,
):
    """mateByOverlapRatioJava (:368-505) vectorized over reads.

    With good_f/bad_f given, this is mateByOverlapRatioJava_WithQualities
    (:158-397): g/b are the float32 prob-weighted sums, bad_c holds the
    integer mismatch count (badInt), and the zero-bad early return tests
    the float sum. Everything else (badlimit, margins, best/second state
    machine, early returns) is shared between the two reference methods
    line for line.

    Returns (best_insert [B] i32 with -1 for no solution, best_bad_int [B],
    ambig [B] bool). min_overlap0/min_overlap may be per-read arrays.

    `extra_mult` is the badlimit multiplier (1.2 normally; 4.0 in the
    reference's MAKE_VECTOR mode, BBMergeOverlapper.java:456). With
    `collect=True` a 4th return value carries the best/second-best
    candidate stats dict the BBMerge NN gate feeds from
    (BBMergeOverlapper.java:552-575 vector block).
    """
    f32 = np.float32
    B, D = good_c.shape
    mo0 = np.broadcast_to(np.asarray(min_overlap0), (B,)).astype(np.int64)
    mo = np.broadcast_to(np.asarray(min_overlap), (B,)).astype(np.int64)
    # minOverlap=max(4, minOverlap0, minOverlap); minOverlap0=mid(4, ...)
    mo_eff = np.maximum(4, np.maximum(mo0, mo))
    mo0_eff = np.sort(np.stack([np.full(B, 4), mo0, mo_eff]), axis=0)[1]
    min_len = np.minimum(alens, blens)
    # prescan
    x = find_best_ratio_np(
        good_c, bad_c, olen, alens, blens, min_insert0_col,
        mo0_eff, mo_eff, min_insert, max_ratio, offset, g_incr, b_incr,
        good_f=good_f, bad_f=bad_f,
    )
    no_sol = x > f32(max_ratio)
    maxr = np.minimum(f32(max_ratio), x).astype(np.float32)

    gt = incr_table(g_incr)
    bt = incr_table(b_incr)
    margin2 = ((f32(margin) + f32(offset)) / min_len.astype(np.float32)).astype(
        np.float32
    )
    best_insert = np.full(B, -1, np.int64)
    best_bad_int = np.full(B, -1, np.int64)
    best_ratio = np.ones(B, np.float32)
    second_ratio = np.ones(B, np.float32)
    ambig = np.zeros(B, dtype=bool)
    returned = no_sol.copy()  # early-outs freeze state
    ret_ambig = np.zeros(B, dtype=bool)
    extra_mult = f32(extra_mult)
    # collector state (Java inits, BBMergeOverlapper.java:441-453)
    best_overlap = np.full(B, -1, np.int64)
    best_bad_f = min_len.astype(np.float32)
    second_insert = np.zeros(B, np.int64)
    second_overlap = np.zeros(B, np.int64)
    second_bad_f = np.zeros(B, np.float32)
    second_bad_int = np.full(B, -1, np.int64)
    largest = alens + blens - mo0_eff
    for insert in range(int(largest.max(initial=0)), min_insert0 - 1, -1):
        d = insert - min_insert0_col
        if d < 0 or d >= D:
            continue
        inrange = (insert <= largest) & ~returned
        if not inrange.any():
            continue
        if good_f is not None:
            g = good_f[:, d]
            b = bad_f[:, d]
            bad_zero = bad_f[:, d] == f32(0.0)
        else:
            g = gt[good_c[:, d]]
            b = bt[bad_c[:, d]]
            bad_zero = bad_c[:, d] == 0
        ol = olen[:, d].astype(np.float32)
        badlimit = (
            extra_mult * (np.minimum(best_ratio, maxr) * f32(margin) * ol)
            + f32(1.0)
        ).astype(np.float32)
        ok = inrange & (b <= badlimit)
        # ambiguous early return: bad==0, minOverlap0 < good < minOverlap
        retA = ok & bad_zero & (g > mo0_eff) & (g < mo_eff)
        ret_ambig |= retA
        returned |= retA
        ok &= ~retA
        ratio = np.where(ol > 0, (b + f32(offset)) / np.maximum(ol, 1), f32(1))
        ratio = ratio.astype(np.float32)
        cand = ok & (ratio < best_ratio * f32(margin))
        new_ambig = (ratio * f32(margin) >= best_ratio) | (g < mo_eff)
        ambig = np.where(cand, new_ambig, ambig)
        improve = cand & (ratio < best_ratio)
        second = cand & ~improve & (ratio < second_ratio)
        # shift best -> second on improve
        second_ratio = np.where(improve, best_ratio, second_ratio)
        second_insert = np.where(improve, best_insert, second_insert)
        second_overlap = np.where(improve, best_overlap, second_overlap)
        second_bad_f = np.where(improve, best_bad_f, second_bad_f)
        second_bad_int = np.where(improve, best_bad_int, second_bad_int)
        best_insert = np.where(improve, insert, best_insert)
        best_bad_int = np.where(improve, bad_c[:, d], best_bad_int)
        best_ratio = np.where(improve, ratio, best_ratio)
        best_overlap = np.where(improve, olen[:, d], best_overlap)
        best_bad_f = np.where(improve, b, best_bad_f)
        second_ratio = np.where(second, ratio, second_ratio)
        second_insert = np.where(second, insert, second_insert)
        second_overlap = np.where(second, olen[:, d], second_overlap)
        second_bad_f = np.where(second, b, second_bad_f)
        second_bad_int = np.where(second, bad_c[:, d], second_bad_int)
        retB = cand & (
            (ambig & (best_ratio < margin2)) | (second_ratio < f32(min_second_ratio))
        )
        ret_ambig |= retB
        returned |= retB
    normal = ~returned
    ambig = np.where(normal, ambig | (second_ratio < f32(min_second_ratio)), ambig)
    # normal end: if !ambig && bestRatio>maxRatio -> no solution (:614)
    best_insert = np.where(
        normal & ~ambig & (best_ratio > maxr), -1, best_insert
    )
    out_insert = np.where(no_sol | ret_ambig, -1, best_insert)
    out_bad = np.where(no_sol, min_len, best_bad_int)
    # caller semantics (BBMerge findOverlap :1528): ambig counts only when
    # an insert was returned; early-ambig returns -1 with the flag set
    out_ambig = np.where(
        no_sol, False, np.where(ret_ambig, False, ambig & (out_insert > -1))
    )
    if collect:
        stats = {
            "best_insert": best_insert, "best_overlap": best_overlap,
            "best_bad": best_bad_f, "best_ratio": best_ratio,
            "best_bad_int": best_bad_int,
            "second_insert": second_insert, "second_overlap": second_overlap,
            "second_bad": second_bad_f, "second_ratio": second_ratio,
            "second_bad_int": second_bad_int,
        }
        return (
            out_insert.astype(np.int64), out_bad.astype(np.int64), out_ambig,
            stats,
        )
    return out_insert.astype(np.int64), out_bad.astype(np.int64), out_ambig

def _f32(*vals) -> float:
    """Host-side f32 constant folding, left to right (the np oracle's
    rounding), as a Python float holding the f32 value."""
    out = np.float32(vals[0])
    for v in vals[1:]:
        out = np.float32(out + np.float32(v))
    return float(out)


def _per_read(x, B: int, device) -> torch.Tensor:
    """A scalar or per-read int argument as an int64 [B] tensor."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, dtype=np.int64))
    return torch.broadcast_to(x.to(device=device, dtype=torch.int64), (B,))


def mate_by_overlap_ratio_torch(
    good_c, bad_c, olen, alens, blens, min_insert0_col: int,
    min_overlap0, min_overlap, min_insert0: int, min_insert: int,
    max_ratio: float, min_second_ratio: float, margin: float,
    offset: float, g_incr: float = 0.95, b_incr: float = 0.95,
    extra_mult: float = 1.2, collect: bool = False,
    good_f=None, bad_f=None,
):
    """mate_by_overlap_ratio_np on the tensors' device (the JAX package's
    `mate_by_overlap_ratio_jnp`): the per-insert loop runs over the
    insert axis from the largest insert down with [B] state tensors, and
    the sequential-f32 increment tables resolve through ops/lane_table.py.
    Same f32 operations in the same order, so identical results.

    good_c/bad_c/olen: int [B, D] on one device (column d is insert
    min_insert0_col + d); alens/blens: [B]; good_f/bad_f ([B, D] f32 from
    overlap_counts_quality_torch) switch to the quality mode. Returns
    (best_insert int64 [B], best_bad_int int64 [B], ambig bool [B]), and
    with collect=True the best/second candidate stats as a 4th value."""
    f32 = torch.float32
    i64 = torch.int64
    dev = good_c.device
    B, D = good_c.shape
    alens = alens.to(i64)
    blens = blens.to(i64)
    mo0 = _per_read(min_overlap0, B, dev)
    mo = _per_read(min_overlap, B, dev)
    # minOverlap=max(4, minOverlap0, minOverlap); minOverlap0=mid(4, ...)
    mo_eff = torch.clamp(torch.maximum(mo0, mo), min=4)
    mo0_eff = torch.stack([torch.full_like(mo0, 4), mo0, mo_eff]).sort(dim=0).values[1]
    min_len = torch.minimum(alens, blens)
    mo0_f = mo0_eff.to(f32)
    mo_f = mo_eff.to(f32)

    # per-insert rows, [D, B] so each step reads one contiguous row
    if good_f is not None:
        g_all = good_f.to(f32).t().contiguous()
        b_all = bad_f.to(f32).t().contiguous()
        bz_all = (bad_f == 0.0).t().contiguous()
    else:
        gt = torch.from_numpy(pack_table(incr_table(g_incr))).to(dev)
        bt = torch.from_numpy(pack_table(incr_table(b_incr))).to(dev)
        g_all = table_lookup(gt, good_c.to(torch.int32).contiguous()).t().contiguous()
        b_all = table_lookup(bt, bad_c.to(torch.int32).contiguous()).t().contiguous()
        bz_all = (bad_c == 0).t().contiguous()
    ol_all = olen.to(f32).t().contiguous()
    bad_all = bad_c.to(i64).t().contiguous()

    offset_f = _f32(offset)
    max_ratio_f = _f32(max_ratio)
    margin_f = _f32(margin)

    # ---- prescan: findBestRatio ----
    best = torch.full((B,), _f32(max_ratio, 0.0001), dtype=f32, device=dev)
    halfmax = float(np.float32(np.float32(max_ratio_f) * np.float32(0.5)))
    largest_pre = alens + blens - mo_eff
    returned = torch.zeros(B, dtype=torch.bool, device=dev)
    result = torch.zeros(B, dtype=f32, device=dev)
    for d in range(D - 1, -1, -1):
        insert = d + min_insert0_col
        if insert < min_insert:
            break  # every later (smaller) insert is out of range too
        g, b, ol, bz = g_all[d], b_all[d], ol_all[d], bz_all[d]
        inrange = (insert <= largest_pre) & ~returned
        badlimit = best * ol
        ok = inrange & (b <= badlimit)
        ret100 = ok & bz & (g > mo0_f) & (g < mo_f)
        result = torch.where(ret100, 100.0, result)
        returned = returned | ret100
        ok = ok & ~ret100
        ratio = torch.where(ol > 0, (b + offset_f) / torch.clamp(ol, min=1.0), 1.0)
        improve = ok & (ratio < best)
        best = torch.where(improve, ratio, best)
        early = improve & (g >= mo_f) & (ratio < halfmax)
        result = torch.where(early, best, result)
        returned = returned | early
    x_pre = torch.where(returned, result, best)

    no_sol = x_pre > max_ratio_f
    maxr = torch.clamp(x_pre, max=max_ratio_f)
    margin2 = _f32(margin, offset) / min_len.to(f32)
    extra_mult_f = _f32(extra_mult)
    min_second_f = _f32(min_second_ratio)
    largest = alens + blens - mo0_eff

    best_insert = torch.full((B,), -1, dtype=i64, device=dev)
    best_bad_int = torch.full((B,), -1, dtype=i64, device=dev)
    best_ratio = torch.ones(B, dtype=f32, device=dev)
    second_ratio = torch.ones(B, dtype=f32, device=dev)
    ambig = torch.zeros(B, dtype=torch.bool, device=dev)
    returned = no_sol.clone()
    ret_ambig = torch.zeros(B, dtype=torch.bool, device=dev)
    if collect:  # collector state (Java inits, BBMergeOverlapper.java:441-453)
        best_overlap = torch.full((B,), -1, dtype=i64, device=dev)
        best_bad_f = min_len.to(f32)
        second_insert = torch.zeros(B, dtype=i64, device=dev)
        second_overlap = torch.zeros(B, dtype=i64, device=dev)
        second_bad_f = torch.zeros(B, dtype=f32, device=dev)
        second_bad_int = torch.full((B,), -1, dtype=i64, device=dev)
    for d in range(D - 1, -1, -1):
        insert = d + min_insert0_col
        if insert < min_insert0:
            break
        g, b, ol, bz, bad_d = g_all[d], b_all[d], ol_all[d], bz_all[d], bad_all[d]
        inrange = (insert <= largest) & ~returned
        t2 = (torch.minimum(best_ratio, maxr) * margin_f) * ol
        badlimit = extra_mult_f * t2 + 1.0
        ok = inrange & (b <= badlimit)
        # ambiguous early return: bad==0, minOverlap0 < good < minOverlap
        ret_a = ok & bz & (g > mo0_f) & (g < mo_f)
        ret_ambig = ret_ambig | ret_a
        returned = returned | ret_a
        ok = ok & ~ret_a
        ratio = torch.where(ol > 0, (b + offset_f) / torch.clamp(ol, min=1.0), 1.0)
        cand = ok & (ratio < best_ratio * margin_f)
        new_ambig = (ratio * margin_f >= best_ratio) | (g < mo_f)
        ambig = torch.where(cand, new_ambig, ambig)
        improve = cand & (ratio < best_ratio)
        second = cand & ~improve & (ratio < second_ratio)
        # shift best -> second on improve
        second_ratio = torch.where(improve, best_ratio, second_ratio)
        if collect:
            second_insert = torch.where(improve, best_insert, second_insert)
            second_overlap = torch.where(improve, best_overlap, second_overlap)
            second_bad_f = torch.where(improve, best_bad_f, second_bad_f)
            second_bad_int = torch.where(improve, best_bad_int, second_bad_int)
            best_overlap = torch.where(improve, ol.to(i64), best_overlap)
            best_bad_f = torch.where(improve, b, best_bad_f)
            second_insert = torch.where(second, insert, second_insert)
            second_overlap = torch.where(second, ol.to(i64), second_overlap)
            second_bad_f = torch.where(second, b, second_bad_f)
            second_bad_int = torch.where(second, bad_d, second_bad_int)
        best_insert = torch.where(improve, insert, best_insert)
        best_bad_int = torch.where(improve, bad_d, best_bad_int)
        best_ratio = torch.where(improve, ratio, best_ratio)
        second_ratio = torch.where(second, ratio, second_ratio)
        ret_b = cand & (
            (ambig & (best_ratio < margin2)) | (second_ratio < min_second_f)
        )
        ret_ambig = ret_ambig | ret_b
        returned = returned | ret_b
    normal = ~returned
    ambig = torch.where(normal, ambig | (second_ratio < min_second_f), ambig)
    # normal end: if !ambig && bestRatio>maxRatio -> no solution (:614)
    best_insert = torch.where(normal & ~ambig & (best_ratio > maxr), -1, best_insert)
    out_insert = torch.where(no_sol | ret_ambig, -1, best_insert)
    out_bad = torch.where(no_sol, min_len, best_bad_int)
    # caller semantics (BBMerge findOverlap :1528): ambig counts only when
    # an insert was returned; early-ambig returns -1 with the flag set
    out_ambig = ~no_sol & ~ret_ambig & ambig & (out_insert > -1)
    if collect:
        stats = {
            "best_insert": best_insert, "best_overlap": best_overlap,
            "best_bad": best_bad_f, "best_ratio": best_ratio,
            "best_bad_int": best_bad_int,
            "second_insert": second_insert, "second_overlap": second_overlap,
            "second_bad": second_bad_f, "second_ratio": second_ratio,
            "second_bad_int": second_bad_int,
        }
        return out_insert, out_bad, out_ambig, stats
    return out_insert, out_bad, out_ambig


def overlap_and_mate(a, b_rc, alens, blens, min_insert0_col: int,
                     n_inserts: int, min_overlap0, min_overlap,
                     min_insert0: int, min_insert: int, max_ratio: float,
                     min_second_ratio: float, margin: float, offset: float,
                     extra_mult: float = 1.2, collect: bool = False,
                     aq=None, bq_rev=None, scan=overlap_counts):
    """The device pipeline: insert scan + mate selection on the tensors'
    device; only [B] winners are returned, the [B, D] count planes never
    leave the device. `scan` is the insert scan, `overlap_counts` or one
    with its arguments and outputs (BBMerge's tpshards= scan over a mesh).

    a, b_rc: uint8 codes [B, L] (b_rc reverse-complemented); alens,
    blens: [B]. With aq/bq_rev given (phred [B, L], bq reversed to match
    b_rc) the quality-weighted mode runs
    (mateByOverlapRatioJava_WithQualities): the integer mismatch counts
    still come from the insert scan (badInt), the f32 prob-weighted
    planes from the sequential-order quality scan."""
    a = a.to(torch.uint8).contiguous()
    b_rc = b_rc.to(torch.uint8).contiguous()
    al32 = alens.to(torch.int32).contiguous()
    bl32 = blens.to(torch.int32).contiguous()
    good, bad, ol = scan(a, b_rc, al32, bl32, min_insert0_col, n_inserts)
    good_f = bad_f = None
    if aq is not None:
        good_f, bad_f, _bad_int, _ol = overlap_counts_quality_torch(
            a, b_rc, aq, bq_rev, alens, blens, min_insert0_col, n_inserts
        )
    return mate_by_overlap_ratio_torch(
        good, bad, ol, alens, blens, min_insert0_col, min_overlap0,
        min_overlap, min_insert0, min_insert, max_ratio, min_second_ratio,
        margin, offset, extra_mult=extra_mult, collect=collect,
        good_f=good_f, bad_f=bad_f,
    )


# ---------------------------------------------------------------------------
# efilter / pfilter (expectedMismatches / probability) and entropy
# ---------------------------------------------------------------------------


def expected_mismatches_np(a, b_rc, aq, bq, alens, blens, overlap):
    """expectedMismatches (:1139-1176) vectorized; overlap per read [B].

    Sequential float32 sum in i-ascending order (vectorized across reads).
    """
    f32 = np.float32
    B, L = a.shape
    istart = np.where(overlap <= blens, 0, overlap - blens)
    jstart = np.where(overlap <= alens, alens - overlap, 0)
    expected = np.zeros(B, dtype=np.float32)
    pc4 = PROB_CORRECT4
    max_steps = int(min(L, np.max(overlap - istart, initial=0)))
    for t in range(max_steps):
        i = istart + t
        j = jstart + t
        live = (i < overlap) & (i < alens) & (j < blens)
        ii = np.clip(i, 0, L - 1)
        jj = np.clip(j, 0, L - 1)
        rows = np.arange(B)
        ca = a[rows, ii]
        cb = b_rc[rows, jj]
        qa = np.minimum(aq[rows, ii], 59)
        qb = np.minimum(bq[rows, jj], 59)
        both_def = (ca < 4) & (cb < 4)
        prob_c = (pc4[qa] * pc4[qb]).astype(np.float32)
        prob_e = (f32(1) - prob_c).astype(np.float32)
        contrib = np.where(live & both_def, prob_e, f32(0))
        expected = (expected + contrib).astype(np.float32)
    return expected

def probability_np(a, b_rc, aq, bq, alens, blens, insert):
    """probability (:1186-1230): returns probActual/probCommon [B] f32."""
    f32 = np.float32
    B, L = a.shape
    istart = np.where(insert <= blens, 0, insert - blens)
    jstart = np.where(insert >= blens, 0, blens - insert)
    prob_actual = np.ones(B, dtype=np.float32)
    prob_common = np.ones(B, dtype=np.float32)
    pc4 = PROB_CORRECT4
    rows = np.arange(B)
    max_steps = int(min(L, np.max(insert - istart, initial=0)))
    for t in range(max_steps):
        i = istart + t
        j = jstart + t
        live = (i < insert) & (i < alens) & (j < blens)
        ii = np.clip(i, 0, L - 1)
        jj = np.clip(j, 0, L - 1)
        ca = a[rows, ii]
        cb = b_rc[rows, jj]
        qa = np.minimum(aq[rows, ii], 59)
        qb = np.minimum(bq[rows, jj], 59)
        both_def = (ca < 4) & (cb < 4)
        prob_c = (pc4[qa] * pc4[qb]).astype(np.float32)
        prob_m = (prob_c + (f32(1) - prob_c) * f32(0.25)).astype(np.float32)
        prob_e = (f32(1) - prob_m).astype(np.float32)
        upd = live & both_def
        pc = np.where(upd, np.maximum(prob_m, prob_e), f32(1))
        pa = np.where(upd, np.where(ca == cb, prob_m, prob_e), f32(1))
        prob_common = (prob_common * pc).astype(np.float32)
        prob_actual = (prob_actual * pa).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = prob_actual / prob_common
    return np.where(prob_common > 0, r, f32(1)).astype(np.float32)

def _left_shift_rows(x, s, fill):
    """x'[:, t] = x[:, s[row] + t], `fill` past the end of the row."""
    B, L = x.shape
    idx = s.to(torch.int64)[:, None] + torch.arange(L, dtype=torch.int64,
                                                    device=x.device)[None, :]
    got = torch.gather(x, 1, idx.clamp(0, L - 1))
    return torch.where(idx < L, got, torch.full_like(got, fill))


def _aligned_pc4(a, b_rc, aq, bq, alens, blens, istart, jstart, stop):
    """The per-step planes shared by expectedMismatches and probability:
    step t compares a[istart + t] with b_rc[jstart + t]. Returns
    (live & both defined [B, L], pc4[qa] * pc4[qb] f32 [B, L], equal
    codes [B, L]); the probCorrect4 reads go through the lane table."""
    B, L = a.shape
    dev = a.device
    pc4t = torch.from_numpy(pack_table(PROB_CORRECT4)).to(dev)
    pa4 = table_lookup(pc4t, torch.clamp(aq.to(torch.int32), max=59).contiguous())
    pb4 = table_lookup(pc4t, torch.clamp(bq.to(torch.int32), max=59).contiguous())
    a2 = _left_shift_rows(a.to(torch.int32), istart, 4)
    b2 = _left_shift_rows(b_rc.to(torch.int32), jstart, 4)
    pa2 = _left_shift_rows(pa4, istart, 0.0)
    pb2 = _left_shift_rows(pb4, jstart, 0.0)
    t_idx = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    i = istart[:, None] + t_idx
    jj = jstart[:, None] + t_idx
    live = (i < stop[:, None]) & (i < alens[:, None]) & (jj < blens[:, None])
    upd = live & (a2 < 4) & (b2 < 4)
    return upd, pa2 * pb2, a2 == b2


def _steps(istart, stop, L: int) -> int:
    """The np loops' step count, min(L, max(stop - istart)): later steps
    are masked in every row (an exact +0.0f or *1.0f), so skip them."""
    return min(L, int((stop - istart).max())) if stop.numel() else 0


def expected_mismatches_torch(a, b_rc, aq, bq, alens, blens, overlap):
    """expected_mismatches_np on the tensors' device (the JAX package's
    `expected_mismatches_jnp`): the f32 sum runs as a loop over steps t
    in the np loop's order (masked steps add +0.0f, an exact identity)."""
    alens, blens, overlap = (x.to(torch.int64) for x in (alens, blens, overlap))
    istart = torch.where(overlap <= blens, 0, overlap - blens)
    jstart = torch.where(overlap <= alens, alens - overlap, 0)
    upd, prob_c, _ = _aligned_pc4(a, b_rc, aq, bq, alens, blens, istart,
                                  jstart, overlap)
    prob_e = 1.0 - prob_c
    contrib = torch.where(upd, prob_e, 0.0).t().contiguous()  # [L, B]
    acc = torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
    for t in range(_steps(istart, overlap, a.shape[1])):
        acc = acc + contrib[t]
    return acc


def probability_torch(a, b_rc, aq, bq, alens, blens, insert):
    """probability_np on the tensors' device (the JAX package's
    `probability_jnp`; masked steps multiply by an exact 1.0f). Torch
    keeps f32 subnormals where XLA flushes them, so this equals the np
    oracle on every row."""
    alens, blens, insert = (x.to(torch.int64) for x in (alens, blens, insert))
    istart = torch.where(insert <= blens, 0, insert - blens)
    jstart = torch.where(insert >= blens, 0, blens - insert)
    upd, prob_c, eq = _aligned_pc4(a, b_rc, aq, bq, alens, blens, istart,
                                   jstart, insert)
    prob_m = prob_c + (1.0 - prob_c) * 0.25
    prob_e = 1.0 - prob_m
    pc = torch.where(upd, torch.maximum(prob_m, prob_e), 1.0).t().contiguous()
    pa = torch.where(upd, torch.where(eq, prob_m, prob_e), 1.0).t().contiguous()
    common = torch.ones(a.shape[0], dtype=torch.float32, device=a.device)
    actual = torch.ones_like(common)
    for t in range(_steps(istart, insert, a.shape[1])):
        common = common * pc[t]
        actual = actual * pa[t]
    return torch.where(common > 0, actual / common, 1.0)


def calc_min_overlap_by_entropy_np(codes, lengths, k: int, minscore: int,
                                   from_tail: bool):
    """calcMinOverlapByEntropyHead/Tail (:1303-1400) vectorized over reads.

    Scans 3-mers from one end; returns first index i where
    ones*4 + twos >= minscore, else length+1.
    """
    B, L = codes.shape
    space = 1 << (2 * k)
    mask = space - 1
    counts = np.zeros((B, space), dtype=np.int16)
    kmer = np.zeros(B, dtype=np.int64)
    ln = np.zeros(B, dtype=np.int64)
    ones = np.zeros(B, dtype=np.int64)
    twos = np.zeros(B, dtype=np.int64)
    result = lengths.astype(np.int64) + 1
    done = np.zeros(B, dtype=bool)
    rows = np.arange(B)
    for i in range(int(lengths.max(initial=0))):
        pos = (lengths - 1 - i) if from_tail else np.full(B, i)
        live = (i < lengths) & ~done
        pp = np.clip(pos, 0, L - 1)
        b = codes[rows, pp]
        defined = b < 4
        ln = np.where(live & defined, ln + 1, np.where(live, 0, ln))
        kmer = np.where(
            live & defined, ((kmer << 2) | np.where(defined, b, 0)) & mask,
            np.where(live, 0, kmer),
        )
        add = live & defined & (ln >= k)
        old = counts[rows, kmer]
        counts[rows, kmer] = np.where(add, old + 1, old)
        newc = counts[rows, kmer]
        ones = np.where(add & (newc == 1), ones + 1, ones)
        twos = np.where(add & (newc == 2), twos + 1, twos)
        hit = add & (ones * 4 + twos >= minscore)
        result = np.where(hit & ~done, i, result)
        done |= hit
    return result

def calc_min_overlap_by_entropy_torch(codes, lengths, k: int, minscore: int,
                                      from_tail: bool):
    """calc_min_overlap_by_entropy_np on the tensors' device: a loop over
    positions with a [B, 4^k] count table, one scatter per step. Integer
    state only, so exact."""
    B, L = codes.shape
    dev = codes.device
    space = 1 << (2 * k)
    mask = space - 1
    lengths = lengths.to(torch.int64)
    codes = codes.to(torch.int64)
    counts = torch.zeros((B, space), dtype=torch.int32, device=dev)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    kmer, ln, ones, twos = zero, zero, zero, zero
    result = lengths + 1
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    # no read is live past its length (the np loop's bound)
    for i in range(min(L, int(lengths.max())) if B else 0):
        pos = (lengths - 1 - i) if from_tail else torch.full_like(lengths, i)
        live = (i < lengths) & ~done
        b = torch.gather(codes, 1, pos.clamp(0, L - 1)[:, None])[:, 0]
        defined = b < 4
        step = live & defined
        ln = torch.where(step, ln + 1, torch.where(live, 0, ln))
        kmer = torch.where(step, ((kmer << 2) | torch.where(defined, b, 0)) & mask,
                           torch.where(live, 0, kmer))
        add = step & (ln >= k)
        old = torch.gather(counts, 1, kmer[:, None])[:, 0]
        counts.scatter_add_(1, kmer[:, None], add[:, None].to(torch.int32))
        newc = old + 1
        ones = torch.where(add & (newc == 1), ones + 1, ones)
        twos = torch.where(add & (newc == 2), twos + 1, twos)
        hit = add & (ones * 4 + twos >= minscore)
        result = torch.where(hit & ~done, i, result)
        done = done | hit
    return result


def expected_tip_errors_np(bases, quals, lengths, max_bases):
    """Read.expectedTipErrors(false, maxBases) vectorized: sum of
    PROB_ERROR[q] over the LAST min(maxBases, len) defined bases
    (stream/Read.java:3004-3025; countUndefined=false)."""
    from ..core.qualtools import PROB_ERROR

    B, L = bases.shape
    if quals is None:
        return np.zeros(B, np.float32)
    lengths = np.asarray(lengths)
    mb = np.broadcast_to(np.asarray(max_bases), (B,))
    limit0 = np.minimum(np.maximum(mb, 1), lengths)
    lo = lengths - limit0  # sum i in [lo, len)
    i_idx = np.arange(L)[None, :]
    live = (i_idx >= lo[:, None]) & (i_idx < lengths[:, None]) & (bases < 4)
    pe = PROB_ERROR[np.minimum(quals, 127)]
    return np.where(live, pe, 0).astype(np.float32).sum(axis=1,
                                                        dtype=np.float32)


def bbmerge_nn_features(alens, blens, min_overlap, r1ee, r2ee, stats,
                        best_expected, probability):
    """The 23-float vector the BBMerge net gate consumes, in reference
    order (jgi/BBMerge.java:2440-2546 + BBMergeOverlapper.java:552-575;
    best/second Good stay at their ratio-mode inits so features 8/14/19
    are constants 0.2/0.2/0.0)."""
    f32 = np.float32
    B = len(alens)
    s = stats
    bo = s["best_overlap"].astype(np.float32)
    so = s["second_overlap"].astype(np.float32)
    bb = s["best_bad"].astype(np.float32)
    sb = s["second_bad"].astype(np.float32)
    bbi = s["best_bad_int"].astype(np.float32)
    sbi = s["second_bad_int"].astype(np.float32)
    feats = np.stack(
        [
            np.broadcast_to(np.asarray(min_overlap), (B,)) * f32(0.1),
            r1ee,
            r2ee,
            (alens - 100) * f32(0.01),
            (blens - 100) * f32(0.01),
            s["best_insert"] * f32(0.004),
            bo / (bo + f32(50)),
            (bb + 1) / (bb + 5),
            np.full(B, f32(0.2)),  # (bestGood+1)/(bestGood+5), good==0
            s["best_ratio"],
            (bbi + 1) / (bbi + 5),
            s["second_insert"] * f32(0.004),
            so / (so + f32(50)),
            (sb + 1) / (sb + 5),
            np.full(B, f32(0.2)),  # (secondBestGood+1)/(+5)
            s["second_ratio"],
            sbi / (sbi + 5),
            (s["second_ratio"] + 1) / (s["best_ratio"] + 1),
            sb / (bb + 8),
            np.zeros(B, np.float32),  # secondBestGood/(bestGood+8)
            bo + 1,  # placeholder, fixed below
            np.asarray(best_expected, np.float32),
            np.asarray(probability, np.float32),
        ],
        axis=1,
    ).astype(np.float32)
    feats[:, 20] = (bo + 1) / (so + bo + 1)
    return feats
