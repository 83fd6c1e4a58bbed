"""Ungapped site scoring — batched scoreNoIndels.

The PyTorch port of bbtools_tpu/ops/score_ungapped.py: the exact
MultiStateAligner11ts.scoreNoIndels (:960-1030), a single diagonal scan
with a (mode, timeInMode) carry giving the same streak-dependent
match/sub scores; out-of-reference positions score POINTS_NOREF. One
torch step per read position, vectorized over candidate sites, int32
and exact on any device.

The JAX version pre-aligns the windows by log-shifts, a workaround for
the TPU's slow per-row gathers. Here one clamped gather builds the
aligned columns; the clamped values fall only where `in_ref` masks them.
"""

from __future__ import annotations

import torch

from . import msa_constants as C


def _sub_array(i):
    return torch.where(
        i > C.LIMIT_FOR_COST_3,
        C.POINTS_SUB3,
        torch.where(i > 1, C.POINTS_SUB2, C.POINTS_SUB),
    )


def _scan_step(score, mode, tim, c, r, active, in_ref=None):
    """One read position of scoreNoIndels over [B] or [C, NOFF] lanes.
    `in_ref` None means every column lies in the reference."""
    is_match = (c == r) & (c < 4)
    if in_ref is None:
        is_nocall = ~is_match & (c >= 4)
        is_noref = ~is_match & (c < 4) & (r >= 4)
        is_sub = ~is_match & (c < 4) & (r < 4)
    else:
        is_match = in_ref & is_match
        is_nocall = in_ref & ~is_match & (c >= 4)
        is_noref = ~in_ref | (in_ref & ~is_match & (c < 4) & (r >= 4))
        is_sub = in_ref & ~is_match & (c < 4) & (r < 4)
    new_tim = torch.where(
        is_match,
        torch.where(mode == 0, tim + 1, 0),
        torch.where(is_sub, torch.where(mode == 1, tim + 1, 0), tim),
    )
    delta = torch.where(
        is_match,
        torch.where(mode == 0, C.POINTS_MATCH2, C.POINTS_MATCH),
        torch.where(
            is_nocall,
            C.POINTS_NOCALL,
            torch.where(is_noref, C.POINTS_NOREF, _sub_array(new_tim + 1)),
        ),
    ).to(torch.int32)
    new_mode = torch.where(is_match, 0, torch.where(is_sub, 1, mode))
    score = torch.where(active, score + delta, score)
    upd = active & (is_match | is_sub)
    mode = torch.where(upd, new_mode, mode).to(torch.int32)
    tim = torch.where(upd, new_tim, tim).to(torch.int32)
    return score, mode, tim


def score_no_indels(R: int, reads, read_lens, refwins, ref_starts, ref_lens):
    """Score reads against reference windows at fixed offsets (no indels).

    reads [B, R] uint8; refwins [B, W] uint8, a window of the reference
    with the candidate site at column `ref_starts[b]` (may be negative
    for off-the-end sites, relative to the window); ref_lens = number of
    valid columns in each window (at most W). Returns score int32 [B].
    """
    B, W = refwins.shape
    dev = refwins.device
    i32 = torch.int32
    reads_i = reads.to(i32)
    starts = ref_starts.to(torch.int64)[:, None]
    rpos = starts + torch.arange(R, device=dev)[None, :]  # [B, R]
    in_ref = (rpos >= 0) & (rpos < ref_lens.to(torch.int64)[:, None])
    aligned = torch.gather(refwins, 1, rpos.clamp(0, max(W - 1, 0))).to(i32)
    lens = read_lens.to(torch.int64)
    score = torch.zeros(B, dtype=i32, device=dev)
    mode = torch.full((B,), -1, dtype=i32, device=dev)
    tim = torch.zeros(B, dtype=i32, device=dev)
    for i in range(R):
        score, mode, tim = _scan_step(
            score, mode, tim, reads_i[:, i], aligned[:, i], i < lens,
            in_ref[:, i],
        )
    return score


def score_no_indels_offsets(R: int, NOFF: int, reads, read_lens, wins):
    """Sliding-offset scoreNoIndels: score of reads[c] vs wins[c, o:o+R]
    for every offset o in [0, NOFF), in one scan. Used by mate rescue
    (AbstractMapThread.rescue scans every offset in the insert window).

    Windows must be 4-filled outside the reference so off-reference
    columns take the POINTS_NOREF branch; requires wins.shape[1] >=
    NOFF + R - 1. Returns int32 [C, NOFF].
    """
    i32 = torch.int32
    dev = wins.device
    reads_i = reads.to(i32)  # [C, R]
    wins_i = wins.to(i32)
    C_ = wins_i.shape[0]
    active_rows = read_lens.to(torch.int64)[:, None]  # [C, 1]
    score = torch.zeros((C_, NOFF), dtype=i32, device=dev)
    mode = torch.full((C_, NOFF), -1, dtype=i32, device=dev)
    tim = torch.zeros((C_, NOFF), dtype=i32, device=dev)
    for i in range(R):
        score, mode, tim = _scan_step(
            score, mode, tim, reads_i[:, i : i + 1], wins_i[:, i : i + NOFF],
            i < active_rows,
        )
    return score


def score_no_indels_np(read, ref, ref_start):
    """Host oracle (direct transliteration) for one (read, site)."""
    score = 0
    mode = -1
    tim = 0
    read_start = 0
    read_stop = len(read)
    ref_stop = ref_start + len(read)
    if ref_start < 0:
        read_start = -ref_start
        score += C.POINTS_NOREF * read_start
    if ref_stop > len(ref):
        dif = ref_stop - len(ref)
        read_stop -= dif
        score += C.POINTS_NOREF * dif
    for i in range(read_start, read_stop):
        c = read[i]
        r = ref[ref_start + i]
        if c == r and c < 4:
            if mode == 0:
                tim += 1
                score += C.POINTS_MATCH2
            else:
                tim = 0
                score += C.POINTS_MATCH
            mode = 0
        elif c >= 4:
            score += C.POINTS_NOCALL
        elif r >= 4:
            score += C.POINTS_NOREF
        else:
            if mode == 1:
                tim += 1
            else:
                tim = 0
            score += int(C.POINTS_SUB_ARRAY[min(tim + 1, 603)])
            mode = 1
    return score
