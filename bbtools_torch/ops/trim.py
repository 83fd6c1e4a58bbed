"""Quality trimming — batched exact port of the reference semantics.

Replicates shared/TrimRead.java `testOptimal` (:348-400): a Kadane
maximum-subarray over delta = avgErrorRate - P_err(base), accumulated in
float32 with reset-to-0, tie-break preferring the longer run; the winning
run is kept and everything outside it trimmed. Reads with no positive run
trim everything (left=0, right=len).

Float32 accumulation order matters for bit-parity, so `optimal_trim` is a
sequential loop over the columns of the read in the order of the JAX
package's `lax.scan` (bbtools_tpu/ops/trim.py), batched over reads, not a
cumsum reformulation: each step rounds exactly as the reference does.

N semantics: a base takes nprob = max(min(avg*1.1, 1), 0.75) when the raw
byte is 'N' or q < 1 (TrimRead.java:364,377).

The host functions are copies of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.qualtools import PROB_ERROR

NPROB = np.float32(0.75)


def _nprob(avg_error_rate: float) -> np.float32:
    return np.float32(max(min(np.float32(avg_error_rate) * np.float32(1.1), 1.0), NPROB))


def optimal_trim_np(
    quals: np.ndarray,
    lengths: np.ndarray,
    is_n: np.ndarray,
    avg_error_rate: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Host oracle; returns (left, right) trim counts per read.

    quals uint8 [B, L]; is_n bool [B, L] (raw byte == 'N'); lengths [B].
    """
    B, L = quals.shape
    avg = np.float32(avg_error_rate)
    nprob = _nprob(avg_error_rate)
    left = np.zeros(B, dtype=np.int32)
    right = np.zeros(B, dtype=np.int32)
    for b in range(B):
        n = int(lengths[b])
        score = np.float32(0)
        max_score = np.float32(0)
        count = 0
        max_count = -1
        max_loc = -1
        for i in range(n):
            q = quals[b, i]
            pe = nprob if (is_n[b, i] or q < 1) else PROB_ERROR[q]
            delta = np.float32(avg - pe)
            score = np.float32(score + delta)
            if score > 0:
                count += 1
                if score > max_score or (score == max_score and count > max_count):
                    max_score = score
                    max_count = count
                    max_loc = i
            else:
                score = np.float32(0)
                count = 0
        if max_score > 0:
            left[b] = max_loc - max_count + 1
            right[b] = n - max_loc - 1
        else:
            left[b] = 0
            right[b] = n
    return left, right


def optimal_trim(quals, lengths, is_n, avg_error_rate: float):
    """(left, right) int32 [B] trim amounts on the batch's device.

    quals uint8 [B, L]; lengths int32 [B]; is_n bool [B, L] (raw byte ==
    'N'). One float32 Kadane step per column, in column order."""
    B, L = quals.shape
    dev = quals.device
    avg = torch.tensor(np.float32(avg_error_rate), device=dev)
    nprob = torch.tensor(_nprob(avg_error_rate), device=dev)
    prob_err = torch.from_numpy(PROB_ERROR).to(dev)
    q = torch.clamp(quals.to(torch.int64), max=127)
    pe = torch.where(is_n | (q < 1), nprob, prob_err[q])
    delta = avg - pe  # float32 [B, L]
    active = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    score = torch.zeros(B, dtype=torch.float32, device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    max_score = torch.zeros(B, dtype=torch.float32, device=dev)
    max_count = torch.full((B,), -1, dtype=torch.int32, device=dev)
    max_loc = torch.full((B,), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(L):
        act = active[:, i]
        new_score = score + delta[:, i]
        pos = new_score > 0
        new_count = torch.where(pos, count + 1, 0)
        better = pos & (
            (new_score > max_score)
            | ((new_score == max_score) & (new_count > max_count))
        )
        # padding positions leave everything unchanged
        upd = act & better
        max_score = torch.where(upd, new_score, max_score)
        max_count = torch.where(upd, new_count, max_count)
        max_loc = torch.where(upd, i, max_loc)
        score = torch.where(act, torch.where(pos, new_score, zero), score)
        count = torch.where(act, new_count, count)
    found = max_score > 0
    left = torch.where(found, max_loc - max_count + 1, 0).to(torch.int32)
    right = torch.where(found, lengths - max_loc - 1, lengths).to(torch.int32)
    return left, right


def force_trim_amounts(
    lengths: np.ndarray, ftl: int, ftr: int, ftr2: int, ftm: int
):
    """Force-trim left/right amounts (jgi/BBDuk force-trim flags).

    ftl: first kept index; ftr: last kept index (0 disables when <0);
    ftr2: trim this many from the right; ftm: trim right so len % ftm == 0.
    Returns (left_amount, right_amount) per read.
    """
    xp = np
    left = xp.zeros_like(lengths)
    right = xp.zeros_like(lengths)
    if ftl > 0:
        left = xp.full_like(lengths, ftl)
    if ftr >= 0:
        right = xp.maximum(right, lengths - 1 - ftr)
    if ftr2 > 0:
        right = xp.maximum(right, xp.full_like(lengths, ftr2))
    if ftm > 0:
        right = xp.maximum(right, lengths % ftm)
    right = xp.minimum(right, lengths)
    left = xp.minimum(left, lengths)
    return left, right


def apply_trim(batch, left: np.ndarray, right: np.ndarray):
    """Materialize per-read (left, right) trims on a host ReadBatch: shifts
    rows left and shrinks lengths. Returns a new ReadBatch (shared ids)."""
    from ..io.batch import ReadBatch

    B, L = batch.bases.shape
    left = np.asarray(left, dtype=np.int64)
    right = np.asarray(right, dtype=np.int64)
    new_len = np.maximum(batch.lengths - left - right, 0).astype(np.int32)
    idx = left[:, None] + np.arange(L, dtype=np.int64)[None, :]
    np.minimum(idx, L - 1, out=idx)
    rows = np.arange(B)[:, None]
    mask = np.arange(L)[None, :] >= new_len[:, None]
    bases = batch.bases[rows, idx]
    bases[mask] = 4
    quals = None
    if batch.quals is not None:
        quals = batch.quals[rows, idx]
        quals[mask] = 0
    ascii_b = None
    if batch.ascii_bases is not None:
        ascii_b = batch.ascii_bases[rows, idx]
        ascii_b[mask] = ord("N")
    return ReadBatch(
        bases=bases,
        quals=quals,
        lengths=new_len,
        ids=batch.ids,
        ordinal=batch.ordinal,
        numeric_id0=batch.numeric_id0,
        ascii_bases=ascii_b,
    )
