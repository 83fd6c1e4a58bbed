"""MultiStateAligner11ts traceback: the walk over the prevState planes,
and the host helpers around the fill.

The PyTorch port of what BBMap needs from bbtools_tpu/ops/msa.py:
`msa_walk` (traceback2, MultiStateAligner11ts.java:1167-1266) as a torch
loop of R+Cc steps with one per-lane gather each, and copies of the host
functions `col0_scores`, `prepare_limits_np` and `match_strings_np`,
and `realign_batch`, CallVariants' realignment. The unpruned fill itself
is ops/msa_fill.py: the B4 kernel over full-width windows, and its plain
torch wavefront, which realignment runs over ragged windows on any
device. The pruned fill (fillLimited, `prune=True`) has no caller yet
and is not ported (ROADMAP queue A).
"""

from __future__ import annotations

import numpy as np
import torch

from . import msa_constants as C


def prepare_limits_np(read_codes, read_lens, ref_codes, ref_lens, min_score):
    """Host precompute of vertLimit/horizLimit/floor/subfloor (:204-230).

    read_codes [B, R], ref_codes [B, Cc]; min_score [B] already reduced by
    MIN_SCORE_ADJUST. Returns vert [B, R+1], horiz [B, Cc+1], floor [B],
    subfloor [B].
    """
    B, R = read_codes.shape
    Cc = ref_codes.shape[1]
    maxgain = (read_lens.astype(np.int64) - 1) * C.POINTS_MATCH2 + C.POINTS_MATCH
    floor = min_score.astype(np.int64) - maxgain
    subfloor = floor - 5 * C.POINTS_MATCH2
    vert = np.zeros((B, R + 1), dtype=np.int64)
    horiz = np.zeros((B, Cc + 1), dtype=np.int64)
    pos = np.arange(R)
    for arr, codes, lens in ((vert, read_codes, read_lens), (horiz, ref_codes, ref_lens)):
        n = codes.shape[1]
        defined = codes < 4
        # step at index i (contribution when moving from i+1 to i):
        nxt_defined = np.zeros_like(defined)
        nxt_defined[:, : n - 1] = defined[:, 1:]
        # cells at/after lens have no effect (we only read 0..lens)
        within = np.arange(n)[None, :] < lens[:, None]
        nxt_within = np.arange(n)[None, :] + 1 < lens[:, None]
        step = np.where(
            defined & within,
            np.where(nxt_defined & nxt_within, C.POINTS_MATCH2, C.POINTS_MATCH),
            0,  # NOCALL / NOREF
        ).astype(np.int64)
        # arr[i] = max(min_score - sum(step[i:lens]), floor) for i < lens
        sfx = np.cumsum(step[:, ::-1], axis=1)[:, ::-1]
        arr[:, :n] = np.maximum(min_score[:, None] - sfx, floor[:, None])
        arr[np.arange(B), lens] = min_score
    return vert, horiz, floor, subfloor


def col0_scores(R: int) -> np.ndarray:
    """Column-0 cumulative insertion penalties (ctor :91-101)."""
    col0 = np.zeros(R + 1, dtype=np.int64)
    for i in range(R + 1):
        prev = 0 if i < 2 else col0[i - 1]
        col0[i] = prev + C.POINTS_INS_ARRAY[min(i, 603)]
    return col0


def msa_walk(R: int, Cc: int, planes, read_lens, max_col, max_state):
    """Device traceback walk (traceback2, :1167-1266).

    planes: uint8 [D, B, R+1] prevState planes of the fill (D = R+Cc-1
    diagonals, diagonal d=r+c stored at index d-2). Returns ops uint8
    [B, R+Cc]: 1=diag, 2=del, 3=ins, 4=X-tail, 0=none, in WALK order (end
    of alignment first; the caller reverses), and the step count int32
    [B].
    """
    B = planes.shape[1]
    dev = planes.device
    i32 = torch.int32
    steps = R + Cc
    lanes = torch.arange(B, device=dev)
    nd = planes.shape[0]
    row = read_lens.to(i32)
    col = max_col.to(i32)
    state = max_state.to(i32)
    pos = torch.zeros(B, dtype=i32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    ops = torch.empty((steps, B), dtype=torch.uint8, device=dev)
    for t in range(steps):
        # this cell's prevState byte: planes[d-2, b, row]
        didx = (row + col - 2).clamp(0, nd - 1).long()
        cell = planes[didx, lanes, row.clamp(0, R).long()].to(i32)
        prev_ms = cell & 3
        prev_del = (cell >> 2) & 3
        prev_ins = (cell >> 4) & 3
        active = ~done & (row > 0) & (col > 0)
        op = torch.where(state == 0, 1, torch.where(state == 1, 2, 3))
        nxt_state = torch.where(
            state == 0, prev_ms, torch.where(state == 1, prev_del, prev_ins)
        )
        nrow = torch.where(state == 1, row, row - 1)  # DEL keeps row
        ncol = torch.where(state == 2, col, col - 1)  # INS keeps col
        # X tail: row>0 after col hit 0 (:1261-1272): emit X, row--, col--
        tail = ~done & ~active & (row > 0) & (col != row)
        ops[t] = torch.where(tail, 4, torch.where(active, op, 0)).to(torch.uint8)
        emit = active | tail
        row = torch.where(active, nrow, torch.where(tail, row - 1, row))
        col = torch.where(active, ncol, torch.where(tail, col - 1, col))
        state = torch.where(active, nxt_state, state)
        done = done | (~active & ~tail)
        pos = torch.where(emit, pos + 1, pos)
    return ops.t().contiguous(), pos


def match_strings_np(ops, nsteps, reads, read_lens, refs, ref_lens, max_col):
    """Render match strings from walk ops (host, vectorized over steps).

    Returns list[bytes] per task, in alignment (left-to-right) order, and
    the alignment's reference start column (0-based within the window).
    """
    ops = np.asarray(ops)
    nsteps = np.asarray(nsteps)
    B, S = ops.shape
    # reverse each walk into alignment order
    out = [bytearray() for _ in range(B)]
    row = read_lens.astype(np.int64).copy()
    col = np.asarray(max_col, dtype=np.int64).copy()
    chars = np.zeros((B, S), dtype=np.uint8)
    rows_at = np.zeros((B, S), dtype=np.int64)
    cols_at = np.zeros((B, S), dtype=np.int64)
    for sstep in range(S):
        o = ops[:, sstep]
        rows_at[:, sstep] = row
        cols_at[:, sstep] = col
        row = np.where((o == 1) | (o == 3) | (o == 4), row - 1, row)
        col = np.where((o == 1) | (o == 2) | (o == 4), col - 1, col)
    rowsB = np.arange(B)[:, None]
    rd = reads[rowsB, np.clip(rows_at - 1, 0, reads.shape[1] - 1)]
    rf = refs[rowsB, np.clip(cols_at - 1, 0, refs.shape[1] - 1)]
    eq = rd == rf
    # reference: c==r -> 'm' (including N==N); else undefined -> 'N',
    # else 'S' (traceback2 :1201-1214). Code-equality over ACGTN inputs
    # matches byte-equality.
    diag_char = np.where(
        eq, ord("m"), np.where((rd >= 4) | (rf >= 4), ord("N"), ord("S"))
    )
    ins_char = np.where(
        cols_at == 0, ord("X"),
        np.where(cols_at >= ref_lens[:, None] + 1, ord("Y"), ord("I")),
    )
    chars = np.where(
        ops == 1, diag_char,
        np.where(ops == 2, ord("D"),
                 np.where(ops == 3, ins_char,
                          np.where(ops == 4, ord("X"), 0))),
    ).astype(np.uint8)
    result = []
    for b in range(B):
        n = int(nsteps[b])
        result.append(bytes(chars[b, :n][::-1]))
    return result


def realign_batch(reads, read_lens, refs, ref_lens, device="cuda"):
    """Full-alignment helper (the var2/Realigner use-case): glocal MSA of
    each read against its padded reference window, with traceback, on
    `device`: the unpruned torch wavefront over the ragged windows
    (`msa_fill_plain` with ref_lens), the walk, then the host match
    strings.

    Returns (match_strings list[bytes], start_cols int array, scores).
    start_col is the window column where the alignment begins.
    """
    from .msa_fill import msa_fill_plain

    reads = np.asarray(reads, np.uint8)
    refs = np.asarray(refs, np.uint8)
    read_lens = np.asarray(read_lens, np.int32)
    ref_lens = np.asarray(ref_lens, np.int32)
    B = reads.shape[0]
    Cc = refs.shape[1]
    dev = torch.device(device)
    t_lens = torch.as_tensor(read_lens, device=dev)
    score, max_col, max_state, planes = msa_fill_plain(
        torch.as_tensor(reads, device=dev), t_lens,
        torch.as_tensor(refs, device=dev), torch.as_tensor(ref_lens, device=dev),
    )
    Rp = planes.shape[2] - 1  # the rows the fill kept
    ops, nsteps = msa_walk(Rp, Cc, planes, t_lens, max_col, max_state)
    ops = ops.cpu().numpy()
    nsteps = nsteps.cpu().numpy()
    score = score.cpu().numpy()
    max_col = max_col.cpu().numpy()
    matches = match_strings_np(
        ops, nsteps, reads, read_lens, refs, ref_lens, max_col
    )
    start_cols = np.empty(B, dtype=np.int64)
    for b in range(B):
        m = matches[b]
        ndiag = sum(m.count(x) for x in (b"m", b"S", b"N", b"D"))
        start_cols[b] = int(max_col[b]) - ndiag
    return matches, start_cols, score
