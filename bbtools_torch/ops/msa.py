"""MultiStateAligner11ts traceback: the walk over the prevState planes,
and the host helpers around the fill.

The PyTorch port of what BBMap needs from bbtools_tpu/ops/msa.py:
`msa_walk` (traceback2, MultiStateAligner11ts.java:1167-1266) as a torch
loop of R+Cc steps with one per-lane gather each, and copies of the host
functions `col0_scores`, `prepare_limits_np` and `match_strings_np`,
and `realign_batch`, CallVariants' realignment. The unpruned fill with
traceback planes is ops/msa_fill.py: the B4 kernel over full-width
windows, and its plain torch wavefront, which realignment runs over
ragged windows on any device. `msa_fill_batch` is the JAX package's
host wrapper of its XLA fill: fillLimitedX (prune=True, :128-610) or
fillUnlimited (prune=False), torch ops over the anti-diagonals on the
run's device; with traceback=True it also writes the prevState planes
(`msa_fill_tb`, the JAX package's `msa_fill(traceback=True)`) and walks
them, in groups under the plane budget.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
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


def _calc_del_score(length):
    """The penalty of a deletion of `length` columns (calcDelScore)."""
    score = torch.where(length > 0, C.POINTS_DEL, 0)
    score = score + torch.where(
        length > C.LIMIT_FOR_COST_5,
        torch.div(length - C.LIMIT_FOR_COST_5 + C.MASK5, C.TIMESLIP,
                  rounding_mode="floor") * C.POINTS_DEL5,
        0,
    )
    l5 = length.clamp(max=C.LIMIT_FOR_COST_5)
    score = score + torch.where(
        l5 > C.LIMIT_FOR_COST_4, (l5 - C.LIMIT_FOR_COST_4) * C.POINTS_DEL4, 0)
    l4 = l5.clamp(max=C.LIMIT_FOR_COST_4)
    score = score + torch.where(
        l4 > C.LIMIT_FOR_COST_3, (l4 - C.LIMIT_FOR_COST_3) * C.POINTS_DEL3, 0)
    l3 = l4.clamp(max=C.LIMIT_FOR_COST_3)
    return score + torch.where(l3 > 1, (l3 - 1) * C.POINTS_DEL2, 0)


def _calc_ins_score(length, cum_ins):
    """The penalty of an insertion of `length` rows (calcInsScore)."""
    return torch.where(length > 0, cum_ins[length.clamp(0, 603).long()], 0)


def _fill_scores(reads, read_lens, refs, ref_lens, vert, horiz, floor, subfloor,
                 prune: bool, traceback: bool = False):
    """(max_score, max_col, max_state) int32 [B] of the wavefront fill, one
    step of torch ops per diagonal over [B, R+1] rows: fillLimitedX with
    prune (each cell held to its limit, a dead cell at subfloor), else
    fillUnlimited. With traceback, also the uint8 prevState planes [R+Cc-1,
    B, R+1] (diagonal d at d-2), each byte from the picks before the
    gates, as the JAX package's `msa_fill(traceback=True)` writes them.
    All tensors on one device; limits int32."""
    from .msa_fill import NEG_BIG, REF_PAD, _del_ext_cost, _ins_array_cost, \
        _shift_row, _sub_array_cost

    B, R = reads.shape
    Cc = refs.shape[1]
    W = R + 1
    dev = reads.device
    i32 = torch.int32
    rr = torch.arange(W, dtype=i32, device=dev)[None, :]
    rd = reads.to(i32)
    call1 = torch.cat([torch.full((B, 1), 99, dtype=i32, device=dev), rd], 1)
    call0 = torch.cat([torch.full((B, 2), 98, dtype=i32, device=dev), rd[:, :-1]], 1)
    # reversed once, so each diagonal's row-ordered values are a view:
    # row r reads ref[c-1] = refp[d - r + R + 1] and horiz[c] = hp[d - r + R + 2]
    PAD = R + 2
    rev = F.pad(refs.to(i32), (PAD, PAD), value=REF_PAD).flip(1)
    hrev = F.pad(horiz, (PAD, PAD), value=1 << 29).flip(1)
    n, nh = rev.shape[1], hrev.shape[1]
    col0 = torch.as_tensor(col0_scores(R), dtype=i32, device=dev)[None, :]
    cum_ins = torch.as_tensor(C.POINTS_INS_ARRAY_C, dtype=i32, device=dev)
    rows = read_lens.to(i32)[:, None]
    cols = ref_lens.to(i32)[:, None]
    sf = subfloor[:, None]
    fl = floor[:, None]
    del_barrier = (rr < C.BARRIER_D1) | (rr > rows - C.BARRIER_D1)
    ins_lo = rr < C.BARRIER_I1
    ins_hi = rr > rows - C.BARRIER_I1
    fin_row = rows.long()

    def init_diag(dd):
        c = dd - rr
        s = torch.where(c == 0, col0, torch.where(rr == 0, 0, NEG_BIG))
        return s.to(i32).expand(B, W)

    zero = torch.zeros((B, W), dtype=i32, device=dev)
    s0, s1 = init_diag(0), init_diag(1)
    # (ms_s, ms_t, del_s, del_t, ins_s, ins_t) of diagonals d-1 and d-2
    p1 = (s1, zero, s1, zero, s1, zero)
    p2 = (s0, zero, s0, zero, s0, zero)
    best_s = [torch.full((B,), NEG_BIG, dtype=i32, device=dev) for _ in range(3)]
    best_c = [torch.full((B,), -1, dtype=i32, device=dev) for _ in range(3)]
    planes = (torch.empty((R + Cc - 1, B, W), dtype=torch.uint8, device=dev)
              if traceback else None)
    for d in range(2, R + Cc + 1):
        c = d - rr
        lo = n - 1 - (d + R + 1)
        ref1 = rev[:, lo : lo + W]
        ref0 = rev[:, lo + 1 : lo + 1 + W]
        hlo = nh - 1 - (d + R + 2)
        hcol = hrev[:, hlo : hlo + W]
        in_range = (rr >= 1) & (c >= 1)
        match = (call1 == ref1) & (ref1 < 4)
        prev_match = (call0 == ref0) & (ref0 < 4)
        q_ms_s, q_ms_t, q_del_s, _, q_ins_s, _ = p2
        p_ms_s, _, p_del_s, p_del_t, p_ins_s, p_ins_t = p1
        # --- MS from (r-1, c-1) ---
        s_diag = _shift_row(q_ms_s)
        s_del = _shift_row(q_del_s)
        s_ins = _shift_row(q_ins_s)
        streak = _shift_row(q_ms_t)
        m_sMS = torch.where(
            match,
            s_diag + torch.where(prev_match, C.POINTS_MATCH2, C.POINTS_MATCH),
            torch.where(
                (ref1 < 4) & (call1 < 4),
                s_diag + torch.where(
                    prev_match,
                    torch.where(streak <= 1, C.POINTS_SUBR, C.POINTS_SUB),
                    _sub_array_cost(streak),
                ),
                s_diag + C.POINTS_NOCALL,
            ),
        )
        m_sD = s_del + torch.where(match, C.POINTS_MATCH, C.POINTS_SUB)
        m_sI = s_ins + torch.where(match, C.POINTS_MATCH, C.POINTS_SUB)
        pick_ms = (m_sMS >= m_sD) & (m_sMS >= m_sI)
        pick_d = ~pick_ms & (m_sD >= m_sI)
        ms_score = torch.where(pick_ms, m_sMS, torch.where(pick_d, m_sD, m_sI))
        ms_time = torch.where(
            pick_ms,
            torch.where(
                match,
                torch.where(prev_match, streak + 1, 1),
                torch.where(prev_match, 1, streak + 1),
            ),
            1,
        )
        # --- DEL from (r, c-1) ---
        refn_pen = torch.where(ref1 >= 4, C.POINTS_DEL_REF_N, 0)
        d_sMS = p_ms_s + C.POINTS_DEL + refn_pen
        d_sD = p_del_s + _del_ext_cost(p_del_t) + refn_pen
        d_pick = d_sMS >= d_sD
        del_score = torch.where(d_pick, d_sMS, d_sD)
        del_time = torch.where(d_pick, 1, p_del_t + 1)
        # --- INS from (r-1, c) ---
        i_ms = _shift_row(p_ms_s)
        i_ins = _shift_row(p_ins_s)
        i_streak = _shift_row(p_ins_t)
        i_sMS = i_ms + C.POINTS_INS
        i_sI = i_ins + _ins_array_cost(i_streak)
        i_pick = i_sMS >= i_sI
        ins_score = torch.where(i_pick, i_sMS, i_sI)
        ins_time = torch.where(i_pick, 1, i_streak + 1)
        if traceback:
            ms_prev = torch.where(pick_ms, 0, torch.where(pick_d, 1, 2))
            planes[d - 2] = (ms_prev + torch.where(d_pick, 0, 4)
                             + torch.where(i_pick, 0, 32)).to(torch.uint8)
        # --- gates and pruning ---
        ins_barrier = (ins_lo & (c > 1)) | (ins_hi & (c < cols - 1))
        if prune:
            limit = torch.maximum(vert, hcol)
            limit3 = torch.maximum(fl, torch.where(match, limit - C.POINTS_MATCH2,
                                                   limit - C.POINTS_SUB3))
            del_needed = (rr - c - 1).clamp(min=0)
            ins_needed = ((rows - rr) - (cols - c) - 1).clamp(min=0)
            del_pen = _calc_del_score(del_needed)
            ins_pen = _calc_ins_score(ins_needed, cum_ins)
            ms_dead = (s_diag <= limit3) & (s_del <= limit3) & (s_ins <= limit3)
            ms_limit2 = torch.where(del_needed > 0, limit - del_pen,
                                    torch.where(ins_needed > 0, limit - ins_pen, limit))
            ms_score = torch.where(ms_dead | (ms_score < ms_limit2), sf, ms_score)
            ms_time = torch.where(ms_dead, 0, ms_time)
            del_dead = ((p_ms_s <= limit) & (p_del_s <= limit)) | del_barrier
            del_limit2 = torch.where(
                ins_needed > 0, limit - ins_pen,
                torch.where(del_needed > 0,
                            limit - _calc_del_score(del_time + del_needed)
                            + _calc_del_score(del_time),
                            limit))
            del_score = torch.where(del_dead | (del_score < del_limit2), sf, del_score)
            del_time = torch.where(del_dead, 0, del_time)
            ins_dead = ((i_ms <= limit) & (i_ins <= limit)) | ins_barrier
            ins_limit2 = torch.where(
                del_needed > 0, limit - del_pen,
                torch.where(ins_needed > 0,
                            limit - _calc_ins_score(ins_time + ins_needed, cum_ins)
                            + _calc_ins_score(ins_time, cum_ins),
                            limit))
            ins_score = torch.where(ins_dead | (ins_score < ins_limit2), sf, ins_score)
            ins_time = torch.where(ins_dead, 0, ins_time)
        else:
            del_score = torch.where(del_barrier, sf, del_score)
            del_time = torch.where(del_barrier, 0, del_time)
            ins_score = torch.where(ins_barrier, sf, ins_score)
            ins_time = torch.where(ins_barrier, 0, ins_time)
        # --- time clamp, boundary ---
        clamp = C.MAX_TIME - C.MASK5
        ms_time = torch.where(ms_time > C.MAX_TIME, clamp, ms_time)
        del_time = torch.where(del_time > C.MAX_TIME, clamp, del_time)
        ins_time = torch.where(ins_time > C.MAX_TIME, clamp, ins_time)
        bnd = torch.where(c == 0, col0, torch.where(rr == 0, 0, NEG_BIG))
        out = []
        for v, b in ((ms_score, bnd), (ms_time, 0), (del_score, bnd),
                     (del_time, 0), (ins_score, bnd), (ins_time, 0)):
            out.append(torch.where(in_range, v, b).to(i32))
        # --- final-row capture: r == len, 1 <= c <= ref_len, strict > ---
        fin_c = d - rows[:, 0]
        valid = (fin_c >= 1) & (fin_c <= cols[:, 0])
        for st, plane in enumerate(out[0::2]):
            fs = plane.gather(1, fin_row)[:, 0]
            cand = valid & (fs > best_s[st])
            best_s[st] = torch.where(cand, fs, best_s[st])
            best_c[st] = torch.where(cand, fin_c, best_c[st])
        p2, p1 = p1, tuple(out)
    # combine states in state-major order with strict >
    bs, bc = best_s[0], best_c[0]
    bst = torch.where(bc >= 0, 0, -1).to(i32)
    for st in (1, 2):
        take = best_s[st] > bs
        bs = torch.where(take, best_s[st], bs)
        bc = torch.where(take, best_c[st], bc)
        bst = torch.where(take, st, bst).to(i32)
    return bs, bc, bst, planes


def msa_fill_tb(reads, read_lens, refs, ref_lens, min_score, prune=True, device="cuda"):
    """The fill with traceback planes on `device` (cuda by default), all
    tasks in one call: (max_score, max_col, max_state, planes) tensors on
    the device, planes uint8 [R'+Cc-1, B, R'+1] over reads[:, :R'] (R' the
    longest read). With prune, fillLimitedX with traceback: on every live
    cell (0 <= r <= len, 0 <= c <= Cc; `ops.msa_fill.live_cells`) equal to
    bbtools_tpu/ops/msa.py `msa_fill(R, Cc, True, True, ...)`. The planes
    take (R'+Cc-1)(R'+1) bytes a task: a caller past
    `ops.msa_fill.plane_budget` groups its tasks, as `msa_fill_batch`
    does."""
    dev = resolve_device(str(device))
    return _fill_scores(*_fill_inputs(reads, read_lens, refs, ref_lens, min_score, prune, dev),
                        prune, traceback=True)


def _fill_inputs(reads, read_lens, refs, ref_lens, min_score, prune, dev):
    """The host limits and the tensors of one fill call on `dev`: reads
    trimmed to R' rows, limits int32."""
    reads = np.asarray(reads, np.uint8)
    refs = np.asarray(refs, np.uint8)
    read_lens = np.asarray(read_lens)
    ref_lens = np.asarray(ref_lens)
    B, R = reads.shape
    if prune:
        ms = np.asarray(min_score, dtype=np.int64) - C.MIN_SCORE_ADJUST
    else:
        ms = np.zeros(B, dtype=np.int64)
    vert, horiz, floor, subfloor = prepare_limits_np(reads, read_lens, refs, ref_lens, ms)
    if not prune:
        maxgain = (read_lens.astype(np.int64) - 1) * C.POINTS_MATCH2 + C.POINTS_MATCH
        subfloor = -2 * maxgain
    Rp = max(1, min(R, int(read_lens.max()))) if B else R

    def t(x, dtype=np.int32):
        return torch.as_tensor(np.ascontiguousarray(x, dtype), device=dev)

    return (t(reads[:, :Rp], np.uint8), t(read_lens), t(refs, np.uint8), t(ref_lens),
            t(vert[:, : Rp + 1]), t(horiz), t(floor), t(subfloor))


def msa_fill_batch(reads, read_lens, refs, ref_lens, min_score, prune=True,
                   device="cuda", traceback=False):
    """The fill on `device` (cuda by default): the limits on the host,
    then the wavefront over reads[:, :R'] (R' the longest read; rows past
    it feed no final-row cell).

    min_score: int array [B] (raw, before MIN_SCORE_ADJUST) for prune mode.
    Per-task dispatch to unlimited happens on the host (reference :137).
    Returns (max_score, max_col, max_state) int32 numpy arrays; tasks where
    prune mode found nothing get max_score < min_score (caller filters).
    With traceback, also the walk over the fill's planes (`msa_fill_tb`,
    then `msa_walk`): (..., ops uint8 [B, R'+Cc], steps int32 [B]), the
    tasks filled and walked in the groups of `ops.msa_fill.fill_groups`
    under `plane_budget`, which change no output.
    """
    dev = resolve_device(str(device))
    if dev.type == "cuda":
        msa_fill_batch.device_calls += 1
    if not traceback:
        out = _fill_scores(*_fill_inputs(reads, read_lens, refs, ref_lens, min_score, prune,
                                         dev), prune)[:3]
        return tuple(x.cpu().numpy() for x in out)
    from .msa_fill import fill_groups, plane_budget, task_bytes, trimmed_rows

    reads, read_lens, refs, ref_lens, min_score = (
        np.asarray(x) for x in (reads, read_lens, refs, ref_lens, min_score))
    B, Cc = len(reads), refs.shape[1]
    Rp = trimmed_rows(reads, read_lens)
    parts = []
    groups = fill_groups(B, Rp, Cc, plane_budget(dev, B * task_bytes(Rp, Cc)))
    for g in groups or [slice(0, 0)]:
        bs, bc, bst, planes = msa_fill_tb(reads[g], read_lens[g], refs[g], ref_lens[g],
                                          min_score[g], prune=prune, device=dev)
        ops, steps = msa_walk(planes.shape[2] - 1, Cc, planes,
                              torch.as_tensor(read_lens[g], device=dev), bc, bst)
        del planes
        # one width across the groups: a walk's row reads 0 past its end
        ops = F.pad(ops, (0, Rp + Cc - ops.shape[1]))
        parts.append([x.cpu().numpy() for x in (bs, bc, bst, ops, steps)])
    return tuple(np.concatenate(x) for x in zip(*parts))


#: calls on CUDA since the count was last set to 0
msa_fill_batch.device_calls = 0
