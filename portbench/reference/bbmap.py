"""Plain NumPy and PyTorch reference of BBMap's single-end answer for a read at its
true locus: the MultiStateAligner11ts alignment (fillUnlimited and
traceback2, read-global and free in the reference) over a window around
the read's true origin, its SAM position and CIGAR (=/X), and the map
score after the tip penalty (AbstractMapThread.calcTipScorePenalty).

Written from BBTools' loops (align2/MultiStateAligner11ts.java :643-860,
:1167-1266 and its constants :2493-2566; AbstractMapThread :2895),
the fill in plain torch ops with a lane a read (on the card once the
benchmark's window has closed, on the CPU in tests). It takes the genome and the reads as
the benchmark made them and the truth the benchmark kept, and nothing
that the program built. Imports nothing of the program.

BBMap's rules for the site are kept: the ungapped alignment at the
read's origin (scored by scoreNoIndels) is the answer when its score
leaves no room for an indel, or when the fill does not beat it. The
answer assumes one locus per read: a random genome has no repeats, so no
runner-up site comes near enough to change the score.
"""

from __future__ import annotations

import numpy as np
import torch

POINTS_MATCH, POINTS_MATCH2 = 70, 100
POINTS_SUB, POINTS_SUBR, POINTS_SUB2, POINTS_SUB3 = -127, -147, -51, -25
POINTS_NOCALL = 0
POINTS_INS, POINTS_INS2, POINTS_INS3, POINTS_INS4 = -395, -39, -23, -8
POINTS_DEL, POINTS_DEL2, POINTS_DEL3, POINTS_DEL4, POINTS_DEL5 = -472, -33, -9, -1, -1
POINTS_DEL_REF_N = -10
LIMIT3, LIMIT4, LIMIT5 = 5, 20, 80
MAX_TIME = (1 << 11) - 1
MASK5 = 3
BARRIER_I1, BARRIER_D1 = 2, 3
MS, DEL, INS = 0, 1, 2


def _cost_arrays():
    ins = np.zeros(604, np.int64)
    sub = np.zeros(604, np.int64)
    for i in range(1, 604):
        ins[i] = POINTS_INS4 if i > LIMIT4 else POINTS_INS3 if i > LIMIT3 else POINTS_INS2 if i > 1 else POINTS_INS
        sub[i] = POINTS_SUB3 if i > LIMIT3 else POINTS_SUB2 if i > 1 else POINTS_SUB
    return ins, sub


INS_ARR, SUB_ARR = _cost_arrays()


def max_quality(n: int) -> int:
    return POINTS_MATCH + (n - 1) * POINTS_MATCH2


def _del_ext(streak: np.ndarray) -> np.ndarray:
    return np.where(streak == 0, POINTS_DEL,
                    np.where(streak < LIMIT3, POINTS_DEL2,
                             np.where(streak < LIMIT4, POINTS_DEL3,
                                      np.where(streak < LIMIT5, POINTS_DEL4,
                                               np.where((streak & MASK5) == 0, POINTS_DEL5, 0)))))


#: the cost of extending a deletion by the length of its streak so far
DEL_EXT = _del_ext(np.arange(MAX_TIME + 1))


def fill(reads: np.ndarray, refs: np.ndarray, device: str = "cpu"):
    """fillUnlimited over n tasks of equal shape: reads [n, R], windows
    [n, C] (codes, >= 4 is N), in plain torch ops on `device`, every
    task a lane. Returns score and time [3, R+1, C+1, n] (int32)."""
    n, R = reads.shape
    C = refs.shape[1]
    dev = torch.device(device)
    score = torch.zeros((3, R + 1, C + 1, n), dtype=torch.int32, device=dev)
    time = torch.zeros_like(score)
    col0 = np.zeros(R + 1, np.int64)
    for i in range(R + 1):
        col0[i] = (0 if i < 2 else col0[i - 1]) + INS_ARR[min(i, 603)]
    score[:, :, 0, :] = torch.as_tensor(col0, device=dev)[None, :, None].to(torch.int32)
    maxgain = (R - 1) * POINTS_MATCH2 + POINTS_MATCH
    subfloor = -2 * maxgain
    B_I2, B_I2b, B_D2 = R - BARRIER_I1, C - 1, R - BARRIER_D1
    ins_arr, sub_arr, del_ext = (torch.as_tensor(x, dtype=torch.int64, device=dev)
                                 for x in (INS_ARR, SUB_ARR, DEL_EXT))
    refT = torch.as_tensor(np.ascontiguousarray(refs.T), dtype=torch.int64, device=dev)  # [C, n]
    calls = torch.as_tensor(np.ascontiguousarray(reads.T), dtype=torch.int64, device=dev)  # [R, n]
    ref_ok = refT < 4
    nref, ref_all = ~ref_ok, ref_ok.all(dim=1).tolist()
    cols = torch.arange(1, C + 1, device=dev)[:, None]
    for row in range(1, R + 1):
        call = calls[row - 1][None, :]
        match = (call == refT) & ref_ok
        prev = torch.zeros_like(match)
        if row >= 2:
            prev[1:] = ((calls[row - 2][None, :] == refT) & ref_ok)[:-1]
        s_d = score[MS, row - 1, :-1]
        s_del = score[DEL, row - 1, :-1]
        s_ins = score[INS, row - 1, :-1]
        streak = time[MS, row - 1, :-1].long()
        both = ref_ok & (call < 4)
        sub_pts = torch.where(prev, torch.where(streak <= 1, POINTS_SUBR, POINTS_SUB),
                              sub_arr[torch.clamp(streak + 1, max=603)])
        sMS = s_d + torch.where(match, torch.where(prev, POINTS_MATCH2, POINTS_MATCH),
                                torch.where(both, sub_pts, POINTS_NOCALL))
        step = torch.where(match, POINTS_MATCH, POINTS_SUB)
        sD = s_del + step
        sI = s_ins + step
        pick_ms = (sMS >= sD) & (sMS >= sI)
        tm_ms = torch.where(match, torch.where(prev, streak + 1, 1), torch.where(prev, 1, streak + 1))
        sc = torch.where(pick_ms, sMS, torch.where(sD >= sI, sD, sI))
        tm = torch.where(pick_ms, tm_ms, 1)
        score[MS, row, 1:] = sc.to(torch.int32)
        time[MS, row, 1:] = torch.where(tm > MAX_TIME, MAX_TIME - MASK5, tm).to(torch.int32)
        # insertions: from the row above, same column
        barrier = torch.zeros_like(cols, dtype=torch.bool)
        if row < BARRIER_I1:
            barrier |= cols > 1
        if row > B_I2:
            barrier |= cols < B_I2b
        st = time[INS, row - 1, 1:].long()
        a = score[MS, row - 1, 1:] + int(INS_ARR[1])
        b = score[INS, row - 1, 1:] + ins_arr[torch.clamp(st + 1, max=603)]
        sc = torch.where(a >= b, a, b)
        tm = torch.where(a >= b, 1, st + 1)
        tm = torch.where(tm > MAX_TIME, MAX_TIME - MASK5, tm)
        score[INS, row, 1:] = torch.where(barrier, subfloor, sc).to(torch.int32)
        time[INS, row, 1:] = torch.where(barrier, 0, tm).to(torch.int32)
        # deletions: along the row
        if row < BARRIER_D1 or row > B_D2:
            score[DEL, row, 1:] = subfloor
            time[DEL, row, 1:] = 0
            continue
        s_prev, t_prev = score[DEL, row, 0].long(), time[DEL, row, 0].long()
        ms_row = score[MS, row].long()
        d_s = torch.empty((C, n), dtype=torch.int64, device=dev)
        d_t = torch.empty_like(d_s)
        for col in range(1, C + 1):
            a = ms_row[col - 1] + POINTS_DEL
            b = s_prev + del_ext[t_prev]
            if not ref_all[col - 1]:
                a = torch.where(nref[col - 1], a + POINTS_DEL_REF_N, a)
                b = torch.where(nref[col - 1], b + POINTS_DEL_REF_N, b)
            s_prev = torch.maximum(a, b)
            t_prev = torch.where(a >= b, 1, t_prev + 1)
            t_prev = torch.where(t_prev > MAX_TIME, MAX_TIME - MASK5, t_prev)
            d_s[col - 1], d_t[col - 1] = s_prev, t_prev
        score[DEL, row, 1:], time[DEL, row, 1:] = d_s.to(torch.int32), d_t.to(torch.int32)
    return score, time


def traceback(score, time, read, ref, row, col, state) -> bytes:
    """traceback2 on one task's matrices [3, R+1, C+1]."""
    out = []
    C = score.shape[2] - 1
    while row > 0 and col > 0:
        t = time[state, row, col]
        if state == MS:
            if t > 1:
                prev = state
            else:
                sd, sD, sI = score[MS, row - 1, col - 1], score[DEL, row - 1, col - 1], score[INS, row - 1, col - 1]
                prev = MS if (sd >= sD and sd >= sI) else (DEL if sD >= sI else INS)
            c, r = read[row - 1], ref[col - 1]
            out.append(ord("m") if c == r else ord("N") if (c >= 4 or r >= 4) else ord("S"))
            row -= 1
            col -= 1
        elif state == DEL:
            if t > 1:
                prev = state
            else:
                prev = MS if score[MS, row, col - 1] >= score[DEL, row, col - 1] else DEL
            out.append(ord("D"))
            col -= 1
        else:
            if t > 1:
                prev = state
            else:
                prev = MS if score[MS, row - 1, col] >= score[INS, row - 1, col] else INS
            out.append(ord("X") if col == 0 else ord("Y") if col >= C else ord("I"))
            row -= 1
        state = prev
    if col != row:
        while row > 0:
            out.append(ord("X"))
            row -= 1
            col -= 1
    return bytes(out[::-1])


def cigar14(match: bytes) -> str:
    """SAM 1.4 CIGAR of a match string that lies inside the reference."""
    ops = {ord("m"): "=", ord("S"): "X", ord("N"): "M", ord("D"): "D",
           ord("I"): "I", ord("X"): "I", ord("Y"): "I"}
    out, last, count = [], None, 0
    for m in match:
        op = ops[m]
        if op != last and count:
            out.append(f"{count}{last}")
            count = 0
        last = op
        count += 1
    out.append(f"{count}{last}")
    return "".join(out)


def tip_penalty(match: bytes, bases: np.ndarray, max_score: int, map_score: int,
                tiplen: int = 7) -> int:
    """calcTipScorePenalty: errors near either end of the alignment,
    weighted by how near, and homopolymer runs at the read's tips."""
    if not match or len(bases) < 2 * tiplen:
        return 0
    points = 0
    for order in (range(len(match)), range(len(match) - 1, -1, -1)):
        prev, cpos = ord("m"), 0
        for i in order:
            if cpos > tiplen:
                break
            b = match[i]
            if b == ord("m"):
                cpos += 1
            elif b == ord("D"):
                if prev != ord("D"):
                    points += 2 * (tiplen + 2 - cpos)
            elif b in (ord("N"), ord("C"), ord("R")):
                points += tiplen + 2 - cpos
                cpos += 1
            else:
                points += 2 * (tiplen + 2 - cpos)
                cpos += 1
            prev = b
    last = len(bases) - 1
    b0 = bases[0]
    if b0 != 4 and b0 == bases[1]:
        i = 2
        while i <= tiplen and bases[i] == b0:
            points += 1
            i += 1
    b0 = bases[last]
    if b0 != 4 and b0 == bases[last - 1]:
        i = last - 2
        while i >= last - tiplen and bases[i] == b0:
            points += 1
            i -= 1
    if points < 1:
        return 0
    f = (80.0 * points) / (points + 80.0)
    penalty = int(f * 0.0022 * max_score)
    cap = map_score - max_score // 10
    if cap <= 0:
        return 0
    return min(penalty, cap)


def ungapped_score(read: np.ndarray, ref: np.ndarray) -> int:
    """scoreNoIndels (MultiStateAligner11ts :960-1030): the read laid on
    `ref` without indels, a match +70 or +100 in a run of matches, a
    substitution by the cost array at its place in a run of them, an N
    nothing."""
    s, mode, tim = 0, -1, 0
    for c, r in zip(read.tolist(), ref.tolist()):
        if c == r and c < 4:
            tim = tim + 1 if mode == 0 else 0
            s += POINTS_MATCH2 if mode == 0 else POINTS_MATCH
            mode = 0
        elif c < 4 and r < 4:
            tim = tim + 1 if mode == 1 else 0
            s += SUB_ARR[tim + 1]
            mode = 1
    return s


def expected(genome: np.ndarray, reads: np.ndarray, start: np.ndarray, strand: np.ndarray,
             pad: int, extra, device: str = "cpu", chunk: int = 4096):
    """BBMap's answer for each read: (flag, pos 1-based, cigar, AS).
    reads [n, R] as sequenced; start the 0-based forward origin; the
    window runs from start - pad over R + extra + 2 * pad bases, `extra`
    one number or one a read (the longest deletion it may hold). The
    fill runs on `device`, `chunk` reads at a time."""
    n, R = reads.shape
    extra = np.broadcast_to(np.asarray(extra, np.int64), (n,))
    aligned = np.where(strand[:, None] == 1, np.where(reads[:, ::-1] < 4, 3 - reads[:, ::-1], 4),
                       reads).astype(np.uint8)
    w0 = start.astype(np.int64) - pad
    maxq = max_quality(R)
    # an indel costs at least this much, so above it the fill cannot win
    # and BBMap does not run it (maxImperfectScore)
    imperfect = maxq + min(POINTS_DEL, POINTS_INS - POINTS_MATCH2)
    answer = []
    for i in range(n):
        win = genome[w0[i] + pad:w0[i] + pad + R]
        ug = ungapped_score(aligned[i], win)
        m = bytes(np.where(aligned[i] == win, ord("m"), ord("S")).astype(np.uint8))
        answer.append((ug, pad, m))
    need = np.asarray([i for i in range(n) if answer[i][0] <= imperfect], np.int64)
    for C in np.unique(R + extra[need] + 2 * pad).tolist():
        same = need[R + extra[need] + 2 * pad == C]
        for c0 in range(0, len(same), chunk):
            sel = same[c0:c0 + chunk]
            idx = np.clip(w0[sel, None] + np.arange(C)[None, :], 0, len(genome) - 1)
            wins = genome[idx]
            score, time = fill(aligned[sel], wins, device)
            flat = score[:, R, 1:, :].reshape(3 * C, -1)
            best = flat.argmax(dim=0)  # the first of equal maxima, as np.argmax
            top = flat.gather(0, best[None, :])[0].cpu().numpy()
            best = best.cpu().numpy()
            wins_at = [j for j, i in enumerate(sel.tolist()) if int(top[j]) > answer[i][0]]
            for p0 in range(0, len(wins_at), 256):
                part = wins_at[p0:p0 + 256]
                pick = torch.as_tensor(part, dtype=torch.int64, device=score.device)
                sp = score[..., pick].permute(3, 0, 1, 2).cpu().numpy()
                tp = time[..., pick].permute(3, 0, 1, 2).cpu().numpy()
                for q, j in enumerate(part):
                    i = int(sel[j])
                    state, col = divmod(int(best[j]), C)
                    m = traceback(sp[q], tp[q], aligned[i], wins[j], R, col + 1, state)
                    ndiag = sum(m.count(x) for x in (b"m", b"S", b"N", b"D"))
                    answer[i] = (int(top[j]), col + 1 - ndiag, m)
            del score, time
    out = []
    for i, (sc, first, m) in enumerate(answer):
        sc -= tip_penalty(m, aligned[i], maxq, sc)
        out.append((16 if strand[i] else 0, int(w0[i] + first + 1), cigar14(m), sc))
    return out
