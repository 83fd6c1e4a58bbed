"""MultiStateAligner11ts scoring constants — transcribed verbatim.

Source: align2/MultiStateAligner11ts.java:2493-2566 (packed-cell layout,
score constants, streak cost arrays) and :2358-2430 (cumulative penalty
formulas). These constants ARE the reference's alignment semantics
(SURVEY.md §7.3); scores here are kept UNSHIFTED (the Java code works on
score<<11 "offset" values, but all comparisons and sums are shift-
invariant, so plain int32 scores give identical decisions).
"""

from __future__ import annotations

import numpy as np

TIMEBITS = 11
SCOREBITS = 32 - TIMEBITS
MAX_TIME = (1 << TIMEBITS) - 1
MAX_SCORE = ((1 << (SCOREBITS - 1)) - 1) - 2000
MIN_SCORE = -MAX_SCORE
BAD = MIN_SCORE - 1

POINTS_NOREF = 0
POINTS_NOCALL = 0
POINTS_MATCH = 70
POINTS_MATCH2 = 100
POINTS_COMPATIBLE = 50
POINTS_SUB = -127
POINTS_SUBR = -147
POINTS_SUB2 = -51
POINTS_SUB3 = -25
POINTS_MATCHSUB = -10
POINTS_INS = -395
POINTS_INS2 = -39
POINTS_INS3 = -23
POINTS_INS4 = -8
POINTS_DEL = -472
POINTS_DEL2 = -33
POINTS_DEL3 = -9
POINTS_DEL4 = -1
POINTS_DEL5 = -1
POINTS_DEL_REF_N = -10
GAPCOST = 64  # MSA.java GAPCOST (per-128-del gap symbol cost)
POINTS_GAP = -GAPCOST

TIMESLIP = 4
MASK5 = TIMESLIP - 1

BARRIER_I1 = 2
BARRIER_D1 = 3

LIMIT_FOR_COST_3 = 5
LIMIT_FOR_COST_4 = 20
LIMIT_FOR_COST_5 = 80

MIN_SCORE_ADJUST = 120  # MSA.java:1206

MODE_MS = 0
MODE_DEL = 1
MODE_INS = 2

#: POINTS_INS_ARRAY[i]: per-step insertion cost at run length i (1-based)
POINTS_INS_ARRAY = np.zeros(604, dtype=np.int32)
POINTS_INS_ARRAY_C = np.zeros(604, dtype=np.int32)
for _i in range(1, 604):
    if _i > LIMIT_FOR_COST_4:
        _p = POINTS_INS4
    elif _i > LIMIT_FOR_COST_3:
        _p = POINTS_INS3
    elif _i > 1:
        _p = POINTS_INS2
    else:
        _p = POINTS_INS
    POINTS_INS_ARRAY[_i] = _p
    POINTS_INS_ARRAY_C[_i] = max(MIN_SCORE, _p + POINTS_INS_ARRAY_C[_i - 1])

#: POINTS_SUB_ARRAY[i]: substitution cost at sub-run length i
#: (static init, MultiStateAligner11ts.java: i>LIMIT3 -> SUB3, i>1 -> SUB2,
#: else SUB)
POINTS_SUB_ARRAY = np.zeros(604, dtype=np.int32)
POINTS_SUB_ARRAY_C = np.zeros(604, dtype=np.int32)
for _i in range(1, 604):
    if _i > LIMIT_FOR_COST_3:
        _p = POINTS_SUB3
    elif _i > 1:
        _p = POINTS_SUB2
    else:
        _p = POINTS_SUB
    POINTS_SUB_ARRAY[_i] = _p
    POINTS_SUB_ARRAY_C[_i] = max(MIN_SCORE, _p + POINTS_SUB_ARRAY_C[_i - 1])


def calc_del_score(length) -> np.ndarray | int:
    """calcDelScoreOffset (:2358-2378), unshifted; vectorized-friendly."""
    length = np.asarray(length)
    score = np.where(length > 0, POINTS_DEL, 0).astype(np.int64)
    l5 = np.minimum(length, LIMIT_FOR_COST_5)
    score = score + np.where(
        length > LIMIT_FOR_COST_5,
        ((length - LIMIT_FOR_COST_5 + MASK5) // TIMESLIP) * POINTS_DEL5,
        0,
    )
    l4 = np.minimum(l5, LIMIT_FOR_COST_4)
    score = score + np.where(l5 > LIMIT_FOR_COST_4, (l5 - LIMIT_FOR_COST_4) * POINTS_DEL4, 0)
    l3 = np.minimum(l4, LIMIT_FOR_COST_3)
    score = score + np.where(l4 > LIMIT_FOR_COST_3, (l4 - LIMIT_FOR_COST_3) * POINTS_DEL3, 0)
    score = score + np.where(l3 > 1, (l3 - 1) * POINTS_DEL2, 0)
    return score


def calc_ins_score(length) -> np.ndarray | int:
    """calcInsScoreOffset via the cumulative array (:2408-2418)."""
    length = np.asarray(length)
    idx = np.clip(length, 0, 603)
    return np.where(length > 0, POINTS_INS_ARRAY_C[idx], 0)


#: per-sub-streak cost used for scoreMS when !prevMatch: SUB_ARRAY[streak+1]
def sub_cost_for_streak(streak) -> np.ndarray:
    idx = np.clip(np.asarray(streak) + 1, 1, 603)
    return POINTS_SUB_ARRAY[idx]


def ins_cost_for_streak(streak) -> np.ndarray:
    idx = np.clip(np.asarray(streak) + 1, 1, 603)
    return POINTS_INS_ARRAY[idx]


def del_cost_for_streak(streak) -> np.ndarray:
    """DEL extension cost (branch chain, MultiStateAligner11ts.java:761)."""
    streak = np.asarray(streak)
    return np.where(
        streak == 0,
        POINTS_DEL,
        np.where(
            streak < LIMIT_FOR_COST_3,
            POINTS_DEL2,
            np.where(
                streak < LIMIT_FOR_COST_4,
                POINTS_DEL3,
                np.where(
                    streak < LIMIT_FOR_COST_5,
                    POINTS_DEL4,
                    np.where((streak & MASK5) == 0, POINTS_DEL5, 0),
                ),
            ),
        ),
    )
