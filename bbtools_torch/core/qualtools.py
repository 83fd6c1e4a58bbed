"""Phred quality <-> probability tables.

The reference uses lookup tables, not formulas, in hot paths — copy the
table *definitions* exactly (align2/QualityTools.java:688-698 makeQualityToFloat,
phredToProbError :650-654) because downstream float32 arithmetic must agree
bit-for-bit:

  PROB_ERROR[q] = float32(10 ** (-q/10)),  PROB_ERROR[0]=0.75, [1]=0.7
  phredToProbError(q) = 0.75 (q<=0); 0.75-0.05q (q<=1); min(0.7, 10^(-q/10))
"""

from __future__ import annotations

import numpy as np

#: float32[128], indexed by phred score
PROB_ERROR = np.power(10.0, -0.1 * np.arange(128)).astype(np.float32)
PROB_ERROR[0] = np.float32(0.75)
PROB_ERROR[1] = np.float32(0.7)

PROB_CORRECT = (np.float64(1.0) - PROB_ERROR).astype(np.float32)


def phred_to_prob_error(q: float) -> float:
    """Scalar double-precision version used for trimq -> avgErrorRate."""
    if q <= 0:
        return 0.75
    if q <= 1:
        return 0.75 - q * 0.05
    return min(0.7, 10.0 ** (-0.1 * q))


def prob_error_to_phred(prob: float, round_result: bool = True) -> int:
    """Inverse mapping, clamped to [0, 50] like QualityTools."""
    if prob >= 0.75:
        return 0
    q = -10.0 * np.log10(max(prob, 1e-9))
    return int(round(q)) if round_result else int(q)
