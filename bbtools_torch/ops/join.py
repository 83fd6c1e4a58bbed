"""Paired-read joining — exact Read.joinRead semantics, batched.

stream/Read.java:3744-3850 (SURVEY.md Appendix A.5): copy read A into the
result, then overlay read B back-to-front; at overlap positions:
  - A undefined -> take B's base/qual
  - B undefined -> keep A
  - agree  -> q = min(max(qa,qb) + min(qa,qb)/4, MAX_MERGE_QUALITY=50)
  - differ -> base of the higher-q read (tie -> N), q = qmax - qmin
No-overlap inserts (insert >= alen+blen) fill the gap with N/q0.

Vectorized: B's overlay is computed per output position from index
arithmetic; the back-to-front loop order only matters through which source
wins at each position, which is position-wise independent.
"""

from __future__ import annotations

import numpy as np

MAX_MERGE_QUALITY = 50


def join_reads_np(a, aq, alens, b_rc, bq_rev, blens, insert, out_len: int):
    """Join pairs; b_rc is r2 reverse-complemented (codes), bq_rev its
    reversed quals. Returns (bases [B, out_len], quals, lengths)."""
    B, L = a.shape
    insert = np.asarray(insert, dtype=np.int64)
    out = np.full((B, out_len), 4, dtype=np.uint8)
    outq = np.zeros((B, out_len), dtype=np.uint8)
    rows = np.arange(B)[:, None]
    pos = np.arange(out_len, dtype=np.int64)[None, :]
    # A contribution: positions < min(alen, insert)
    a_src = np.minimum(pos, L - 1)
    a_live = (pos < alens[:, None]) & (pos < insert[:, None])
    ca = np.where(a_live, a[rows, a_src], 4).astype(np.uint8)
    qa = np.where(a_live, aq[rows, a_src], 0).astype(np.uint8)
    # B contribution: output position p maps to b index j = p-(insert-blen)
    j = pos - (insert - blens)[:, None]
    b_live = (j >= 0) & (j < blens[:, None]) & (pos < insert[:, None])
    jj = np.clip(j, 0, L - 1)
    cb = np.where(b_live, b_rc[rows, jj], 4).astype(np.uint8)
    qb = np.where(b_live, bq_rev[rows, jj], 0).astype(np.uint8)
    # overlay resolution (overlay loop :3828-3847): start from A verbatim
    # (N and its qual included), then B overwrites where it covers and A is
    # absent or undefined; both-defined positions use the agree/differ rules
    qa_i = qa.astype(np.int32)
    qb_i = qb.astype(np.int32)
    a_undef = ca >= 4
    b_undef = cb >= 4
    out_base = np.where(a_live, ca, np.uint8(4))
    out_q = np.where(a_live, qa_i, 0)
    take_b = b_live & (~a_live | a_undef)
    out_base = np.where(take_b, cb, out_base)
    out_q = np.where(take_b, qb_i, out_q)
    both = a_live & b_live & ~a_undef & ~b_undef
    agree = both & (ca == cb)
    differ = both & (ca != cb)
    out_q = np.where(
        agree,
        np.minimum(
            np.maximum(qa_i, qb_i) + np.minimum(qa_i, qb_i) // 4,
            MAX_MERGE_QUALITY,
        ),
        out_q,
    )
    out_base = np.where(
        differ,
        np.where(qa_i > qb_i, ca, np.where(qa_i < qb_i, cb, np.uint8(4))),
        out_base,
    )
    out_q = np.where(differ, np.maximum(qa_i, qb_i) - np.minimum(qa_i, qb_i), out_q)
    live = pos < insert[:, None]
    out[live] = out_base[live]
    outq[live] = out_q[live].astype(np.uint8)
    return out, outq, insert.astype(np.int32)
