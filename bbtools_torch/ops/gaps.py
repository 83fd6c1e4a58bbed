"""Gap-array utilities for giant-indel ("gapped") alignment sites.

Reference: align2/GapTools.java. A gap array is an even-length int list
[start0, stop0, start1, stop1, ...] of flat reference coordinates:
consecutive pairs are ALIGNED blocks; the space between stop_i and
start_{i+1} is a giant deletion (an intron-scale ref skip). The
reference compresses such gaps to GAPC symbols (GAPLEN ref bases each,
Shared.java:194-204) so its single DP arena can span them; the TPU
design instead aligns each anchor block in its own fixed window and
stitches (models/bbmap.py _stitch_gapped), so here the gap arrays only
describe sites — no compressed-ref buffer exists to size.
"""

from __future__ import annotations

GAPBUFFER = 64  # Shared.java:194 — ungapped context kept on each side
GAPBUFFER2 = 2 * GAPBUFFER
GAPLEN = 128  # Shared.java:198 — ref bases per compression symbol
MINGAP = GAPBUFFER2 + GAPLEN  # smallest span worth compressing


def gaps_to_string(gaps) -> str | None:
    """Tilde-joined coordinate list (GapTools.toString)."""
    if gaps is None:
        return None
    return "~".join(str(g) for g in gaps)


def calc_num_gap_symbols(a: int, b: int) -> int:
    """Symbols needed to compress span (a, b) (GapTools
    calcNumGapSymbols): the GAPBUFFER2 context stays literal, the rest
    packs GAPLEN-per-symbol."""
    assert b > a
    return max(0, (b - a - GAPBUFFER2) // GAPLEN)


def calc_gap_len(a: int, b: int) -> int:
    """Compressed length of span (a, b) (GapTools.calcGapLen): literal
    below MINGAP, else GAPBUFFER2 + div GAPLEN symbols + remainder."""
    assert b > a
    gap = b - a
    if gap < MINGAP:
        return gap
    gap -= GAPBUFFER2
    return GAPBUFFER2 + gap // GAPLEN + gap % GAPLEN


def calc_gref_len(a: int, b: int, gaps) -> int:
    """Reference span length after gap compression (GapTools
    calcGrefLen): total minus (GAPLEN-1) per symbol."""
    total = b - a + 1
    if gaps is None:
        return total
    for i in range(2, len(gaps), 2):
        total -= calc_num_gap_symbols(gaps[i - 1], gaps[i]) * (GAPLEN - 1)
    return total


def fix_gaps(a: int, b: int, gaps, min_gap: int = MINGAP):
    """Normalize a gap array to the site bounds [a, b] (GapTools.fixGaps):
    clamp all coordinates into [a, b], pin the first/last to the bounds,
    enforce monotonic ordering, then drop degenerate blocks and MERGE
    blocks separated by less than min_gap (such a span is cheaper aligned
    literally than as a compressed gap). Returns None when no real gap
    survives (the site is effectively ungapped)."""
    assert b > a
    if gaps is None:
        return None
    assert len(gaps) >= 4 and len(gaps) % 2 == 0
    if gaps[0] > b or gaps[-1] < a:  # no overlap with the site at all
        return None
    g = [min(max(int(x), a), b) for x in gaps]
    g[0], g[-1] = a, b
    for i in range(1, len(g)):
        if g[i - 1] > g[i]:
            g[i] = g[i - 1]
    # merge: walk blocks, joining any whose separating gap is < min_gap
    blocks = [[g[0], g[1]]]
    for i in range(2, len(g), 2):
        s, e = g[i], g[i + 1]
        if s - blocks[-1][1] < min_gap:
            blocks[-1][1] = max(blocks[-1][1], e)
        else:
            blocks.append([s, e])
    blocks = [blk for blk in blocks if blk[1] > blk[0] or len(blocks) == 1]
    if len(blocks) < 2:
        return None
    out = []
    for blk in blocks:
        out.extend(blk)
    out[0], out[-1] = a, b
    return out
