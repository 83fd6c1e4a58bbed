"""Which read pairs two FASTQ outputs disagree on.

BBMerge's nn=t gate compares a float32 net score with a cutoff. Two
devices, or two libraries, sum the net's float32 matmuls in different
orders, so a pair whose score lies within a few ulps of the cutoff may
be merged in one run and ambiguous in the other. `differing_names` names
the reads whose records differ, so a comparison can hold them to the
pairs whose score lay that close (`BBMerge.nn_near`) and allow nothing
else.
"""

from __future__ import annotations

from collections import defaultdict


def _records(fq: bytes) -> dict:
    """read name (the header's first token, without '@') -> its sorted
    4-line records."""
    lines = fq.split(b"\n")
    out = defaultdict(list)
    for i in range(0, len(lines) - 3, 4):
        out[lines[i][1:].split()[0]].append(b"\n".join(lines[i : i + 4]))
    return {k: sorted(v) for k, v in out.items()}


def differing_names(a: bytes, b: bytes) -> set:
    """Names of the reads whose records in FASTQ a and b differ, or that
    only one of them holds."""
    ra, rb = _records(a), _records(b)
    return {n for n in ra.keys() | rb.keys() if ra.get(n) != rb.get(n)}
