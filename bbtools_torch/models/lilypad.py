"""Lilypad — scaffold contigs with paired-read links.

Reference: consensus/Lilypad.java (lilypad.sh): pairs whose mates map to
DIFFERENT contigs vote for joining specific contig ends; an end accepts
its best edge when the link count >= mindepth, the best edge holds at
least `minWeightRatio` of the end's total weight (edge weight = mapq sum,
:738-749, :877), and the mates' strands are consistent. Accepted joins
are emitted as scaffolds with an N gap (`ns=` scaffoldBreakNs, :165).

End/orientation rule: a forward mate at a contig's 3' side claims that
contig's RIGHT end; a reverse mate claims the LEFT end. The partner
contig attaches by its claimed end, reverse-complemented when the two
claimed ends are both RIGHT or both LEFT.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from ..core.dna import BASE_TO_CODE, CODE_TO_BASE
from ..core.parser import tokenize
from ..io.fasta import load_reference, write_fasta
from ..io.sam_read import iter_sam

MIN_MAPQ = 4


@dataclass
class Edge:
    count: int = 0
    weight: int = 0


def _end_of(strand: int) -> int:
    """Which end of the contig this mate claims: 0=left, 1=right."""
    return 1 if strand == 0 else 0


def collect_links(sam_path: str, name_to_idx: dict):
    """(contigA, endA, contigB, endB) -> Edge, from cross-contig pairs."""
    by_name: dict[bytes, list] = {}
    edges: dict[tuple, Edge] = defaultdict(Edge)
    for rec in iter_sam(sam_path):
        if not rec.mapped or rec.secondary or rec.mapq < MIN_MAPQ:
            continue
        if not rec.flag & 0x1:
            continue
        got = by_name.pop(rec.qname, None)
        if got is None:
            by_name[rec.qname] = [rec]
            continue
        mate = got[0]
        a = name_to_idx.get(mate.rname)
        b = name_to_idx.get(rec.rname)
        if a is None or b is None or a == b:
            continue
        ea = _end_of(mate.strand)
        eb = _end_of(rec.strand)
        key = (
            (a, ea, b, eb) if (a, ea) <= (b, eb) else (b, eb, a, ea)
        )
        e = edges[key]
        e.count += 1
        e.weight += mate.mapq + rec.mapq
    return edges


def scaffold(ref, edges, min_depth=4, min_weight_ratio=0.8, gap_ns=300):
    """Greedy end-matching: best qualifying edge per end, chains walked
    into scaffolds."""
    n = ref.n_scaffolds
    # per end: total weight and best edge
    end_weight = defaultdict(int)
    for (a, ea, b, eb), e in edges.items():
        end_weight[(a, ea)] += e.weight
        end_weight[(b, eb)] += e.weight
    accepted = {}
    for (a, ea, b, eb), e in sorted(
        edges.items(), key=lambda kv: -kv[1].weight
    ):
        if e.count < min_depth:
            continue
        if e.weight < min_weight_ratio * max(
            end_weight[(a, ea)], end_weight[(b, eb)]
        ):
            continue
        if (a, ea) in accepted or (b, eb) in accepted:
            continue
        accepted[(a, ea)] = (b, eb)
        accepted[(b, eb)] = (a, ea)
    # walk chains
    used = np.zeros(n, dtype=bool)
    scaffolds = []
    joins = 0
    for start in range(n):
        if used[start]:
            continue
        if (start, 0) in accepted and (start, 1) in accepted:
            continue  # chain interior; reached from a terminus
        parts = []
        cur, orient = start, 0
        if (start, 0) in accepted and (start, 1) not in accepted:
            orient = 1  # flip so the linked end faces right
        while True:
            used[cur] = True
            codes = ref.scaffold_codes(cur)
            if orient == 1:
                codes = np.where(codes < 4, 3 - codes, 4)[::-1]
            parts.append(codes)
            out_end = 1 if orient == 0 else 0  # right side in emitted frame
            nxt = accepted.get((cur, out_end))
            if nxt is None:
                break
            b, eb = nxt
            if used[b]:
                break
            joins += 1
            # partner attaches by end eb; if eb is its RIGHT end, flip it
            orient = 1 if eb == 1 else 0
            cur = b
        scaffolds.append(parts)
    gap = np.full(gap_ns, 4, dtype=np.uint8)
    out = []
    for i, parts in enumerate(scaffolds):
        seq = parts[0] if len(parts) == 1 else np.concatenate(
            [p for pair in zip(parts, [gap] * (len(parts) - 1)) for p in pair]
            + [parts[-1]]
        )
        out.append(
            (b"scaffold_%d,contigs=%d" % (i, len(parts)),
             CODE_TO_BASE[np.minimum(seq, 4)].tobytes())
        )
    return out, joins


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    ref_path = a.get("ref", "contigs")
    sam = a.get("in", "sam")
    out = a.get("out")
    min_depth = a.get_int("mindepth", "minlinks", default=4)
    mwr = a.get_float("minweightratio", "minwr", default=0.8)
    gap_ns = a.get_int("ns", "gap", "mingap", default=300)
    ref = load_reference(ref_path)
    name_to_idx = {n.split()[0]: i for i, n in enumerate(ref.names)}
    edges = collect_links(sam, name_to_idx)
    scaffolds, joins = scaffold(ref, edges, min_depth, mwr, gap_ns)
    if out:
        write_fasta(out, scaffolds)
    print(f"Contigs In:          \t{ref.n_scaffolds}", file=sys.stderr)
    print(f"Scaffolds Out:       \t{len(scaffolds)}", file=sys.stderr)
    print(f"Joins Made:          \t{joins}", file=sys.stderr)
    return scaffolds, joins
