"""Output graders — compare tool output against encoded synthetic truth.

The GradeSamFile analog (align2/GradeSamFile.java:26): parse truth from
read names (utils/synth.py format), compare against SAM records with a
positional tolerance (the reference's loose/strict thresholds).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .synth import parse_truth


@dataclass
class SamGrade:
    total: int = 0
    mapped: int = 0
    correct_strict: int = 0  # exact position + strand + scaffold
    correct_loose: int = 0  # within `tolerance`
    wrong: int = 0
    unmapped: int = 0
    details: list = field(default_factory=list)


def grade_sam(path: str, scaffold_names: list[bytes], tolerance: int = 20) -> SamGrade:
    g = SamGrade()
    name_to_idx = {n.split()[0]: i for i, n in enumerate(scaffold_names)}
    from ..io.sam_read import iter_sam

    if True:
        for rec in iter_sam(path):
            qname, flag, rname, pos = rec.qname, rec.flag, rec.rname, rec.pos
            if flag & 0x100 or flag & 0x800:
                continue  # secondary/supplementary
            g.total += 1
            scaf_t, pos_t, strand_t = parse_truth(qname)
            if flag & 0x4:
                g.unmapped += 1
                continue
            g.mapped += 1
            strand = 1 if flag & 0x10 else 0
            scaf = name_to_idx.get(rname, -1)
            # account for leading soft clips: POS refers to first aligned
            # base; truth is the read start
            cigar = rec.cigar
            lead_clip = _leading_clip(cigar)
            pos0 = pos - 1 - (lead_clip if strand == 0 else 0)
            if strand == 1:
                # truth pos for reverse reads: name encodes the fwd-strand
                # start of the sampled window
                pos0 = pos - 1 - lead_clip
            ok_pos = scaf == scaf_t and strand == strand_t
            if ok_pos and abs(pos0 - pos_t) == 0:
                g.correct_strict += 1
                g.correct_loose += 1
            elif ok_pos and abs(pos0 - pos_t) <= tolerance:
                g.correct_loose += 1
            else:
                g.wrong += 1
                if len(g.details) < 20:
                    g.details.append((qname, scaf, pos0, strand, scaf_t, pos_t, strand_t))
    return g


def _leading_clip(cigar: str) -> int:
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            if ch == "S":
                return int(num)
            return 0
    return 0
