"""Additional graders: GradeVCF and GradeMergedReads analogs.

References:
  - var2/GradeVCF.java — grade a VCF against a truth VCF with the
    "marking" contract (:36-44): each truth var is marked at most once by
    a matching call; TP = marked truth vars, FN = unmarked truth,
    FP = calls matching no truth.
  - jgi/GradeMergedReads.java — merged reads graded against the insert
    size embedded in their names (`insert=N` or the synth truth header);
    SNR = 10*log10((correct+incorrect)/(incorrect)) (:209).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

from ..core.parser import tokenize


def _parse_vcf(path: str):
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.split("\t")
            chrom, pos, ref, alts = f[0], int(f[1]), f[3], f[4]
            for alt in alts.split(","):
                out.append((chrom, pos, ref, alt))
    return out


@dataclass
class VcfGrade:
    tp: int = 0
    fp: int = 0
    fn: int = 0

    @property
    def precision(self):
        return self.tp / max(self.tp + self.fp, 1)

    @property
    def recall(self):
        return self.tp / max(self.tp + self.fn, 1)

    @property
    def f1(self):
        p, r = self.precision, self.recall
        return 2 * p * r / max(p + r, 1e-12)


def grade_vcf(called_path: str, truth_path: str) -> VcfGrade:
    truth = _parse_vcf(truth_path)
    called = _parse_vcf(called_path)
    truth_set = {}
    for key in truth:
        truth_set[key] = False  # unmarked
    g = VcfGrade()
    for key in called:
        if key in truth_set:
            if not truth_set[key]:
                truth_set[key] = True  # mark once (:36-44)
        else:
            g.fp += 1
    g.tp = sum(truth_set.values())
    g.fn = len(truth_set) - g.tp
    return g


def grade_vcf_main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    called = a.get("in", "vcf")
    truth = a.get("truth", "giab")
    g = grade_vcf(called, truth)
    print(f"TP:        \t{g.tp}")
    print(f"FP:        \t{g.fp}")
    print(f"FN:        \t{g.fn}")
    print(f"Precision: \t{g.precision:.4f}")
    print(f"Recall:    \t{g.recall:.4f}")
    print(f"F1:        \t{g.f1:.4f}")
    return g


def parse_insert(name: bytes) -> int:
    """insert size from `...insert=N...` or synth `..._insertN` names."""
    s = name.decode(errors="replace")
    for tok in s.replace("=", " ").replace("_", " ").split():
        if tok.startswith("insert"):
            v = tok[6:]
            if v.isdigit():
                return int(v)
    if "insert" in s:
        tail = s.split("insert", 1)[1].lstrip("=_")
        num = ""
        for ch in tail:
            if ch.isdigit():
                num += ch
            else:
                break
        if num:
            return int(num)
    return -1


def grade_merged_main(argv=None):
    import math

    from ..io.fastq import FastqReader

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    correct = too_short = too_long = unknown = 0
    for b in FastqReader(in1):
        for i in range(b.n):
            ins = parse_insert(b.ids[i])
            if ins < 0:
                unknown += 1
                continue
            L = int(b.lengths[i])
            if L == ins:
                correct += 1
            elif L < ins:
                too_short += 1
            else:
                too_long += 1
    incorrect = too_short + too_long
    snr = 10 * math.log10((correct + incorrect + 1e-4) / (incorrect + 1e-4))
    print(f"Correct:   \t{correct}")
    print(f"Too short: \t{too_short}")
    print(f"Too long:  \t{too_long}")
    if unknown:
        print(f"No truth:  \t{unknown}")
    print(f"SNR:       \t{snr:.2f} dB")
    return correct, too_short, too_long, snr
