"""GradeSamFile — mapping correctness vs synthetic truth
(align2/GradeSamFile.java:26, gradesam.sh): reads utils/synth truth
headers and reports strict/loose correctness.
"""

from __future__ import annotations

import sys

from ..core.parser import tokenize
from ..io.fasta import load_reference
from ..utils.graders import grade_sam


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    sam = a.get("in", "in1")
    ref_path = a.get("ref")
    tolerance = a.get_int("thresh", "tolerance", default=20)
    if ref_path:
        names = load_reference(ref_path).names
    else:
        # scaffold names from the SAM header
        names = []
        with open(sam, "rb") as fh:
            for line in fh:
                if line.startswith(b"@SQ"):
                    for f in line.split(b"\t"):
                        if f.startswith(b"SN:"):
                            names.append(f[3:].strip())
                elif not line.startswith(b"@"):
                    break
    g = grade_sam(sam, names, tolerance=tolerance)
    t = max(g.total, 1)
    print(f"Total reads:         \t{g.total}")
    print(f"Mapped:              \t{g.mapped}\t{100.0*g.mapped/t:.3f}%")
    print(f"Correct (strict):    \t{g.correct_strict}\t{100.0*g.correct_strict/t:.3f}%")
    print(f"Correct (loose):     \t{g.correct_loose}\t{100.0*g.correct_loose/t:.3f}%")
    print(f"Incorrect:           \t{g.wrong}\t{100.0*g.wrong/t:.3f}%")
    print(f"Unmapped:            \t{g.unmapped}\t{100.0*g.unmapped/t:.3f}%")
    return g


if __name__ == "__main__":
    main()
