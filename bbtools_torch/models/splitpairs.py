"""BBSplitPairs / repair — pair bookkeeping (jgi/SplitPairsAndSingles.java).

Modes:
  - split interleaved input to out1/out2
  - interleave two inputs to one output
  - repair: re-pair reads by name from an unordered stream, emitting
    singles whose mates are missing (fixinterleaving/repair semantics)
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.parser import tokenize
from ..io.fastq import FastqReader, encode_fastq
from ..io.readwrite import open_output


def _strip_pairnum(name: bytes) -> bytes:
    base = name.split()[0]
    if base.endswith(b"/1") or base.endswith(b"/2"):
        return base[:-2]
    return base


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    in2 = a.get("in2")
    out1 = a.get("out", "out1")
    out2 = a.get("out2")
    outs = a.get("outs", "outsingle")
    repair = a.get_bool("repair", "fixinterleaving", "fint", default=False)
    if in2 and out1 and not out2:
        # interleave two files
        r1, r2 = FastqReader(in1), FastqReader(in2)
        with open_output(out1) as fh:
            for b1, b2 in zip(r1, r2):
                for i in range(b1.n):
                    fh.write(encode_fastq(b1, np.arange(b1.n) == i))
                    fh.write(encode_fastq(b2, np.arange(b2.n) == i))
        print(f"Interleaved {r1.reads_in} pairs.", file=sys.stderr)
        return
    if repair:
        # re-pair by name
        pending: dict[bytes, tuple[bytes, bytes, bytes]] = {}
        pairs = singles = 0
        o1 = open_output(out1) if out1 else None
        o2 = open_output(out2) if out2 else None
        osng = open_output(outs) if outs else None
        for b in FastqReader(in1):
            for i in range(b.n):
                name = _strip_pairnum(b.ids[i])
                rec = (b.ids[i], b.sequence(i), b.quality_string(i))
                if name in pending:
                    mate = pending.pop(name)
                    pairs += 1
                    if o1:
                        o1.write(b"@%s\n%s\n+\n%s\n" % mate)
                    if o2:
                        o2.write(b"@%s\n%s\n+\n%s\n" % rec)
                else:
                    pending[name] = rec
        for rec in pending.values():
            singles += 1
            if osng:
                osng.write(b"@%s\n%s\n+\n%s\n" % rec)
        for f in (o1, o2, osng):
            if f:
                f.close()
        print(f"Pairs: {pairs}  Singletons: {singles}", file=sys.stderr)
        return pairs, singles
    # split interleaved
    o1 = open_output(out1) if out1 else None
    o2 = open_output(out2) if out2 else None
    n = 0
    for b in FastqReader(in1):
        for i in range(b.n):
            rec = b"@%s\n%s\n+\n%s\n" % (b.ids[i], b.sequence(i), b.quality_string(i))
            if n % 2 == 0:
                if o1:
                    o1.write(rec)
            else:
                if o2:
                    o2.write(rec)
            n += 1
    for f in (o1, o2):
        if f:
            f.close()
    print(f"Split {n} reads into {n//2} pairs.", file=sys.stderr)
    return n


if __name__ == "__main__":
    main()
