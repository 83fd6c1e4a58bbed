"""BBRealign — realign mapped reads to a reference (bbrealign.sh,
var2/Realign.java role, realignment core shared with CallVariants'
realign=t: var2/Realigner.java:36-160).

The PyTorch port of bbtools_tpu/models/bbrealign.py: the same gate and
rewrite, with the MSA of each flush on `device=` (cuda by default).

Reads a SAM, gates each primary alignment with the Realigner badness
heuristic (clips / many mismatches / complex indel pattern), re-MSAs the
gated reads against padded reference windows on the device
(ops/msa.realign_batch), and rewrites POS/CIGAR when the new alignment
has strictly fewer bad symbols.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.dna import BASE_TO_CODE
from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fasta import load_reference
from ..io.readwrite import open_input, open_output
from ..io.sam import match_to_cigar14
from ..io.sam_read import SamRecord, cigar_to_match
from .callvariants import CallVariants

REALIGN_PAD = 200  # var2/Realigner.java:208 defaultPadding


def _badness(m: bytes) -> int:
    return (
        m.count(b"S") + m.count(b"C")
        + 2 * (m.count(b"I") + m.count(b"D"))
    )


def main(argv=None):
    from ..ops.msa import realign_batch

    a = tokenize(argv if argv is not None else sys.argv[1:])
    device = resolve_device(a.get("device", default="cuda"))
    in1 = a.get("in", "in1")
    ref_path = a.get("ref")
    out1 = a.get("out", "out1")
    ref = load_reference(ref_path)
    name_to_idx = {n.split()[0]: i for i, n in enumerate(ref.names)}

    lines_out: list[bytes] = []
    pending: list[tuple[int, bytes, bytes, int]] = []  # (line_idx, seq, match, scafnum, pos)
    realigned = total = 0

    def flush():
        nonlocal realigned
        if not pending:
            return
        R = max(len(seq) for _, seq, _, _, _ in pending)
        reads = np.full((len(pending), R), 4, dtype=np.uint8)
        rlens = np.zeros(len(pending), dtype=np.int32)
        wins, starts, wlens = [], [], []
        W = 0
        for t, (_, seq, match, scafnum, pos) in enumerate(pending):
            codes = BASE_TO_CODE[np.frombuffer(seq, np.uint8)]
            reads[t, : len(codes)] = codes
            rlens[t] = len(codes)
            ref_codes = ref.scaffold_codes(scafnum)
            rlen_ref = sum(1 for m in match if m in b"mSND")
            a0 = max(0, pos - 1 - REALIGN_PAD)
            b0 = min(len(ref_codes), pos - 1 + rlen_ref + REALIGN_PAD)
            wins.append(ref_codes[a0:b0])
            starts.append(a0)
            wlens.append(b0 - a0)
            W = max(W, b0 - a0)
        winarr = np.full((len(pending), W), 4, dtype=np.uint8)
        for t, wv in enumerate(wins):
            winarr[t, : len(wv)] = wv
        matches2, start_cols, _ = realign_batch(
            reads, rlens, winarr, np.asarray(wlens, np.int32), device=device
        )
        for t, (li, seq, match, scafnum, pos) in enumerate(pending):
            m2 = matches2[t]
            if m2 and _badness(m2) < _badness(match):
                new_start0 = starts[t] + int(start_cols[t])
                f = lines_out[li].rstrip(b"\n").split(b"\t")
                f[3] = b"%d" % (new_start0 + 1)
                f[5] = match_to_cigar14(
                    m2, new_start0, len(ref.scaffold_codes(scafnum))
                ).encode()
                lines_out[li] = b"\t".join(f) + b"\n"
                realigned += 1
        pending.clear()

    with open_input(in1) as fh:
        for line in fh:
            if line.startswith(b"@"):
                lines_out.append(line)
                continue
            f = line.rstrip(b"\n").split(b"\t")
            li = len(lines_out)
            lines_out.append(line)
            if len(f) < 11:
                continue
            flag = int(f[1])
            if flag & 0x4 or flag & 0x100 or flag & 0x800:
                continue
            si = name_to_idx.get(f[2])
            if si is None:
                continue
            total += 1
            rec = SamRecord(
                qname=f[0], flag=flag, rname=f[2], pos=int(f[3]),
                mapq=int(f[4]), cigar=f[5].decode(), seq=f[9], qual=f[10],
            )
            match = cigar_to_match(rec, ref.scaffold_codes(si))
            if match and CallVariants._should_realign(match):
                pending.append((li, f[9], match, si, int(f[3])))
                if len(pending) >= 128:
                    flush()
    flush()
    if out1:
        with open_output(out1) as fh:
            fh.writelines(lines_out)
    print(
        f"Realigned {realigned} of {total} alignments.", file=sys.stderr
    )
    return realigned, total


if __name__ == "__main__":
    main()
