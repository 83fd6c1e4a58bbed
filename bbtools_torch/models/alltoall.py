"""AllToAll / IdMatrix — all-to-all identity matrix (alltoall.sh,
idmatrix.sh; jgi/AllToAll.java, driver/IDMatrix.java roles).

The PyTorch port of bbtools_tpu/models/alltoall.py. Every sequence pair
is aligned with the batched glocal identity aligner on the run's device
(ops/idalign.glocal_identity, `device=`, cuda by default; the
idaligner family's identity contract), the pair list tiled through the
device in fixed batches of BATCH pairs. Output is a tab-delimited matrix
of identity percentages, each the float32 identity printed %.2f from
float64.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.parser import tokenize
from ..io.fasta import read_fasta
from ..io.fileformat import Format, test_input
from ..io.readwrite import open_output

BATCH = 512


def _load(path: str):
    if test_input(path).format == Format.FASTA:
        recs = read_fasta(path)
        return [(r.name.split()[0], r.seq.upper()) for r in recs]
    from ..io.fastq import FastqReader

    out = []
    for b in FastqReader(path):
        for i in range(b.n):
            out.append((b.ids[i].split()[0], b.sequence(i).upper()))
    return out


def main(argv=None):
    from ..core.dna import BASE_TO_CODE
    from ..device import resolve_device
    from ..ops.idalign import glocal_identity

    a = tokenize(argv if argv is not None else sys.argv[1:])
    device = resolve_device(a.get("device", default="cuda"))
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    percent = a.get_bool("percent", default=True)
    seqs = _load(in1)
    n = len(seqs)
    codes = [BASE_TO_CODE[np.frombuffer(s, np.uint8)] for _, s in seqs]
    lens = np.array([len(c) for c in codes], dtype=np.int32)
    ident = np.eye(n, dtype=np.float64)

    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    for lo in range(0, len(pairs), BATCH):
        chunk = pairs[lo : lo + BATCH]
        M = int(max(lens[i] for i, _ in chunk))
        N = int(max(lens[j] for _, j in chunk))
        qs = np.full((len(chunk), M), 4, dtype=np.uint8)
        rs = np.full((len(chunk), N), 4, dtype=np.uint8)
        ql = np.zeros(len(chunk), dtype=np.int32)
        rl = np.zeros(len(chunk), dtype=np.int32)
        for t, (i, j) in enumerate(chunk):
            qs[t, : lens[i]] = codes[i]
            ql[t] = lens[i]
            rs[t, : lens[j]] = codes[j]
            rl[t] = lens[j]
        idv, _, _ = glocal_identity(qs, ql, rs, rl, device)
        idv = idv.cpu().numpy()
        for t, (i, j) in enumerate(chunk):
            ident[i, j] = ident[j, i] = float(idv[t])

    scale = 100.0 if percent else 1.0
    lines = [
        b"#name\t" + b"\t".join(name for name, _ in seqs) + b"\n"
    ]
    for i in range(n):
        lines.append(
            seqs[i][0] + b"\t"
            + b"\t".join(
                b"%.2f" % (ident[i, j] * scale) for j in range(n)
            )
            + b"\n"
        )
    if out1:
        with open_output(out1) as fh:
            fh.writelines(lines)
    else:
        sys.stdout.buffer.write(b"".join(lines))
    return ident


if __name__ == "__main__":
    main()
