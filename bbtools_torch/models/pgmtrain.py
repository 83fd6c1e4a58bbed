"""PGM training and merging — analyzegenes.sh / mergepgm.sh.

Reference: prok/AnalyzeGenes.java (paired fna+gff -> k-mer frame
statistics -> .pgm), prok/PGMTools.java (merge .pgm files, optional
per-file multipliers), prok/GeneModel.java counting semantics:

  - inner (k=6, frames=3): markFrames sets a 3-bit phase mask per CDS
    k-mer END position, cycling bits {1,2,4} from 1<<((k-1)%3)
    (GeneModel.markFrames). processCDSFrames then tallies EVERY genomic
    k-mer into all 3 frames, valid = that frame's bit
    (FrameStats.processCDSFrames, FrameStats.java:168-191).
  - start (k=3, frames=30, offset=21) / stop (k=3, frames=22, offset=9):
    processPoint tallies the k-mers of the window [point-offset, ...)
    with frame = i-start+1-k, skipping pre-sequence positions
    (FrameStats.processPoint, :195-230). Valid=1 sites are annotated CDS
    starts (codon start position) and stops (codon END position);
    valid=0 decoys are all other ATG/GTG/TTG starts, TAG/TAA/TGA stop
    ends, plus noise points every 2000bp (GeneModel.java:330-394).
  - Minus strand: the scaffold is reverse-complemented and coordinates
    mirrored (p -> len-p-1, start/stop swapped), then counted the same
    way (GeneModel.processGene:561-580).

The output .pgm is the same text format the bundled resources/model.pgm
uses, so models/pgm.parse_pgm and CallGenes consume trained models
directly. Only the CDS container is trained (callCDS); tRNA/rRNA
containers need the ribosomal alignment path (AnalyzeGenes.alignRibo)
and are out of scope here.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.dna import decode, encode
from ..core.parser import tokenize

K_INNER, FRAMES_INNER = 6, 3
K_END = 3
FRAMES_START, OFFSET_START = 30, 21
FRAMES_STOP, OFFSET_STOP = 22, 9

_START_CODONS = {0b001110, 0b101110, 0b111110}  # ATG GTG TTG (2-bit A0C1G2T3)
_STOP_CODONS = {0b110010, 0b110000, 0b111000}  # TAG TAA TGA


def _codon_code(s: str) -> int:
    v = 0
    for ch in s:
        v = (v << 2) | "ACGT".index(ch)
    return v


assert _START_CODONS == {_codon_code(c) for c in ("ATG", "GTG", "TTG")}
assert _STOP_CODONS == {_codon_code(c) for c in ("TAG", "TAA", "TGA")}


class _Stats:
    def __init__(self, k: int, frames: int, offset: int):
        self.k, self.frames, self.offset = k, frames, offset
        self.counts = np.zeros((2, frames, 4 ** k), np.int64)


def _rolling(codes: np.ndarray, k: int):
    """(kmer value ending at i, runlen at i) with N resetting runs."""
    n = len(codes)
    kmers = np.zeros(n, np.int64)
    runs = np.zeros(n, np.int32)
    mask = (1 << (2 * k)) - 1
    km = 0
    ln = 0
    for i in range(n):
        x = int(codes[i])
        if x > 3:
            ln = 0
            km = ((km << 2) & mask)
        else:
            km = ((km << 2) | x) & mask
            ln += 1
        kmers[i] = km
        runs[i] = ln
    return kmers, runs


def _mark_frames(frames: np.ndarray, start: int, stop: int, k: int):
    bit = 1 << ((k - 1) % 3)
    mx = min(stop - 3, len(frames) - 1)
    for i in range(start + k - 1, mx + 1):
        frames[i] |= bit
        bit <<= 1
        if bit > 4:
            bit = 1


def _process_point(st: _Stats, kmers, runs, n: int, point: int, valid: int):
    if point < 3 or point >= n - 3:
        return
    start = point - st.offset
    i = start
    frame = 0 - st.k + 1
    while i < 0:
        i += 1
        frame += 1
    while i < n and frame < st.frames:
        if frame >= 0 and runs[i] >= st.k:
            st.counts[valid, frame, kmers[i]] += 1
        i += 1
        frame += 1


def _train_strand(codes, cds, inner: _Stats, start_st: _Stats,
                  stop_st: _Stats):
    """One strand pass. cds = [(start0, stop0)] in THIS orientation."""
    n = len(codes)
    frames = np.zeros(n, np.uint8)
    starts, stops = [], []
    for s0, e0 in cds:
        if e0 - s0 + 1 < 2 or s0 < 0 or e0 >= n:
            continue
        _mark_frames(frames, s0, e0, K_INNER)
        starts.append(s0)
        stops.append(e0)
    km6, run6 = _rolling(codes, K_INNER)
    ok = run6 >= K_INNER
    vf = frames[ok].astype(np.int64)
    kk = km6[ok]
    for fr in range(FRAMES_INNER):
        bit = (vf >> fr) & 1
        np.add.at(inner.counts[1, fr], kk[bit == 1], 1)
        np.add.at(inner.counts[0, fr], kk[bit == 0], 1)
    km3, run3 = _rolling(codes, K_END)
    for p in starts:
        _process_point(start_st, km3, run3, n, p, 1)
    for p in stops:
        _process_point(stop_st, km3, run3, n, p, 1)
    start_set = set(starts)
    stop_set = set(stops)
    # decoys: every non-annotated start codon (codon START pos) and stop
    # codon (codon END pos), plus noise every 2000bp
    ok3 = np.nonzero(run3 >= K_END)[0]
    vals = km3[ok3]
    for i, v in zip(ok3.tolist(), vals.tolist()):
        if v in _START_CODONS:
            p = i - K_END + 1
            if p not in start_set:
                start_set.add(p)
                _process_point(start_st, km3, run3, n, p, 0)
        if v in _STOP_CODONS and i not in stop_set:
            stop_set.add(i)
            _process_point(stop_st, km3, run3, n, i, 0)
    for i in range(50, n - 3, 2000):
        if i not in start_set:
            _process_point(start_st, km3, run3, n, i, 0)
        if i not in stop_set:
            _process_point(stop_st, km3, run3, n, i, 0)
    return len(starts)


def _write_block(fh, name: str, st: _Stats):
    fh.write(f"#name\t{name}\n#k\t{st.k}\n#frames\t{st.frames}\n"
             f"#offset\t{st.offset}\n".encode())
    hdr = "\t".join(
        decode(np.array([(km >> (2 * (st.k - 1 - j))) & 3
                         for j in range(st.k)], np.uint8)).decode()
        for km in range(4 ** st.k))
    fh.write(f"#valid\tframe\t{hdr}\n".encode())
    for v in (0, 1):
        for fr in range(st.frames):
            row = "\t".join(str(int(x)) for x in st.counts[v, fr])
            fh.write(f"{v}\t{fr}\t{row}\n".encode())


def analyzegenes_main(args):
    a = tokenize(args)
    fnas = [p for p in (a.get("in", "in1", "fna") or "").split(",") if p]
    gffs = [p for p in (a.get("gff") or "").split(",") if p]
    out = a.get("out", "pgm")
    if not fnas or len(fnas) != len(gffs) or not out:
        print("Usage: analyzegenes in=<a.fna,b.fna> gff=<a.gff,b.gff>"
              " out=<model.pgm>", file=sys.stderr)
        return 1
    from ..io.fasta import iter_fasta
    from .gfftools import _read_gff

    inner = _Stats(K_INNER, FRAMES_INNER, 0)
    start_st = _Stats(K_END, FRAMES_START, OFFSET_START)
    stop_st = _Stats(K_END, FRAMES_STOP, OFFSET_STOP)
    genes = 0
    bases = 0
    scaffolds = 0
    length_sum = 0
    acgtn = np.zeros(5, np.int64)
    gc = 0
    for fna, gff in zip(fnas, gffs):
        rows = [r for r in _read_gff(gff) if r["type"] == b"CDS"]
        by_scaf: dict[bytes, list] = {}
        for r in rows:
            by_scaf.setdefault(r["seqid"], []).append(r)
        for rec in iter_fasta(fna):
            scaffolds += 1
            codes = encode(rec.seq)
            n = len(codes)
            bases += n
            idx = np.where(codes < 4, codes, 4)
            acgtn += np.bincount(idx, minlength=5)
            gc += int(((codes == 1) | (codes == 2)).sum())
            key = rec.name.split()[0]
            lines = by_scaf.get(key, [])
            plus = [(r["start"] - 1, r["stop"] - 1) for r in lines
                    if r["strand"] == b"+"]
            minus = [(n - (r["stop"] - 1) - 1, n - (r["start"] - 1) - 1)
                     for r in lines if r["strand"] == b"-"]
            length_sum += sum(e - s + 1 for s, e in plus + minus)
            genes += _train_strand(codes, plus, inner, start_st, stop_st)
            rc = np.where(codes < 4, 3 - codes, 4).astype(np.uint8)[::-1]
            genes += _train_strand(rc, minus, inner, start_st, stop_st)
    from ..io.readwrite import open_output

    with open_output(out) as fh:
        fh.write(b"#BBMap 40.02-tpu Prokaryotic Gene Model\n")
        fh.write(b"#files\t%d\n#taxIDs\n#scaffolds\t%d\n#bases\t%d\n"
                 b"#genes\t%d\n" % (len(fnas), scaffolds, bases, genes))
        fh.write(b"#GC\t%.2f\n" % (gc / max(bases, 1)))
        fh.write(b"#ACGTN\t" + b"\t".join(
            b"%d" % x for x in acgtn) + b"\n")
        fh.write(b"#name\tCDS\n#type\t0\n#count\t%d\n#lengthSum\t%d\n"
                 b"#contains\t3\n" % (genes, length_sum))
        _write_block(fh, "CDS inner", inner)
        _write_block(fh, "CDS start", start_st)
        _write_block(fh, "CDS stop", stop_st)
    print(f"Trained on {genes} genes / {bases} bases; wrote {out}",
          file=sys.stderr)
    return 0


# ----------------------------------------------------------------------
# mergepgm: generic text-block merge (PGMTools role)
# ----------------------------------------------------------------------


def _parse_raw_pgm(path: str):
    """Parse a .pgm into (top header lines, [(block headers, rows)])."""
    from ..io.readwrite import read_bytes

    top: list[bytes] = []
    blocks: list[tuple[list[bytes], np.ndarray | None, list]] = []
    cur_hdr: list[bytes] | None = None
    cur_rows: list[list[int]] = []

    def flush():
        nonlocal cur_hdr, cur_rows
        if cur_hdr is not None:
            blocks.append((cur_hdr, cur_rows))
        cur_hdr, cur_rows = None, []

    for ln in read_bytes(path).split(b"\n"):
        if not ln.strip():
            continue
        if ln.startswith(b"#name"):
            flush()
            cur_hdr = [ln]
        elif ln.startswith(b"#"):
            (top if cur_hdr is None else cur_hdr).append(ln)
        elif cur_hdr is not None:
            cur_rows.append([int(x) for x in ln.split(b"\t")])
    flush()
    return top, blocks


_SUMMABLE = (b"#files", b"#scaffolds", b"#bases", b"#genes", b"#count",
             b"#lengthSum", b"#ACGTN")


def mergepgm_main(args):
    """mergepgm.sh -> prok.PGMTools: sum counts across .pgm files
    block-by-block (names must match), with optional mult=m1,m2,..."""
    a = tokenize(args)
    ins = [p for p in (a.get("in", "in1") or "").split(",") if p]
    ins = ins or [t for t in args if "=" not in t]
    out = a.get("out")
    if len(ins) < 2 or not out:
        print("Usage: mergepgm in=<a.pgm,b.pgm,...> out=<merged.pgm>"
              " [mult=1,1,...]", file=sys.stderr)
        return 1
    mults = [float(x) for x in (a.get("mult", "mults") or "").split(",")
             if x] or [1.0] * len(ins)
    parsed = [_parse_raw_pgm(p) for p in ins]
    top0, blocks0 = parsed[0]
    merged_rows = [
        [[v * mults[0] for v in row] for row in rows]
        for hdr, rows in blocks0
    ]
    sums: dict[bytes, np.ndarray] = {}
    for key in _SUMMABLE:
        for ln in top0:
            if ln.startswith(key + b"\t"):
                sums[key] = np.array(
                    [float(x) for x in ln.split(b"\t")[1:]]) * mults[0]
    for (top, blocks), m in zip(parsed[1:], mults[1:]):
        assert len(blocks) == len(blocks0), "block structure mismatch"
        for bi, (hdr, rows) in enumerate(blocks):
            assert hdr[0] == blocks0[bi][0][0], (
                f"block name mismatch: {hdr[0]} vs {blocks0[bi][0][0]}")
            for ri, row in enumerate(rows):
                mr = merged_rows[bi][ri]
                # first cols are valid/frame labels; sum the counts only
                for ci in range(2, len(row)):
                    mr[ci] += row[ci] * m
        for key in _SUMMABLE:
            for ln in top:
                if ln.startswith(key + b"\t") and key in sums:
                    sums[key] = sums[key] + np.array(
                        [float(x) for x in ln.split(b"\t")[1:]]) * m
    from ..io.readwrite import open_output

    with open_output(out) as fh:
        for ln in top0:
            key = ln.split(b"\t")[0]
            if key in sums:
                ln = key + b"\t" + b"\t".join(
                    b"%d" % int(round(v)) for v in sums[key])
            fh.write(ln + b"\n")
        for bi, (hdr, _) in enumerate(blocks0):
            for ln in hdr:
                key = ln.split(b"\t")[0]
                if key in sums and key in (b"#count", b"#lengthSum"):
                    pass  # per-container counts kept from file 0 scale
                fh.write(ln + b"\n")
            for row in merged_rows[bi]:
                fh.write(b"\t".join(
                    b"%d" % int(round(v)) if i >= 2 else b"%d" % int(v)
                    for i, v in enumerate(row)) + b"\n")
    print(f"Merged {len(ins)} models -> {out}", file=sys.stderr)
    return 0
