"""Synthetic read generation with encoded truth — the test oracle.

The reference's correctness harness is synthesize -> run -> grade
(SURVEY.md §4.1: synth/RandomReads3.java encodes the true origin in the
read header; align2/GradeSamFile.java:26 parses it back). This module
implements that loop for the TPU framework: reads drawn from a reference
with configured SNP/indel rates, origin encoded in the header as
  name_scaf<idx>_pos<start0>_strand<0|1>_insert<len>
plus generators for random genomes and mutated genomes (variant truth).
"""

from __future__ import annotations

import numpy as np

from ..core.dna import CODE_TO_BASE
from ..io.fasta import Reference


def random_genome(length: int, n_scaffolds: int = 1, seed: int = 0,
                  gc: float = 0.5) -> list[tuple[bytes, bytes]]:
    rng = np.random.default_rng(seed)
    out = []
    per = length // n_scaffolds
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    for i in range(n_scaffolds):
        codes = rng.choice(4, size=per, p=p).astype(np.uint8)
        out.append((b"scaffold_%d" % i, CODE_TO_BASE[codes].tobytes()))
    return out


def mutate_genome(ref: Reference, sub_rate: float = 0.01, seed: int = 1):
    """Introduce substitutions; returns (mutated codes list, truth list of
    (scaf_idx, pos0, ref_code, alt_code)) — CallVariants truth."""
    rng = np.random.default_rng(seed)
    muts = []
    out = []
    for i in range(ref.n_scaffolds):
        codes = ref.scaffold_codes(i).copy()
        m = (rng.random(len(codes)) < sub_rate) & (codes < 4)
        for p in np.flatnonzero(m):
            alt = (codes[p] + rng.integers(1, 4)) % 4
            muts.append((i, int(p), int(codes[p]), int(alt)))
            codes[p] = alt
        out.append(codes)
    return out, muts


def _plant_indel(codes: np.ndarray, start: int, read_len: int, rng,
                 indel_range: tuple[int, int]):
    """Extract a fwd-strand read of `read_len` from codes[start:] with ONE
    indel event planted mid-read (RandomReads3.java addIndel analog).
    Returns the read codes; leftmost ref position stays `start` so truth
    headers remain valid for grade_sam."""
    ilen = int(rng.integers(indel_range[0], indel_range[1] + 1))
    # event position: keep >=15 anchored bases each side so the aligner
    # has seeds on both flanks (reference uses similar margins)
    margin = min(15, read_len // 4)
    p = int(rng.integers(margin, read_len - margin))
    if rng.random() < 0.5:  # deletion: read skips ilen ref bases at p
        frag = codes[start : start + read_len + ilen]
        if len(frag) < read_len + ilen:
            return codes[start : start + read_len].copy()
        return np.concatenate([frag[:p], frag[p + ilen :]]).copy()
    # insertion: ilen novel bases at p, read covers less reference
    if ilen >= read_len - 2 * margin:
        return codes[start : start + read_len].copy()
    frag = codes[start : start + read_len - ilen]
    ins = rng.integers(0, 4, ilen).astype(np.uint8)
    return np.concatenate([frag[:p], ins, frag[p:]])[:read_len].copy()


def random_reads(
    ref: Reference,
    n: int,
    read_len: int = 150,
    paired: bool = False,
    insert_range: tuple[int, int] = (200, 500),
    snp_rate: float = 0.0,
    indel_rate: float = 0.0,
    indel_range: tuple[int, int] = (1, 10),
    q: int = 35,
    seed: int = 42,
):
    """Generate reads (or pairs) with truth headers.

    `indel_rate` is the per-read probability of one planted indel event
    (length uniform in `indel_range`, 50/50 ins/del) — the grade_sam
    harness then exercises gapped alignment, not just substitutions.
    Returns list of (name, seq, qual) or (r1_tuple, r2_tuple) pairs.
    """
    rng = np.random.default_rng(seed)
    total = int(ref.starts[-1] + ref.lengths[-1]) if ref.n_scaffolds else 0
    out = []
    qual = bytes([q + 33]) * read_len
    for i in range(n):
        scaf = int(rng.integers(0, ref.n_scaffolds))
        codes = ref.scaffold_codes(scaf)
        if paired:
            insert = int(rng.integers(*insert_range))
            start = int(rng.integers(0, max(1, len(codes) - insert)))
            frag = codes[start : start + insert]
            if indel_rate > 0 and rng.random() < indel_rate:
                r1 = _plant_indel(codes, start, min(read_len, len(frag)),
                                  rng, indel_range)
            else:
                r1 = frag[:read_len].copy()
            r2f = frag[max(0, len(frag) - read_len) :].copy()
            r2 = np.where(r2f[::-1] < 4, 3 - r2f[::-1], 4).astype(np.uint8)
            strand1 = 0
            for r in (r1, r2):
                m = (rng.random(len(r)) < snp_rate) & (r < 4)
                r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
            name1 = b"r%d_scaf%d_pos%d_strand0_insert%d" % (i, scaf, start, insert)
            name2 = b"r%d_scaf%d_pos%d_strand1_insert%d" % (
                i, scaf, start + len(frag) - len(r2), insert,
            )
            out.append(
                (
                    (name1, CODE_TO_BASE[np.minimum(r1, 4)].tobytes(), qual[: len(r1)]),
                    (name2, CODE_TO_BASE[np.minimum(r2, 4)].tobytes(), qual[: len(r2)]),
                )
            )
        else:
            strand = int(rng.integers(0, 2))
            start = int(rng.integers(0, max(1, len(codes) - read_len - indel_range[1])))
            if indel_rate > 0 and rng.random() < indel_rate:
                r = _plant_indel(codes, start, read_len, rng, indel_range)
            else:
                r = codes[start : start + read_len].copy()
            if strand:
                r = np.where(r[::-1] < 4, 3 - r[::-1], 4).astype(np.uint8)
            m = (rng.random(len(r)) < snp_rate) & (r < 4)
            r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
            name = b"r%d_scaf%d_pos%d_strand%d_insert0" % (i, scaf, start, strand)
            out.append((name, CODE_TO_BASE[np.minimum(r, 4)].tobytes(), qual[: len(r)]))
    return out


def parse_truth(name: bytes):
    """Inverse of the truth header: (scaf_idx, pos0, strand)."""
    parts = name.split(b"_")
    scaf = int(parts[1][4:])
    pos = int(parts[2][3:])
    strand = int(parts[3][6:])
    return scaf, pos, strand


def write_reads(path: str, reads, append=False):
    from ..io.readwrite import open_output

    with open_output(path) as fh:
        for rec in reads:
            name, seq, qual = rec
            fh.write(b"@" + name + b"\n" + seq + b"\n+\n" + qual + b"\n")
