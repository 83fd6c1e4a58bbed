"""CallGenes — prokaryotic ORF calling with GFF3 + protein output.

Reference: prok/CallGenes.java + GeneCaller/GeneModel (callgenes.sh).
The reference scores ORFs with trained k-mer frame statistics
(FrameStats); round-1 scope here is the structural subset: six-frame ORF
enumeration (start ATG/GTG/TTG, stop TAA/TAG/TGA, NCBI genetic code 11),
minimum length, per-strand greedy overlap resolution by score
(length-weighted start-codon preference), GFF3 records, and translated
protein fasta (`outa=`). The frame-statistics scoring model is a planned
upgrade (NEXT.md).

Scan design: per scaffold all three frames are scanned in one vectorized
pass (codon ids = 16*a + 4*b + c over strided views); ORFs fall out of
stop-position difference arrays rather than a per-base loop.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np

from ..core.parser import tokenize
from ..io.fasta import load_reference

STOPS = {48, 50, 56}  # TAA TAG TGA as 16a+4b+c with A0 C1 G2 T3
STARTS = {14, 46, 62}  # ATG GTG TTG (A0 C1 G2 T3 coding)
START_SCORE = {14: 1.0, 46: 0.6, 62: 0.3}  # ATG preferred

# standard/bacterial code (table 11), codons in TCAG order
_TABLE11 = (
    "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
)
_TO_TCAG = {0: 2, 1: 1, 2: 3, 3: 0}  # our A0 C1 G2 T3 -> TCAG index
CODON_AA = {}
for _i in range(64):
    _a, _b, _c = _i >> 4, (_i >> 2) & 3, _i & 3
    CODON_AA[_i] = _TABLE11[
        (_TO_TCAG[_a] << 4) | (_TO_TCAG[_b] << 2) | _TO_TCAG[_c]
    ]


@dataclass
class Orf:
    scaf: int
    start: int  # 0-based inclusive, forward-strand coords
    stop: int  # 0-based inclusive of stop codon end
    strand: int
    score: float
    start_codon: int


def find_orfs_frame(codons: np.ndarray, minlen_nt: int):
    """ORFs in one frame: codons [N] int (0..63, or -1 for N-containing).

    Returns list of (start_codon_idx, stop_codon_idx, start_codon_id):
    start..stop inclusive of the stop codon.
    """
    out = []
    is_stop = np.isin(codons, list(STOPS))
    is_start = np.isin(codons, list(STARTS))
    stop_pos = np.flatnonzero(is_stop)
    prev_stop = -1
    for sp in stop_pos:
        # first start after previous stop
        seg = np.flatnonzero(is_start[prev_stop + 1 : sp])
        if len(seg):
            st = prev_stop + 1 + seg[0]
            if (sp - st + 1) * 3 >= minlen_nt:
                out.append((int(st), int(sp), int(codons[st])))
        prev_stop = sp
    return out


#: Orf.java:551-557 heuristic constants (kinnercds tuning block)
_E1, _E2, _E3 = 0.35, -0.1, -0.01
_F1, _F2, _F3 = 0.08, 0.02, 0.09


def _model_scores(model, c, cands):
    """FrameStats-based orfScore for strand-local candidates
    [(start_nt, stop_end_nt)]: Orf.calcOrfScore (Orf.java:81-99) over
    the CDS inner/start/stop tables."""
    inner = model["CDS inner"]
    cum = inner.inner_cumulative(c)
    starts = np.array([a for a, _ in cands])
    stops = np.array([b for _, b in cands])
    s_start = model["CDS start"].score_points(c, starts)
    s_stop = model["CDS stop"].score_points(c, np.maximum(stops - 2, 0))
    out = []
    for t, (a, b) in enumerate(cands):
        ph = a % 3
        ln = b - a + 1
        kmer_sum = float(cum[ph, b + 1] - cum[ph, a])
        avg_kmer = kmer_sum / max(ln - inner.k - 2, 1)
        aa = np.sqrt(max(_F1, _E1 + float(s_start[t])))
        bb = np.sqrt(max(_F2, _E2 + 0.35 * float(s_stop[t])))
        cc = max(_F3, _E3 + avg_kmer)
        cc = 4 * cc ** 2.2
        d = 0.1 * aa * bb * cc * (ln ** 2.5)
        out.append(float(np.sqrt(d)) if d > 0 else 0.0)
    return out


def call_scaffold(codes: np.ndarray, scaf: int, minlen_nt: int = 300,
                  model=None, min_score: float = 50.0):
    orfs = []
    for strand in (0, 1):
        c = codes if strand == 0 else np.where(codes < 4, 3 - codes, 4)[::-1]
        L = len(c)
        cands = []  # (strand-local start, stop_end, start_codon)
        for frame in range(3):
            n = (L - frame) // 3
            if n <= 0:
                continue
            tri = c[frame : frame + 3 * n].reshape(n, 3).astype(np.int64)
            bad = (tri >= 4).any(axis=1)
            codons = tri[:, 0] * 16 + tri[:, 1] * 4 + tri[:, 2]
            codons[bad] = -1
            for st, sp, start_codon in find_orfs_frame(codons, minlen_nt):
                cands.append((frame + 3 * st, frame + 3 * sp + 2, start_codon))
        if model is not None and cands:
            scores = _model_scores(
                model, c, [(a, b) for a, b, _ in cands]
            )
        else:
            scores = None
        for t, (a, b, start_codon) in enumerate(cands):
            length_nt = b - a + 1
            if scores is not None:
                score = scores[t]
                if score < min_score:
                    continue
            else:
                score = length_nt * START_SCORE.get(start_codon, 0.3)
            if strand == 1:
                a, b = L - 1 - b, L - 1 - a
            orfs.append(Orf(scaf, a, b, strand, score, start_codon))
    # greedy overlap resolution by score (GeneCaller's best-path subset)
    orfs.sort(key=lambda o: -o.score)
    chosen = []
    taken = np.zeros(len(codes), dtype=bool)
    for o in orfs:
        span = taken[o.start : o.stop + 1]
        if span.mean() <= 0.5:  # allow mild operon overlap
            chosen.append(o)
            taken[o.start : o.stop + 1] = True
    chosen.sort(key=lambda o: o.start)
    return chosen


def translate(codes: np.ndarray) -> str:
    n = len(codes) // 3
    tri = codes[: 3 * n].reshape(n, 3).astype(np.int64)
    out = []
    for a, b, c in tri:
        if a >= 4 or b >= 4 or c >= 4:
            out.append("X")
        else:
            out.append(CODON_AA[int(a) * 16 + int(b) * 4 + int(c)])
    return "".join(out)


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1", "ref")
    out_gff = a.get("outgff", "out", "gff")
    out_aa = a.get("outa", "outaa", "aa")
    minlen = a.get_int("minlen", "minlength", default=300)
    model_spec = a.get("model", "pgm")
    use_model = (model_spec or "").lower() not in ("f", "false", "none")
    min_score = a.get_float("minorfscore", "minscore", default=50.0)
    model = None
    if use_model:
        from .pgm import parse_pgm

        model = parse_pgm(
            model_spec if model_spec and os.path.exists(model_spec or "")
            else None
        )
    ref = load_reference(in1)
    genes = []
    for i in range(ref.n_scaffolds):
        genes += call_scaffold(
            ref.scaffold_codes(i), i, minlen, model=model,
            min_score=min_score,
        )
    if out_gff:
        with open(out_gff, "w") as fh:
            fh.write("##gff-version 3\n")
            for j, o in enumerate(genes):
                name = ref.names[o.scaf].split()[0].decode()
                fh.write(
                    f"{name}\tbbtools_torch\tCDS\t{o.start + 1}\t{o.stop + 1}"
                    f"\t{o.score:.1f}\t{'+' if o.strand == 0 else '-'}\t0"
                    f"\tID=gene_{j + 1}\n"
                )
    if out_aa:
        from ..io.fasta import write_fasta

        recs = []
        for j, o in enumerate(genes):
            codes = ref.scaffold_codes(o.scaf)[o.start : o.stop + 1]
            if o.strand == 1:
                codes = np.where(codes < 4, 3 - codes, 4)[::-1]
            aa = translate(codes)
            recs.append((b"gene_%d" % (j + 1), aa.rstrip("*").encode()))
        write_fasta(out_aa, recs)
    print(f"Genes called:        \t{len(genes)}", file=sys.stderr)
    return genes
