"""CalcTrueQuality — empirical quality-score recalibration.

Counts correct/incorrect base calls from aligned SAM (using the match
string derived from extended CIGAR), bins them by local context into
good/bad matrices, writes the matrices as text, and applies them to
recalibrate quality scores (the `recalibrate` flag of BBDuk/Reformat).

Reference semantics (jgi/CalcTrueQuality.java):
  - counting loop :1369-1532 — per aligned position, index by
    (pairnum, q1, context...); 'm' adds good+=2 (good+=1/bad+=1 when
    adjacent to a 'D' and COUNT_INDELS), 'S'/'I' add bad+=2; 'N', 'D',
    undefined bases skipped; minus-strand reads are reversed first so
    positions are sequencing-cycle positions (:1355-1358).
  - matrix families (GBMatrixSet :1569): default pass-0 set is
    qbp, qb012, qb123, qb234; pass-1 set is qbp (use_* :2651-2663).
    The p (position) matrix is always tracked.
  - text format (writeMatrix :491): one row per nonzero cell,
    indices..., sum(good+bad), bad; filename `_p#` -> `_p{pass}`.
  - recalibration (CountMatrixSet.recalibrate :1764-1797 with
    estimateErrorProbWeighted :2220-2326, the USE_WEIGHTED_AVERAGE
    default): pool raw counts over the loaded matrices, smooth with
    fakeSum=OBSERVATION_CUTOFF (100/200 per pass :2674) and
    fakeBad=expected*cutoff floored at BAD_CUTOFF=0.5 (:2676), then
    q2 = max(2, round(-10*log10(prob))) clamped to MAX_CALLED_QUALITY.
  - constants :2616-2635: QMAX=50, QEND=51, QMAX2=52, BMAX=6,
    LENMAX=361; baseToNum A0 C1 G2 T3 U3 E4 other5 (:2595-2605);
    PROB_ERROR[0] overridden to 0.8 locally (:2600-2604).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..core.dna import BASE_TO_CODE
from ..core.parser import tokenize
from ..io.sam_read import iter_sam

QMAX = 50  # Read.MAX_CALLED_QUALITY (stream/Read.java:4486)
QEND = QMAX + 1
QMAX2 = QEND + 1
BMAX = 6
LENMAX = 361
OBSERVATION_CUTOFF = (100.0, 200.0)
BAD_CUTOFF = 0.5

# PROB_ERROR with the CalcTrueQuality-local [0]=0.8 override (:2600-2604)
PROB_ERROR = np.empty(128, dtype=np.float64)
PROB_ERROR[0] = 0.8
PROB_ERROR[1] = 0.7
for _q in range(2, 128):
    PROB_ERROR[_q] = 10.0 ** (-0.1 * _q)
INV_PROB_ERROR = 1.0 / PROB_ERROR
INV_PROB_ERROR[0] = 1.25

# baseToNum over ascii (:2595): A/a 0, C/c 1, G/g 2, T/t/U/u 3, E 4, else 5
BASE_TO_NUM = np.full(256, 5, dtype=np.int64)
for _b, _v in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"TtUu", 3), (b"E", 4)):
    for _c in _b:
        BASE_TO_NUM[_c] = _v

# matrix family -> (dims after pairnum, filename stem)
MATRIX_DIMS = {
    "qbp": (QMAX2, BMAX, LENMAX),
    "qb012": (QMAX2, BMAX, BMAX, BMAX),
    "qb123": (QMAX2, BMAX, BMAX, BMAX),
    "qb234": (QMAX2, BMAX, BMAX, BMAX),
    "q102": (QMAX2, QMAX2, QMAX2),
    "qp": (QMAX2, LENMAX),
    "q": (QMAX2,),
    "p": (LENMAX,),
}
USE_PASS0 = ("qbp", "qb012", "qb123", "qb234")
USE_PASS1 = ("qbp",)


def matrix_path(directory: str, name: str, pass_: int) -> str:
    return os.path.join(directory, f"{name}matrix_p{pass_}.txt.gz")


@dataclass
class MatrixSet:
    """good/bad count matrices for one pass (GBMatrixSet analog)."""

    pass_: int
    families: tuple = USE_PASS0
    good: dict = field(default_factory=dict)
    bad: dict = field(default_factory=dict)

    def __post_init__(self):
        fams = set(self.families) | {"p"}
        for f in fams:
            shape = (2,) + MATRIX_DIMS[f]
            self.good[f] = np.zeros(shape, dtype=np.int64)
            self.bad[f] = np.zeros(shape, dtype=np.int64)

    # ---- counting ----

    def count_read(
        self,
        bases: bytes,
        quals: np.ndarray,
        match: bytes,
        pairnum: int,
        reverse: bool,
        count_indels: bool = True,
    ) -> None:
        """Accumulate one aligned read (processLocal :1306-1534)."""
        if reverse:
            # restore sequencing orientation (:1355-1358; SAM stores the
            # reverse complement for minus-strand alignments)
            comp = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")
            bases = bases.translate(comp)[::-1]
            quals = quals[::-1]
            match = match[::-1]
        m = np.frombuffer(match, dtype=np.uint8)
        is_d = (m == ord("D")) | (m == ord("d"))
        qpos = np.cumsum(~is_d) - 1  # read position of each match op
        n = len(quals)
        q = quals.astype(np.int64)
        b = np.frombuffer(bases, dtype=np.uint8)

        # context planes indexed by read position
        q0 = np.full(n, QEND, dtype=np.int64)
        q0[1:] = np.clip(q[:-1], 0, QMAX)
        q2 = np.full(n, QEND, dtype=np.int64)
        q2[:-1] = np.clip(q[1:], 0, QMAX)
        ascii_e = ord("E")
        bpad = np.full(n + 4, ascii_e, dtype=np.uint8)
        bpad[2 : 2 + n] = b
        n0 = BASE_TO_NUM[bpad[0:n]]
        n1 = BASE_TO_NUM[bpad[1 : n + 1]]
        n2 = BASE_TO_NUM[bpad[2 : n + 2]]
        n3 = BASE_TO_NUM[bpad[3 : n + 3]]
        n4 = BASE_TO_NUM[bpad[4 : n + 4]]
        pos = np.minimum(np.arange(n, dtype=np.int64), LENMAX - 1)
        defined = (n2 >= 0) & (n2 <= 3)

        # per-op classification (:1395-1530)
        mm = m == ord("m")
        mi = (m == ord("I")) | (m == ord("i"))
        ms = (m == ord("S")) | (m == ord("V"))
        skip = (m == ord("N")) | (m == ord("C")) | is_d
        if count_indels:
            good_op = mm
            prev_d = np.zeros(len(m), dtype=bool)
            prev_d[1:] = is_d[:-1]
            next_d = np.zeros(len(m), dtype=bool)
            next_d[:-1] = is_d[1:]
            near_d = mm & (prev_d | next_d)
            bad_op = mi | ms
        else:
            good_op = mm | mi
            near_d = np.zeros(len(m), dtype=bool)
            bad_op = ms

        ok = ~skip & defined[qpos]
        gsel = qpos[good_op & ok]
        gincr = np.where(near_d[good_op & ok], 1, 2)
        bsel = qpos[bad_op & ok]
        nearsel = qpos[near_d & ok]

        for fam in self.good:
            idx = self._indices(fam, q, q0, q2, n0, n1, n2, n3, n4, pos)
            gidx = tuple(a[gsel] for a in idx)
            np.add.at(self.good[fam], (pairnum,) + gidx, gincr)
            if len(bsel):
                bidx = tuple(a[bsel] for a in idx)
                np.add.at(self.bad[fam], (pairnum,) + bidx, 2)
            if len(nearsel):
                nidx = tuple(a[nearsel] for a in idx)
                np.add.at(self.bad[fam], (pairnum,) + nidx, 1)

    @staticmethod
    def _indices(fam, q, q0, q2, n0, n1, n2, n3, n4, pos):
        q1 = np.clip(q, 0, QMAX2 - 1)
        if fam == "qbp":
            return (q1, n2, pos)
        if fam == "qb012":
            return (q1, n0, n1, n2)
        if fam == "qb123":
            return (q1, n1, n2, n3)
        if fam == "qb234":
            return (q1, n2, n3, n4)
        if fam == "q102":
            return (q1, q0, q2)
        if fam == "qp":
            return (q1, pos)
        if fam == "q":
            return (q1,)
        if fam == "p":
            return (pos,)
        raise ValueError(fam)

    # ---- serialization (writeMatrix :491-545 text format) ----

    def write(self, directory: str) -> None:
        from ..io.readwrite import open_output

        os.makedirs(directory, exist_ok=True)
        for fam in sorted(self.good):
            g, b = self.good[fam], self.bad[fam]
            total = g + b
            nz = np.nonzero(total)
            with open_output(matrix_path(directory, fam, self.pass_)) as fh:
                rows = []
                for cell in zip(*nz):
                    s = total[cell]
                    rows.append(
                        "\t".join(str(int(x)) for x in cell)
                        + f"\t{int(s)}\t{int(b[cell])}\n"
                    )
                fh.write("".join(rows).encode())

    @classmethod
    def load(cls, directory: str, pass_: int, families=None):
        from ..io.readwrite import open_input

        families = families or (USE_PASS0 if pass_ == 0 else USE_PASS1)
        ms = cls(pass_, families=tuple(families))
        for fam in list(ms.good):
            path = matrix_path(directory, fam, pass_)
            if not os.path.exists(path):
                if fam == "p":  # optional
                    del ms.good[fam], ms.bad[fam]
                    continue
                raise FileNotFoundError(
                    f"missing calibration matrix {path}; run calctruequality"
                )
            sums = ms.good[fam]
            bad = ms.bad[fam]
            with open_input(path) as fh:
                for line in fh.read().decode().splitlines():
                    parts = line.split("\t")
                    cell = tuple(int(x) for x in parts[:-2])
                    sums[cell] = int(parts[-2])
                    bad[cell] = int(parts[-1])
            # stored column is sum; keep good=sum for the weighted pool
        return ms


class Recalibrator:
    """Applies loaded matrices to quality arrays (CountMatrixSet analog).

    estimateErrorProbWeighted (:2220-2326): pool raw (sum, bad) counts over
    all loaded matrices, add the smoothing pseudo-counts, convert to phred.
    """

    def __init__(self, matrix_dir: str, passes: int = 1):
        self.sets = [MatrixSet.load(matrix_dir, p) for p in range(passes)]

    def recalibrate(
        self, bases: np.ndarray, quals: np.ndarray, lengths: np.ndarray,
        pairnum: int = 0,
    ) -> np.ndarray:
        """Vectorized over a padded batch: bases codes [B,L] (0..3, 4=N),
        quals [B,L] -> new quals [B,L]."""
        out = quals
        for ms in self.sets:
            out = self._apply(ms, bases, out, lengths, pairnum)
        return out

    def _apply(self, ms, bases, quals, lengths, pairnum):
        B, L = bases.shape
        q = quals.astype(np.int64)
        valid = np.arange(L)[None, :] < lengths[:, None]
        # base-context planes: code 0..3 direct, N -> 5, off-end -> 4 ('E')
        n_plane = np.where(bases < 4, bases.astype(np.int64), 5)

        def shifted(offset):
            # read position + offset, 'E'(4) outside [0, len)
            p = np.full((B, L), 4, dtype=np.int64)
            if offset == 0:
                src = n_plane
                p[:] = src
            elif offset < 0:
                p[:, -offset:] = n_plane[:, :offset]
            else:
                p[:, :-offset] = n_plane[:, offset:]
            # positions beyond the read length are 'E'
            pos = np.arange(L)[None, :] + offset
            inside = (pos >= 0) & (pos < lengths[:, None])
            return np.where(inside, p, 4)

        n0, n1, n2 = shifted(-2), shifted(-1), shifted(0)
        n3, n4 = shifted(1), shifted(2)
        q1 = np.clip(q, 0, QMAX2 - 1)
        q0 = np.full((B, L), QEND, dtype=np.int64)
        q0[:, 1:] = np.clip(q[:, :-1], 0, QMAX)
        q2full = np.full((B, L), QEND, dtype=np.int64)
        q2full[:, :-1] = np.clip(q[:, 1:], 0, QMAX)
        last = np.maximum(lengths - 1, 0)
        at_last = np.arange(L)[None, :] >= last[:, None]
        q2full = np.where(at_last, QEND, q2full)
        pos = np.minimum(np.arange(L, dtype=np.int64), LENMAX - 1)
        pos = np.broadcast_to(pos, (B, L))

        sums = np.zeros((B, L), dtype=np.float64)
        bad = np.zeros((B, L), dtype=np.float64)
        for fam in ms.good:
            if fam == "p":
                continue
            idx = MatrixSet._indices(
                fam, q.ravel(), q0.ravel(), q2full.ravel(), n0.ravel(),
                n1.ravel(), n2.ravel(), n3.ravel(), n4.ravel(), pos.ravel(),
            )
            sums += ms.good[fam][(pairnum,) + idx].reshape(B, L)
            bad += ms.bad[fam][(pairnum,) + idx].reshape(B, L)

        cutoff = OBSERVATION_CUTOFF[ms.pass_]
        expected = PROB_ERROR[q1]
        fake_sum = np.full((B, L), cutoff)
        fake_bad = expected * cutoff
        low = fake_bad < BAD_CUTOFF
        fake_bad = np.where(low, BAD_CUTOFF, fake_bad)
        fake_sum = np.where(low, BAD_CUTOFF * INV_PROB_ERROR[q1], fake_sum)
        prob = (bad + fake_bad) / (sums + fake_sum)

        # probErrorToPhred (align2/QualityTools.java): clamp [0, QMAX],
        # floor 60 below 1e-6, then max(2, .) for defined bases
        phred = np.where(
            prob >= 1.0, 0.0,
            np.where(prob <= 1e-6, 60.0, -10.0 * np.log10(prob)),
        )
        q2new = np.clip(np.round(phred), 0, QMAX).astype(quals.dtype)
        q2new = np.maximum(q2new, 2)
        q2new = np.where(bases >= 4, 0, q2new)  # undefined base -> 0
        return np.where(valid, q2new, 0).astype(quals.dtype)


@dataclass
class CTQConfig:
    in_files: list = field(default_factory=list)
    path: str = "."
    passes: int = 2
    count_indels: bool = True


def parse_args(argv) -> CTQConfig:
    a = tokenize(argv)
    c = CTQConfig()
    v = a.get("in", "in1")
    if v:
        c.in_files = v.split(",")
    c.path = a.get("path", default=".") or "."
    c.passes = a.get_int("passes", default=2)
    c.count_indels = a.get_bool("indels", "countindels", default=True)
    return c


class CalcTrueQuality:
    def __init__(self, cfg: CTQConfig):
        self.cfg = cfg

    def run(self):
        cfg = self.cfg
        recal = None
        for pass_ in range(cfg.passes):
            fams = USE_PASS0 if pass_ == 0 else USE_PASS1
            ms = MatrixSet(pass_, families=fams)
            if pass_ > 0:
                recal = Recalibrator(cfg.path, passes=pass_)
            for fname in cfg.in_files:
                self._count_file(fname, ms, recal, pass_)
            ms.write(cfg.path)
        return self

    def _count_file(self, fname, ms, recal, pass_):
        from ..io.sam_read import parse_cigar

        for rec in iter_sam(fname):
            if rec.flag & 0x4 or rec.secondary or rec.cigar in ("*", ""):
                continue
            match = self._match_from_cigar(rec)
            if match is None:  # plain-M CIGAR: no per-base correctness
                continue
            quals = (
                np.frombuffer(rec.qual, np.uint8).astype(np.int64) - 33
            )
            if recal is not None:
                codes = BASE_TO_CODE[np.frombuffer(rec.seq, np.uint8)]
                quals = recal.recalibrate(
                    codes[None, :],
                    quals[None, :],
                    np.array([len(rec.seq)]),
                    pairnum=rec.pairnum,
                )[0].astype(np.int64)
            ms.count_read(
                rec.seq,
                quals,
                match,
                pairnum=rec.pairnum,
                reverse=bool(rec.flag & 0x10),
                count_indels=self.cfg.count_indels,
            )

    @staticmethod
    def _match_from_cigar(rec):
        """Match string from an extended (=/X) CIGAR; None for plain M."""
        from ..io.sam_read import parse_cigar

        out = bytearray()
        for n, op in parse_cigar(rec.cigar):
            if op == "=":
                out += b"m" * n
            elif op == "X":
                out += b"S" * n
            elif op == "I":
                out += b"I" * n
            elif op in ("D", "N"):
                out += b"D" * n
            elif op == "S":
                out += b"C" * n
            elif op == "H":
                pass
            elif op == "M":
                return None
            else:
                return None
        return bytes(out)


def main(argv):
    CalcTrueQuality(parse_args(argv)).run()
