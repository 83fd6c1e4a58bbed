"""BBMerge: paired-read overlap merging.

The PyTorch port of bbtools_tpu/models/bbmerge.py, itself a batched
re-design of jgi/BBMerge.java:52: the per-pair Java scan becomes a scan
over all candidate inserts on the device chosen by `device=` (cuda by
default; ops/overlap.py, with the insert-scan kernel csrc/overlap_scan.cu
and the table kernel csrc/lane_table.cu), followed by the exact
sequential accept/ambiguity state machine vectorized across the batch;
joining is a batched overlay on the host (ops/join.py).

Default path replicated: entropy-derived minOverlap (Tail r1 / Head r2,
k=3, minscore=39, jgi/BBMerge.java:2373-2388), quality-weighted ratio
mode when both reads carry qualities (useQuality default, :3189; the
non-quality ratio mode with usequality=f), gIncr=bIncr=0.95,
maxRatio=0.09, margin=5.5, offset=0.55, minSecondRatio=0.1 (:3279-3282),
efilter (ratio=6, offset=0.05) and pfilter (4e-5) (:3098-3104), the
strictness presets ladder (:1359-1476), RET codes (:3292-3300), and the
insert-size histogram.

Flags whose stage is not ported yet raise NotImplementedError naming
their ROADMAP item: extend2/ecct (k-mer extension and Tadpole correction,
A6b), ecco and nn (the CellNet gate) (A2/A5) and tpshards (A7).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.parser import test_output_files, tokenize
from ..device import resolve_device
from ..io.batch import ReadBatch
from ..io.fastq import FastqWriter, paired_reader
from ..ops.join import join_reads_np
from ..ops.overlap import (
    calc_min_overlap_by_entropy_torch,
    expected_mismatches_torch,
    overlap_and_mate,
    probability_torch,
)

RET_NO_SOLUTION = -1
RET_AMBIG = -2
RET_BAD = -3
RET_SHORT = -4
RET_LONG = -5


@dataclass
class Preset:
    max_ratio: float = 0.09
    ratio_margin: float = 5.5
    ratio_offset: float = 0.55
    min_second_ratio: float = 0.1
    efilter_ratio: float = 6.0
    efilter_offset: float = 0.05
    pfilter_ratio: float = 0.00004
    min_overlap: int = 11  # MIN_OVERLAPPING_BASES
    min_overlap0: int = 8  # MIN_OVERLAPPING_BASES_0
    ratio_reduction: int = 3
    min_insert: int = 15
    min_insert0: int = -1
    min_entropy_score: int = 39

    def resolve(self):
        if self.min_insert0 < 0:
            v = max(int(np.ceil(self.min_insert * 0.75)), 5, self.min_overlap0)
            self.min_insert0 = min(self.min_insert, v)
        return self


#: strictness ladder (jgi/BBMerge.java findOverlapUStrict..Loose :1359-1476)
PRESETS = {
    "default": Preset(),
    "ustrict": Preset(0.045, 12, 0.5, 0.16, 2, 0.03, 0.03, 14, 3, 0, 35, 20, 56),
    "vstrict": Preset(0.05, 12, 0.5, 0.16, 2, 0.05, 0.008, 12, 4, 0, 35, 25, 52),
    "strict": Preset(0.075, 7.5, 0.55, 0.12, 4, 0.05, 0.0008, 11, 5, 0, 35, 25, 42),
    "loose": Preset(0.11, 4.7, 0.45, 0.1, 8, 0.55, 0.00002, 5, 6, 0, 16, 16, 30),
    # vloose/xloose rows from the loose-family ladder
    # (jgi/BBMerge.java:238-300: maxratio/margin/offset/minsecondratio/
    # efilter/pfilter/minoverlap/minoverlap0/reduction/minentropy)
    "vloose": Preset(0.12, 3.0, 0.45, 0.08, 7.5, 0.55, 0.000004, 8, 9, 3, 16, 16, 28),
    "xloose": Preset(0.2, 2.0, 0.4, 0.08, 8, 0.55, 0.0000001, 8, 7, 2, 16, 16, 22),
}

@dataclass
class BBMergeConfig:
    in1: str | None = None
    in2: str | None = None
    interleaved: bool | None = None  # None = autodetect from headers
    out: str | None = None  # merged
    outu1: str | None = None  # unmerged r1
    outu2: str | None = None  # unmerged r2
    ihist: str | None = None
    preset: str = "default"
    min_insert: int | None = None
    max_read_length: int = -1
    ecco: bool = False
    use_entropy: bool = True
    batch_reads: int = 8192
    ziplevel: int | None = None
    extend2: int = 0  # k-mer extension of unmerged pairs (not ported, A6b)
    ecct: bool = False  # Tadpole correction before the scan (not ported, A6b)
    #: CellNet gate (BBMerge.java nn= flag :425; not ported, A2/A5)
    nn: bool = False
    #: quality-weighted overlap scoring (BBMerge.java useQuality :3189,
    #: default true): when quals exist, mateByOverlapRatioJava_WithQualities
    #: is the production path (BBMergeOverlapper.java:122)
    use_quality: bool = True
    #: tpshards=N multi-device mode (not ported, A7)
    tpshards: int = 0
    #: torch device of the scans: cuda (default), cuda:N or cpu
    device: str = "cuda"


def parse_args(argv: list[str]) -> BBMergeConfig:
    """The JAX package's flag surface (unknown flags are ignored, as
    there), plus `device=`."""
    a = tokenize(argv)
    c = BBMergeConfig()
    c.in1 = a.get("in", "in1")
    c.in2 = a.get("in2")
    c.interleaved = a.get_bool("interleaved", "int", default=None)
    c.out = a.get("out", "outm", "outmerged")
    c.outu1 = a.get("outu", "outu1", "outunmerged")
    c.outu2 = a.get("outu2")
    c.ihist = a.get("ihist", "hist")
    for name in ("ustrict", "vstrict", "strict", "loose", "vloose", "xloose"):
        if a.get_bool(name, default=False):
            c.preset = name if name in PRESETS else "loose"
    c.min_insert = a.get_int("mininsert", default=None)
    c.ecco = a.get_bool("ecco", default=False)
    c.use_entropy = a.get_bool("entropy", "useentropy", default=True)
    c.batch_reads = a.get_int("batchreads", default=8192)
    c.ziplevel = a.get_int("ziplevel", "zl", default=None)
    c.extend2 = a.get_int("extend2", "extendright2", "er2", default=0)
    c.ecct = a.get_bool("ecct", "ecctadpole", default=False)
    c.use_quality = a.get_bool("usequality", default=True)
    if a.get("ignorequality") is not None:
        c.use_quality = not a.get_bool("ignorequality", default=False)
    c.tpshards = a.get_int("tpshards", "shards", default=0)
    c.nn = a.get_bool("nn", "makevector", default=False)
    c.device = a.get("device", default="cuda")
    test_output_files(
        a.get_bool("overwrite", "ow", default=True),
        c.out, c.outu1, c.outu2, c.ihist,
        inputs=(c.in1, c.in2),
    )
    _reject_unported(c)
    return c


def _reject_unported(c: BBMergeConfig):
    """Raise for flags whose stage the port does not have yet."""
    unported = [
        (c.extend2 > 0, "extend2 (k-mer extension)", "A6b"),
        (c.ecct, "ecct (Tadpole error correction)", "A6b"),
        (c.ecco, "ecco (error correction by overlap)", "A2/A5"),
        (c.nn, "nn (the CellNet merge gate, ml/cellnet.py)", "A2/A5"),
        (c.tpshards > 1, "tpshards>1 (multi-GPU)", "A7"),
    ]
    for on, what, item in unported:
        if on:
            raise NotImplementedError(
                f"bbtools_torch bbmerge: {what} is not ported yet "
                f"(ROADMAP {item})"
            )


class BBMerge:
    def __init__(self, cfg: BBMergeConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        # a copy: the presets table stays as defined for the next run
        self.preset = dataclasses.replace(PRESETS[cfg.preset]).resolve()
        self.merged_by_extension = 0
        if cfg.min_insert is not None:
            self.preset.min_insert = cfg.min_insert
            self.preset.min_insert0 = -1
            self.preset.resolve()
        self.hist = np.zeros(2000, dtype=np.int64)
        self.pairs = 0
        self.merged = 0
        self.ambiguous = 0
        self.no_solution = 0
        self.too_short = 0
        self.insert_sum = 0

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the scan device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def find_inserts(self, b1: ReadBatch, b2: ReadBatch) -> np.ndarray:
        """Insert size per pair, or a RET_* code. b2 in original
        orientation. The scans run on the device; only [B] results come
        back to the host."""
        p = self.preset
        B = b1.n
        alens = b1.lengths.astype(np.int64)
        blens = b2.lengths.astype(np.int64)
        # reverse-complement r2 (codes + reversed quals)
        b_rc = _rc_batch(b2)
        quals = b1.quals is not None and b2.quals is not None
        a_d, brc_d = self._dev(b1.bases), self._dev(b_rc)
        al_d, bl_d = self._dev(alens), self._dev(blens)
        aq_d = self._dev(b1.quals) if quals else None
        bq_d = self._dev(_rev_quals(b2)) if quals else None
        # entropy-derived minOverlap (default mode: Tail of r1, Head of r2)
        if self.cfg.use_entropy:
            a_e = calc_min_overlap_by_entropy_torch(
                a_d, al_d, 3, p.min_entropy_score, True
            )
            b_e = calc_min_overlap_by_entropy_torch(
                self._dev(b2.bases), bl_d, 3, p.min_entropy_score, False
            )
            min_overlap = np.maximum(
                p.min_overlap,
                torch.maximum(a_e, b_e).cpu().numpy(),
            )
        else:
            min_overlap = np.full(B, p.min_overlap, dtype=np.int64)
        mo0 = p.min_overlap0 - p.ratio_reduction
        mo = min_overlap - p.ratio_reduction
        n_inserts = int(
            max(1, (alens + blens).max(initial=0) - p.min_insert0 + 1)
        )
        # quality-weighted scoring is the reference default whenever both
        # reads carry quals (BBMergeOverlapper.java:122)
        use_q = self.cfg.use_quality and quals
        insert, bad_int, ambig = (
            x.cpu().numpy()
            for x in overlap_and_mate(
                a_d, brc_d, al_d, bl_d, p.min_insert0, n_inserts,
                mo0, self._dev(mo), p.min_insert0, p.min_insert,
                p.max_ratio, p.min_second_ratio, p.ratio_margin,
                p.ratio_offset,
                aq=aq_d if use_q else None, bq_rev=bq_d if use_q else None,
            )
        )
        # efilter (BBMerge.findOverlap :1532-1536)
        has = (insert > 0) & ~ambig
        if p.efilter_ratio >= 0 and quals and has.any():
            exp = expected_mismatches_torch(
                a_d, brc_d, aq_d, bq_d, al_d, bl_d,
                self._dev(np.where(has, insert, 1)),
            ).cpu().numpy()
            kill = has & (
                (exp + np.float32(p.efilter_offset))
                * np.float32(p.efilter_ratio)
                < bad_int
            )
            ambig = ambig | kill
            has &= ~kill
        if p.pfilter_ratio > 0 and quals and has.any():
            prob = probability_torch(
                a_d, brc_d, aq_d, bq_d, al_d, bl_d,
                self._dev(np.where(has, insert, 1)),
            ).cpu().numpy()
            insert = np.where(has & (prob < np.float32(p.pfilter_ratio)), -1, insert)
        # result codes (processReadPair_inner :2694-2700)
        result = np.where(ambig, RET_AMBIG, insert)
        result = np.where(
            (result > 0) & (result < p.min_insert), RET_SHORT, result
        )
        if self.cfg.max_read_length > 0:
            result = np.where(
                result > self.cfg.max_read_length, RET_LONG, result
            )
        result = np.where(
            (result <= 0) & (result != RET_AMBIG) & (result != RET_SHORT)
            & (result != RET_LONG),
            RET_NO_SOLUTION,
            result,
        )
        # pairs too short to attempt (findOverlap :1494)
        min_len = np.minimum(alens, blens)
        result = np.where(
            (min_len < p.min_overlap) | (min_len < p.min_insert),
            RET_NO_SOLUTION,
            result,
        )
        return result

    def process_batch(self, b1: ReadBatch, b2: ReadBatch,
                      count_stats: bool = True):
        result = self.find_inserts(b1, b2)
        B = b1.n
        ok = result > 0
        if count_stats:
            self.pairs += B
            self.merged += int(ok.sum())
            self.ambiguous += int((result == RET_AMBIG).sum())
            self.too_short += int((result == RET_SHORT).sum())
            self.no_solution += int((result == RET_NO_SOLUTION).sum())
            ins = result[ok]
            np.add.at(self.hist, np.minimum(ins, len(self.hist) - 1), 1)
            self.insert_sum += int(ins.sum())
        joined = None
        if ok.any():
            b_rc = _rc_batch(b2)
            bq_rev = _rev_quals(b2)
            out_len = int(max(result.max(initial=1), 1))
            bases, quals, lengths = join_reads_np(
                b1.bases, b1.quals, b1.lengths.astype(np.int64),
                b_rc, bq_rev, b2.lengths.astype(np.int64),
                np.where(ok, result, 1), out_len,
            )
            joined = ReadBatch(
                bases=bases,
                quals=quals,
                lengths=lengths,
                ids=b1.ids,
                ordinal=b1.ordinal,
                numeric_id0=b1.numeric_id0,
            )
        return result, ok, joined

    def run(self):
        cfg = self.cfg
        t0 = time.time()
        pairs = paired_reader(
            cfg.in1, cfg.in2, interleaved=cfg.interleaved,
            batch_reads=cfg.batch_reads,
        )
        writers = [
            FastqWriter(path, ziplevel=cfg.ziplevel) if path else None
            for path in (cfg.out, cfg.outu1, cfg.outu2)
        ]
        w_m, w_u1, w_u2 = writers
        try:
            for b1, b2 in pairs:
                if b2 is None:
                    raise ValueError(
                        "BBMerge needs paired input (in1+in2 or interleaved)"
                    )
                result, ok, joined = self.process_batch(b1, b2)
                if w_m and joined is not None:
                    w_m.add(joined, ok)
                if w_u1:
                    w_u1.add(b1, ~ok)
                if w_u2:
                    w_u2.add(b2, ~ok)
        finally:
            for w in writers:
                if w:
                    w.close()
        if cfg.ihist:
            self.write_ihist(cfg.ihist)
        self.elapsed = time.time() - t0
        return self

    def write_ihist(self, path: str):
        """Insert-size histogram, BBMerge format: header stats + rows."""
        with open(path, "w") as fh:
            mean = self.insert_sum / max(self.merged, 1)
            fh.write(f"#Mean\t{mean:.3f}\n")
            nz = np.flatnonzero(self.hist)
            if len(nz):
                cum = np.cumsum(self.hist[self.hist > 0])
                med_idx = np.searchsorted(
                    np.cumsum(self.hist), (self.merged + 1) // 2
                )
                fh.write(f"#Median\t{med_idx}\n")
                fh.write(f"#Mode\t{int(np.argmax(self.hist))}\n")
            fh.write(f"#InsertCount\t{self.merged}\n")
            fh.write("#InsertSize\tCount\n")
            for i in np.flatnonzero(self.hist):
                fh.write(f"{i}\t{int(self.hist[i])}\n")

    def print_stats(self, stream=None):
        if stream is None:
            stream = sys.stderr
        if self.merged_by_extension:
            print(
                f"Merged by extension: \t{self.merged_by_extension}",
                file=stream,
            )
        p = self.pairs or 1
        print(f"Pairs:               \t{self.pairs}", file=stream)
        print(
            f"Joined:              \t{self.merged}      \t{100.0 * self.merged / p:.3f}%",
            file=stream,
        )
        print(
            f"Ambiguous:           \t{self.ambiguous}      \t{100.0 * self.ambiguous / p:.3f}%",
            file=stream,
        )
        print(
            f"No Solution:         \t{self.no_solution}      \t{100.0 * self.no_solution / p:.3f}%",
            file=stream,
        )
        print(
            f"Too Short:           \t{self.too_short}      \t{100.0 * self.too_short / p:.3f}%",
            file=stream,
        )
        if self.merged:
            print(
                f"Avg Insert:          \t{self.insert_sum / self.merged:.1f}",
                file=stream,
            )


def _rc_batch(b: ReadBatch) -> np.ndarray:
    """Reverse-complement each read's codes in place of its row (padding
    stays at the tail)."""
    B, L = b.bases.shape
    out = np.full((B, L), 4, dtype=np.uint8)
    lens = b.lengths.astype(np.int64)
    pos = np.arange(L, dtype=np.int64)[None, :]
    src = lens[:, None] - 1 - pos
    live = src >= 0
    rows = np.arange(B)[:, None]
    vals = b.bases[rows, np.clip(src, 0, L - 1)]
    comp = np.where(vals < 4, 3 - vals.astype(np.int16), 4).astype(np.uint8)
    out[live] = comp[live]
    return out


def _rev_quals(b: ReadBatch) -> np.ndarray:
    B, L = b.quals.shape
    out = np.zeros((B, L), dtype=np.uint8)
    lens = b.lengths.astype(np.int64)
    pos = np.arange(L, dtype=np.int64)[None, :]
    src = lens[:, None] - 1 - pos
    live = src >= 0
    rows = np.arange(B)[:, None]
    vals = b.quals[rows, np.clip(src, 0, L - 1)]
    out[live] = vals[live]
    return out


def main(argv=None):
    cfg = parse_args(argv if argv is not None else sys.argv[1:])
    tool = BBMerge(cfg)
    tool.run()
    tool.print_stats()
    return tool


if __name__ == "__main__":
    main()
