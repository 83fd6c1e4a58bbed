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

Also ported: ecco (error correction by overlap: both mates take the
merged consensus and come out unmerged), extend2=N and ecct (the input's
k-mers counted on the device, then host Tadpole extension of unmerged
pairs and Tadpole correction before the scan; tadpole_ecc.EccEngine)
and nn (the CellNet gate: mate selection widened and collecting its
candidate stats, the bundled bbmerge.bbnet applied on the device).
tpshards=N cuts each batch's insert scan over N devices (`_scan`,
parallel/sharded_count.py `sharded_overlap_step`), with the same output.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.parser import test_output_files, tokenize
from ..device import resolve_device
from ..io.batch import ReadBatch
from ..io.fastq import FastqReader, FastqWriter, paired_reader
from ..ops.join import join_reads_np
from ..ops.overlap import (
    bbmerge_nn_features,
    calc_min_overlap_by_entropy_torch,
    expected_mismatches_np,
    expected_mismatches_torch,
    expected_tip_errors_np,
    overlap_and_mate,
    probability_np,
    probability_torch,
)
from ..ops.overlap_scan import overlap_counts

RET_NO_SOLUTION = -1
RET_AMBIG = -2
RET_BAD = -3
RET_SHORT = -4
RET_LONG = -5
#: a net score this close to the cutoff may fall on either side of it
#: when its float32 sums run in another order (another device or library)
NN_NEAR = 1e-5


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
    extend2: int = 0  # kmer-extend unmerged pairs and retry (BBMerge:653)
    ecct: bool = False  # tadpole error-correct reads pre-overlap (:657)
    extend_k: int = 31
    #: CellNet gate (BBMerge.java nn= flag :425): score each candidate
    #: merge with the bundled bbmerge.bbnet; below-cutoff -> ambiguous
    nn: bool = False
    net_file: str | None = None
    net_cutoff: float | None = None  # default: the net's stored ##ctf
    #: quality-weighted overlap scoring (BBMerge.java useQuality :3189,
    #: default true): when quals exist, mateByOverlapRatioJava_WithQualities
    #: is the production path (BBMergeOverlapper.java:122)
    use_quality: bool = True
    #: tpshards=N: dp-shard the insert scan over an N-device mesh
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
    c.extend_k = min(a.get_int("k", default=31), 31)
    c.nn = a.get_bool("nn", "makevector", default=False)
    c.net_file = a.get("net")
    nc = a.get("netcutoff", "cutoff")
    c.net_cutoff = float(nc) if nc is not None else None
    c.device = a.get("device", default="cuda")
    test_output_files(
        a.get_bool("overwrite", "ow", default=True),
        c.out, c.outu1, c.outu2, c.ihist,
        inputs=(c.in1, c.in2),
    )
    return c


class BBMerge:
    def _overlap_mesh(self):
        """dp mesh for tpshards=N (lazy, cached); None when unsharded."""
        if not self.cfg.tpshards or self.cfg.tpshards <= 1:
            return None
        if getattr(self, "_mesh_c", None) is None:
            from ..parallel.mesh import local_devices, make_mesh

            self._mesh_c = make_mesh(
                n_dp=self.cfg.tpshards,
                devices=local_devices(self.device)[: self.cfg.tpshards],
            )
        return self._mesh_c

    def _scan(self, a, b_rc, alens, blens, min_insert0: int, n_inserts: int):
        """The insert scan (ops/overlap_scan.py `overlap_counts`); under
        tpshards=N dp-sharded over the mesh, the pairs padded to a
        multiple of dp with empty ones (codes 0, length 0) that are
        dropped again."""
        mesh = self._overlap_mesh()
        if mesh is None:
            return overlap_counts(a, b_rc, alens, blens, min_insert0, n_inserts)
        from ..parallel.sharded_count import sharded_overlap_step

        B0 = a.shape[0]
        pad = (-B0) % mesh.shape["dp"]

        def padb(x):
            return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) if pad else x

        outs = sharded_overlap_step(mesh, min_insert0, n_inserts)(
            padb(a), padb(b_rc), padb(alens), padb(blens)
        )
        return tuple(x[:B0] for x in outs)
    def __init__(self, cfg: BBMergeConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        # a copy: the presets table stays as defined for the next run
        self.preset = dataclasses.replace(PRESETS[cfg.preset]).resolve()
        self.ecc_engine = None
        self.merged_by_extension = 0
        self.net = None
        #: names of the pairs whose net score lay within NN_NEAR of the
        #: cutoff: a float32 sum in another order may decide them otherwise
        self.nn_near = []
        if cfg.nn:
            from ..ml.cellnet import parse_bbnet

            # the JAX package's bundled net, read by path, not copied
            path = cfg.net_file or os.path.join(
                os.path.dirname(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))),
                "bbtools_tpu", "resources", "bbmerge.bbnet",
            )
            self.net = parse_bbnet(path)
            self.net.device = str(self.device)
            self.net_cutoff = (
                cfg.net_cutoff
                if cfg.net_cutoff is not None
                else self.net.cutoff
            )
            # MAKE_VECTOR widens the scan so the net sees marginal
            # candidates too (BBMergeOverlapper.java:423 maxRatio=.7,
            # :456 extraMult=4); on the run's own copy of the preset
            self.preset.max_ratio = 0.7
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
        res = overlap_and_mate(
            a_d, brc_d, al_d, bl_d, p.min_insert0, n_inserts,
            mo0, self._dev(mo), p.min_insert0, p.min_insert,
            p.max_ratio, p.min_second_ratio, p.ratio_margin,
            p.ratio_offset,
            extra_mult=4.0 if self.net is not None else 1.2,
            collect=self.net is not None,
            aq=aq_d if use_q else None, bq_rev=bq_d if use_q else None,
            scan=self._scan,
        )
        insert, bad_int, ambig = (x.cpu().numpy() for x in res[:3])
        nn_stats = None
        if self.net is not None:
            nn_stats = {k: v.cpu().numpy() for k, v in res[3].items()}
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
        # CellNet gate (BBMerge.java:2561-2596): score every candidate
        # merge; below-cutoff verdicts become ambiguous
        if self.net is not None:
            ambig = self._nn_gate(b1, b2, b_rc, insert, ambig, min_overlap, nn_stats)
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

    def _nn_gate(self, b1, b2, b_rc, insert, ambig, min_overlap, nn_stats):
        """The net's verdict on each candidate (insert > 0): the feature
        vector on the host, as the JAX package computes it, and the net
        on the run's device. Returns ambig with the rejected candidates
        set."""
        p = self.preset
        cand = insert > 0
        if not cand.any():
            return ambig
        alens = b1.lengths.astype(np.int64)
        blens = b2.lengths.astype(np.int64)
        maxb = np.minimum(np.maximum(alens, blens), alens + blens - p.min_insert)
        if b1.quals is not None:
            bq_rev = _rev_quals(b2)
            r1ee = expected_tip_errors_np(b1.bases, b1.quals, b1.lengths, maxb)
            r2ee = expected_tip_errors_np(b2.bases, b2.quals, b2.lengths, maxb)
            at = np.where(cand, insert, 1)
            be = expected_mismatches_np(b1.bases, b_rc, b1.quals, bq_rev, alens, blens, at)
            pr = probability_np(b1.bases, b_rc, b1.quals, bq_rev, alens, blens, at)
        else:
            r1ee = r2ee = be = np.zeros(b1.n, np.float32)
            pr = np.full(b1.n, np.float32(0.1))
        feats = bbmerge_nn_features(
            alens.astype(np.float32), blens.astype(np.float32),
            np.asarray(min_overlap, np.float32), r1ee, r2ee, nn_stats, be, pr,
        )
        score = self.net.apply(feats).reshape(-1)
        cutoff = np.float32(self.net_cutoff)
        near = cand & (np.abs(score - cutoff) <= np.float32(NN_NEAR))
        self.nn_near += [b1.ids[i] for i in np.flatnonzero(near)]
        return ambig | (cand & (score < cutoff))

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

    def _build_spectrum(self):
        """Count input kmers for extension/ecc (the loadKmers pre-pass the
        reference runs when extendRight2/eccTadpole are set, BBMerge:824):
        each batch counted on the run's device."""
        from ..ops.kmer_count import KmerSpectrum, count_batch
        from .tadpole import SpectrumTable
        from .tadpole_ecc import EccConfig, EccEngine

        cfg = self.cfg
        spec = KmerSpectrum(cfg.extend_k)
        for path in (cfg.in1, cfg.in2):
            if not path:
                continue
            for b in FastqReader(path, batch_reads=cfg.batch_reads):
                v, c = count_batch(b.bases, b.lengths, cfg.extend_k, self.device)
                spec.add_batch(v, c)
        spec.flush()
        table = SpectrumTable(spec, cfg.extend_k)
        self.ecc_engine = EccEngine(table, cfg.extend_k, EccConfig())

    def _extend_rows(self, b: ReadBatch, rows: np.ndarray, dist: int):
        """Extend each selected read 3' by up to `dist` bases via the kmer
        table (extendToRight2 walk); returns new padded arrays."""
        eng = self.ecc_engine
        k = self.cfg.extend_k
        L = b.bases.shape[1]
        newL = L + dist
        bases = np.full((b.n, newL), 4, dtype=b.bases.dtype)
        bases[:, :L] = b.bases
        quals = None
        if b.quals is not None:
            quals = np.zeros((b.n, newL), dtype=b.quals.dtype)
            quals[:, :L] = b.quals
        lengths = b.lengths.astype(np.int64).copy()
        for i in rows:
            ln = int(lengths[i])
            if ln < k:
                continue
            tail = bases[i, ln - k : ln]
            if (tail >= 4).any():
                continue
            kmer = 0
            for c in tail:
                kmer = (kmer << 2) | int(c)
            ext, n_ext = eng._extend_right(kmer, dist)
            if n_ext:
                bases[i, ln : ln + n_ext] = ext
                if quals is not None:
                    quals[i, ln : ln + n_ext] = 20
                lengths[i] += n_ext
        return ReadBatch(
            bases=bases,
            quals=quals if quals is not None else b.quals,
            lengths=lengths.astype(b.lengths.dtype),
            ids=b.ids,
            ordinal=b.ordinal,
            numeric_id0=b.numeric_id0,
        )

    def run(self):
        cfg = self.cfg
        t0 = time.time()
        if cfg.extend2 > 0 or cfg.ecct:
            self._build_spectrum()
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
                if cfg.ecct and self.ecc_engine is not None:
                    self.ecc_engine.correct_batch(b1.bases, b1.lengths, b1.quals)
                    self.ecc_engine.correct_batch(b2.bases, b2.lengths, b2.quals)
                result, ok, joined = self.process_batch(b1, b2)
                if cfg.extend2 > 0 and (~ok).any():
                    ok = self._merge_extended(b1, b2, result, ok, w_m)
                if cfg.ecco and joined is not None:
                    # error-correct by overlap: both reads take the
                    # consensus (BBMerge.errorCorrectWithInsert
                    # :1577-1625); the pair is emitted corrected, not
                    # merged
                    self._apply_ecco(b1, b2, result, ok, joined)
                    if w_m:
                        w_m.add(b1)
                    if w_u2:
                        w_u2.add(b2)
                    continue
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

    def _merge_extended(self, b1, b2, result, ok, w_m):
        """Extend the unmerged pairs' reads by up to extend2 bases and
        scan them again; credit only the pairs that merge now (their
        merged reads written to w_m). Returns ok with them set."""
        cfg = self.cfg
        rows = np.flatnonzero(~ok)
        e1 = self._extend_rows(b1, rows, cfg.extend2)
        e2 = self._extend_rows(b2, rows, cfg.extend2)
        r2nd, ok2, joined2 = self.process_batch(e1, e2, count_stats=False)
        newly = ok2 & ~ok  # credit only previously-unmerged pairs
        if not newly.any():
            return ok
        n_new = int(newly.sum())
        self.merged_by_extension += n_new
        self.merged += n_new
        self.no_solution -= int((newly & (result == RET_NO_SOLUTION)).sum())
        self.too_short -= int((newly & (result == RET_SHORT)).sum())
        self.ambiguous -= int((newly & (result == RET_AMBIG)).sum())
        ins2 = r2nd[newly]
        np.add.at(self.hist, np.minimum(ins2, len(self.hist) - 1), 1)
        self.insert_sum += int(ins2.sum())
        if w_m and joined2 is not None:
            w_m.add(joined2, newly)
        return ok | newly

    def _apply_ecco(self, b1, b2, result, ok, joined):
        """Overlay consensus back onto the original pair orientation."""
        import numpy as np

        for i in np.flatnonzero(ok):
            insert = int(result[i])
            n1 = int(b1.lengths[i])
            n2 = int(b2.lengths[i])
            lim1 = min(insert, n1)
            b1.bases[i, :lim1] = joined.bases[i, :lim1]
            if b1.quals is not None and joined.quals is not None:
                b1.quals[i, :lim1] = joined.quals[i, :lim1]
            if b1.ascii_bases is not None:
                b1.ascii_bases = None
            lim2 = min(insert, n2)
            tail = joined.bases[i, insert - lim2 : insert]
            rc = np.where(tail < 4, 3 - tail.astype(np.int16), 4).astype(np.uint8)
            b2.bases[i, :lim2] = rc[::-1]
            if b2.quals is not None and joined.quals is not None:
                b2.quals[i, :lim2] = joined.quals[i, insert - lim2 : insert][::-1]
            if b2.ascii_bases is not None:
                b2.ascii_bases = None

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
