"""BBDuk — k-mer based contaminant filtering/trimming (flagship tool).

The PyTorch port of bbtools_tpu/models/bbduk.py, itself a batched
re-design of bbduk/BBDukS.java (:34 main, process :163) +
BBDukProcessorS (:740 process, per-pair pipeline :770-1460). The per-read
Java loops are batched torch scans (ops/bbduk_scan.py, ops/trim.py) on the
device chosen by `device=` (cuda by default) over SoA ReadBatch arrays;
the host logic is the JAX package's, unchanged: it orchestrates stage
order, applies trims, and routes reads to outputs, preserving the
reference's exact stage order and discard semantics:

  [recalibrate] -> force-trim -> minlen -> [remove] -> ktrim/kfilter ->
  minlen -> tpe -> qtrim -> minlen/maxlen -> maq/mbq/maxNs/consec
  filters -> entropy -> route to out/outm/outs -> [align side channel]

recalibrate=t applies calctruequality's matrices (models/
calctruequality.py, host numpy); align=t maps the surviving reads to a
small reference, phiX by default, on the device (models/sidechannel.py)
and writes them to alignout=. Flags replicate the bbduk.sh key=value
surface (subset; unknown flags raise). tpshards=N shards the k-mer
table over N devices (`enable_mesh`, parallel/sharded_index.py), with
the same output bytes; in a process group (parallel/distributed.py) the
stats are summed over the processes. profile=<dir> writes a
torch.profiler trace of the run, the card's kernels included
(utils/timer.py `device_profile`). Stats counters mirror BBDukS's
summary lines.
Every result the host needs leaves the device through an explicit
`.cpu().numpy()`.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.dna import encode
from ..core.parser import test_output_files, tokenize
from ..core.qualtools import PROB_ERROR, phred_to_prob_error
from ..device import resolve_device
from ..io.fasta import iter_fasta
from ..io.fastq import FastqWriter
from ..ops.bbduk_scan import KScanConfig, credit_id, kscan_combined, kscan_full
from ..ops.entropy import EntropyModel
from ..ops.kmer_index import BucketKmerIndex, build_ref_keys
from ..ops.lane_index import LaneKmerIndex
from ..ops.mm_match import MMKmerIndex
from ..ops.sort_join import SortJoinIndex
from ..ops.kmers import mid_mask_len_default, middle_mask
from ..ops.trim import apply_trim, optimal_trim

BIG = 999999999


# Keyword -> bundled resource file, mirroring BBDukParser.modifyRefPath
# (bbduk/BBDukParser.java:898-934). The files are the JAX package's
# bundled resources (bbtools_tpu/resources/), read by path so the port
# neither duplicates nor imports them.
RESOURCE_REFS = {
    "adapters": "adapters.fa",
    "phix": "phix2.fa.gz",
    "polya": "polyA.fa.gz",
    "polyt": "polyA.fa.gz",
    "lambda": "lambda.fa.gz",
    "phixadapters": "phix_adapters.fa.gz",
    "truseq": "truseq.fa.gz",
    "truseqrna": "truseq_rna.fa.gz",
    "nextera": "nextera.fa.gz",
    "artifacts": "sequencing_artifacts.fa.gz",
}


def resolve_ref_keyword(token: str) -> str:
    """`ref=adapters` / `ref=phix` / ... -> bundled resource file
    (BBDukParser.modifyRefPath keyword handling, BBDukParser.java:898)."""
    import os

    fname = RESOURCE_REFS.get(token.lower())
    if fname is not None:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        path = os.path.join(repo, "bbtools_tpu", "resources", fname)
        if os.path.exists(path):
            return path
        raise FileNotFoundError(f"bundled resource {token} not available")
    return token


@dataclass
class BBDukConfig:
    in1: str | None = None
    in2: str | None = None
    interleaved: bool | None = None  # None = autodetect from headers
    out1: str | None = None
    out2: str | None = None
    outm1: str | None = None
    outm2: str | None = None
    outs: str | None = None
    ref: list[str] = field(default_factory=list)
    literal: list[bytes] = field(default_factory=list)
    k: int = 27
    #: k>31 filter support (BBDukParser.java:164 kbig, BBDukProcessorS.
    #: countSetKmersBig :1726): the index stores 31-mers and a "big"
    #: kmer hit is a run of kbig-k+1 consecutive 31-mer hits
    kbig: int = -1
    #: rename=/findbestmatch= (BBDukParser.java:153,595): credit the
    #: most-hit scaffold; rename appends "\t<scaf>=<count>" per match
    rename: bool = False
    find_best_match: bool = False
    mink: int = 0
    hdist: int = 0
    hdist2: int | None = None
    qhdist: int = 0
    edist: int = 0
    edist2: int | None = None
    ktrim: str = "f"  # f/r/l/n
    mask_middle: bool = True
    rcomp: bool = True
    max_bad_kmers: int = 0  # mkh-1; minkmerhits default 1
    min_kmer_fraction: float = 0.0
    qtrim: str = "f"  # f/rl/r/l/w
    trimq: float = 6.0
    min_length: int = 10
    min_len_fraction: float = 0.0
    max_length: int = BIG
    max_ns: int = -1
    min_avg_quality: float = 0.0
    min_avg_quality_bases: int = 0
    min_base_quality: int = 0
    min_consecutive_bases: int = 0
    entropy_cutoff: float = -1.0
    entropy_window: int = 50
    entropy_k: int = 5
    entropy_trim: str = "f"  # f/l/r/rl
    entropy_mask: bool = False
    recalibrate: bool = False
    recal_path: str = "."
    recal_passes: int = 2
    force_trim_left: int = 0
    force_trim_right: int = 0
    force_trim_right2: int = 0
    force_trim_modulo: int = 0
    #: homopolymer trims/filters (BBDuk2.java:2239-2300, trimPoly
    #: :3999, detectPolyLeft :4014; Parser.parsePoly t->2)
    trim_polya: int = 0
    trim_polyg_left: int = 0
    trim_polyg_right: int = 0
    trim_polyc_left: int = 0
    trim_polyc_right: int = 0
    filter_polyg: int = 0
    filter_polyc: int = 0
    max_non_poly: int = 2
    restrict_left: int = 0
    restrict_right: int = 0
    remove_if_either_bad: bool = True
    trim_pairs_evenly: bool = False
    trim_by_overlap: bool = False
    kmask_lowercase: bool = False
    trim_pad: int = 0
    ktrim_exclusive: bool = False
    skip_r1: bool = False
    skip_r2: bool = False
    speed: int = 0
    qskip: int = 1
    # phiX side-channel aligner (SideChannel4, aligner/SideChannel4.java)
    align: bool = False
    align_ref: str | None = None
    align_out: str | None = None
    align_k1: int = 17
    align_k2: int = 13
    align_minid1: float = 0.66
    align_minid2: float = 0.56
    align_mm1: int = 1
    align_mm2: int = 0
    stats: str | None = None
    json_out: bool = False
    qhist: str | None = None
    lhist: str | None = None
    gchist: str | None = None
    aqhist: str | None = None
    bhist: str | None = None
    batch_reads: int = 16384
    ordered: bool = True
    ziplevel: int | None = None
    #: multi-device mode: shard the k-mer table over `tp_shards` devices
    #: (kmer%WAYS) with reads data-parallel over the rest of the mesh;
    #: 1 = off
    tp_shards: int = 1
    #: torch device of the scans: cuda (default), cuda:N or cpu
    device: str = "cuda"

    # resolved at setup
    mid_mask_len: int = 0
    use_short_kmers: bool = False

    def resolve(self):
        if self.hdist2 is None:
            self.hdist2 = self.hdist
        self.use_short_kmers = self.mink > 0 and self.mink < self.k
        if self.use_short_kmers and self.mask_middle:
            # maskMiddle disabled when useShortKmers (BBDukParser.java:291)
            self.mask_middle = False
        self.mid_mask_len = mid_mask_len_default(self.k, self.mask_middle)
        if self.kbig > self.k and (
            self.ktrim in ("l", "r", "n") or self.speed > 0 or self.qskip > 1
        ):
            # kmer-trimming/masking (and speed/qskip) cap K at 31
            # (BBDukParser.java:207-224 warn-and-reduce)
            import sys as _sys

            print(
                f"WARNING: K has been reduced from {self.kbig} to "
                f"{self.k} (kbig is filter-only).",
                file=_sys.stderr,
            )
            self.kbig = self.k
        return self

    @property
    def ktrim_left(self) -> bool:
        return self.ktrim == "l"

    @property
    def ktrim_right(self) -> bool:
        return self.ktrim == "r"

    @property
    def ktrim_n(self) -> bool:
        return self.ktrim == "n"

    @property
    def kmer_trimming(self) -> bool:
        return self.ktrim in ("l", "r", "n")

    @property
    def qtrim_left(self) -> bool:
        return self.qtrim in ("l", "rl", "lr", "t")

    @property
    def qtrim_right(self) -> bool:
        return self.qtrim in ("r", "rl", "lr", "t")

    @property
    def mid_mask_bits(self) -> int:
        return middle_mask(self.k, self.mid_mask_len)


def parse_args(argv: list[str]) -> BBDukConfig:
    a = tokenize(argv)
    c = BBDukConfig()
    handled = set()

    def h(*names):
        handled.update(names)
        return names

    a.get(*h("showtimes", "xtime", "profile"))  # handled by main()
    c.speed = a.get_int(*h("speed"), default=0)
    c.qskip = a.get_int(*h("qskip"), default=1)
    c.tp_shards = a.get_int(*h("tpshards", "shards", "ways"), default=1)
    c.in1 = a.get(*h("in", "in1"))
    c.in2 = a.get(*h("in2"))
    c.out1 = a.get(*h("out", "out1", "outu", "outu1"))
    c.out2 = a.get(*h("out2", "outu2"))
    c.outm1 = a.get(*h("outm", "outm1", "outb", "outmatch"))
    c.outm2 = a.get(*h("outm2", "outb2"))
    c.outs = a.get(*h("outs", "outsingle"))
    c.ref = [resolve_ref_keyword(r) for r in a.get_list(*h("ref"))]
    c.literal = [s.encode() for s in a.get_list(*h("literal"))]
    c.k = a.get_int(*h("k"), default=27)
    if c.k > 31:
        # kbig mechanism (BBDukParser.java:164): the table stores
        # 31-mers; countSetKmersBig semantics apply at filter time
        c.kbig = c.k
        c.k = 31
    c.rename = a.get_bool(*h("rename"), default=False)
    c.find_best_match = a.get_bool(
        *h("findbestmatch", "fbm"), default=False
    ) or c.rename
    if c.find_best_match and c.kbig > c.k:
        raise ValueError(
            "K must be less than 32 in 'findBestMatch'/rename mode"
        )
    c.mink = a.get_int(*h("mink"), default=0) or 0
    c.hdist = a.get_int(*h("hdist", "hammingdistance"), default=0)
    c.hdist2 = a.get_int(*h("hdist2", "hammingdistance2"), default=None)
    c.qhdist = a.get_int(*h("qhdist", "queryhammingdistance"), default=0)
    c.edist = a.get_int(*h("edist", "editdistance"), default=0)
    c.edist2 = a.get_int(*h("edist2", "editdistance2"), default=None)
    # side-channel flags (BBDukParser.java:817-834)
    c.align = a.get_bool(*h("align"), default=False)
    c.align_ref = a.get(*h("alignref", "sideref"))
    c.align_out = a.get(*h("alignout", "sideout"))
    c.align_k1 = a.get_int(*h("alignk", "sidek", "alignk1", "sidek1"), default=17)
    c.align_k2 = a.get_int(*h("alignk2", "sidek2"), default=13)
    c.align_minid1 = a.get_float(*h("alignminid", "alignminid1", "sideminid"), default=0.66)
    c.align_minid2 = a.get_float(*h("alignminid2", "sideminid2"), default=0.56)
    c.align_mm1 = a.get_int(*h("alignmm1", "alignmidmask1", "sidemm1"), default=1)
    c.align_mm2 = a.get_int(*h("alignmm2", "alignmidmask2", "sidemm2"), default=0)
    # align=(align || alignRef!=null), default ref phix (BBDukParser:320,1466)
    c.align = c.align or c.align_ref is not None
    if c.align and c.align_ref is None:
        c.align_ref = "phix"
    kt = a.get(*h("ktrim"))
    if kt is not None:
        kt = kt.lower()
        c.ktrim = {"left": "l", "right": "r", "false": "f", "true": "r"}.get(
            kt, kt
        )
    c.mask_middle = a.get_bool(*h("maskmiddle", "mm"), default=True)
    c.rcomp = a.get_bool(*h("rcomp", "rc"), default=True)
    mkh = a.get_int(*h("minkmerhits", "mkh", "minhits"), default=1)
    c.max_bad_kmers = mkh - 1
    c.min_kmer_fraction = a.get_float(*h("minkmerfraction", "mkf"), default=0.0)
    qt = a.get(*h("qtrim"))
    if qt is not None:
        qt = qt.lower()
        c.qtrim = {"true": "rl", "t": "rl", "false": "f", "both": "rl"}.get(qt, qt)
    c.trimq = a.get_float(*h("trimq"), default=6.0)
    c.min_length = a.get_int(*h("minlength", "minlen", "ml"), default=10)
    c.min_len_fraction = a.get_float(
        *h("minlenfraction", "mlf"), default=0.0
    )
    c.max_length = a.get_int(*h("maxlength", "maxlen"), default=BIG)
    c.max_ns = a.get_int(*h("maxns"), default=-1)
    c.min_avg_quality = a.get_float(*h("minavgquality", "maq"), default=0.0)
    c.min_avg_quality_bases = a.get_int(*h("maqb"), default=0)
    c.min_base_quality = a.get_int(*h("minbasequality", "mbq"), default=0)
    c.min_consecutive_bases = a.get_int(*h("minconsecutivebases", "mcb"), default=0)
    c.entropy_cutoff = a.get_float(*h("entropy", "entropyfilter"), default=-1.0)
    et = a.get(*h("entropytrim", "etrim"))
    if et:
        c.entropy_trim = {"true": "rl", "t": "rl", "lr": "rl"}.get(
            et.lower(), et.lower()
        )
        if c.entropy_trim not in ("f", "false", "l", "r", "rl"):
            raise ValueError(
                f"entropytrim={et}: expected f, l, r, or rl"
            )
        if c.entropy_trim == "false":
            c.entropy_trim = "f"
    c.entropy_mask = a.get_bool(*h("entropymask", "emask"), default=False)
    if (c.entropy_trim != "f" or c.entropy_mask) and c.entropy_cutoff < 0:
        raise ValueError("entropytrim/entropymask require entropy=<0..1>")
    c.recalibrate = a.get_bool(*h("recalibrate", "recal"), default=False)
    overwrite = a.get_bool("overwrite", "ow", default=True)
    test_output_files(
        overwrite, c.out1, c.out2, c.outm1, c.outm2,
        inputs=[c.in1, c.in2] + list(c.ref or []),
    )
    c.recal_path = a.get(*h("path", "recalpath"), default=".") or "."
    c.recal_passes = a.get_int(*h("recalpasses"), default=2)
    c.entropy_window = a.get_int(*h("entropywindow"), default=50)
    c.entropy_k = a.get_int(*h("entropyk"), default=5)
    def parse_poly(*names):
        v = a.get(*h(*names))
        if v is None:
            return 0
        if v and v[0].isdigit():
            return int(v)
        return 2 if v.lower() in ("t", "true", "1") else 0

    c.trim_polya = parse_poly("trimpolya")
    tg = parse_poly("trimpolyg")
    c.trim_polyg_left = parse_poly("trimpolygleft") or tg
    c.trim_polyg_right = parse_poly("trimpolygright") or tg
    tc = parse_poly("trimpolyc")
    c.trim_polyc_left = parse_poly("trimpolycleft") or tc
    c.trim_polyc_right = parse_poly("trimpolycright") or tc
    c.filter_polyg = parse_poly("filterpolyg")
    c.filter_polyc = parse_poly("filterpolyc")
    c.max_non_poly = a.get_int(*h("maxnonpoly"), default=2)
    c.force_trim_left = a.get_int(*h("forcetrimleft", "ftl"), default=0)
    c.force_trim_right = a.get_int(*h("forcetrimright", "ftr"), default=0)
    c.force_trim_right2 = a.get_int(*h("forcetrimright2", "ftr2"), default=0)
    c.force_trim_modulo = a.get_int(*h("forcetrimmod", "forcetrimmodulo", "ftm"), default=0)
    c.restrict_left = a.get_int(*h("restrictleft"), default=0)
    c.restrict_right = a.get_int(*h("restrictright"), default=0)
    c.remove_if_either_bad = a.get_bool(
        *h("removeifeitherbad", "rieb"), default=True
    )
    c.trim_pairs_evenly = a.get_bool(*h("trimpairsevenly", "tpe"), default=False)
    c.trim_by_overlap = a.get_bool(*h("trimbyoverlap", "tbo"), default=False)
    c.kmask_lowercase = a.get_bool(*h("kmasklowercase"), default=False)
    c.trim_pad = a.get_int(*h("trimpad"), default=0)
    c.ktrim_exclusive = a.get_bool(*h("ktrimexclusive"), default=False)
    c.stats = a.get(*h("stats"))
    c.json_out = a.get_bool(*h("json"), default=False)
    c.qhist = a.get(*h("qhist"))
    c.lhist = a.get(*h("lhist"))
    c.gchist = a.get(*h("gchist"))
    c.aqhist = a.get(*h("aqhist"))
    c.bhist = a.get(*h("bhist"))
    c.batch_reads = a.get_int(*h("batchreads"), default=16384)
    c.ordered = a.get_bool(*h("ordered"), default=True)
    c.ziplevel = a.get_int(*h("ziplevel", "zl"), default=None)
    c.interleaved = a.get_bool(*h("interleaved", "int"), default=None)
    c.device = a.get(*h("device"), default="cuda")
    handled.update(("threads", "t", "overwrite", "ow"))
    unknown = [k for k, _ in a.pairs if k not in handled]
    if unknown:
        raise ValueError(f"Unknown bbduk flags: {unknown}")
    return c.resolve()


@dataclass
class BBDukStats:
    reads_in: int = 0
    bases_in: int = 0
    reads_out: int = 0
    bases_out: int = 0
    reads_outm: int = 0
    bases_outm: int = 0
    reads_qtrimmed: int = 0
    bases_qtrimmed: int = 0
    reads_qfiltered: int = 0
    bases_qfiltered: int = 0
    reads_ktrimmed: int = 0
    bases_ktrimmed: int = 0
    reads_kfiltered: int = 0
    bases_kfiltered: int = 0
    reads_ftrimmed: int = 0
    bases_ftrimmed: int = 0
    reads_nfiltered: int = 0
    bases_nfiltered: int = 0
    reads_efiltered: int = 0
    bases_efiltered: int = 0
    reads_polytrimmed: int = 0
    bases_polytrimmed: int = 0
    scaffold_reads: np.ndarray | None = None
    scaffold_bases: np.ndarray | None = None


def load_reference(cfg: BBDukConfig):
    """Load ref fasta(s) + literals into (scaffold codes, names) in input
    order — scaffold ids are 1-based (BBDukIndexMod.toRefNames)."""
    scaffolds: list[np.ndarray] = []
    names: list[bytes] = []
    for path in cfg.ref:
        path = resolve_ref_keyword(path)
        for rec in iter_fasta(path):
            names.append(rec.name if rec.name else b"scaf")
            scaffolds.append(encode(rec.seq))
    for i, lit in enumerate(cfg.literal):
        names.append(b"literal_%d" % i)
        scaffolds.append(encode(lit))
    return scaffolds, names


def _mm_eligible(cfg: BBDukConfig) -> bool:
    """Configs the one-hot matcher can serve exactly (ops/mm_match.py):
    canonical queries (rcomp), no indel balls (edist), no query-side
    mutation (qhdist), and, when speed>0, no short-kmer classes (the
    short-end scans apply no speed gate, so load-side sampling of shorts
    cannot be reproduced scan-side). The JAX package's gate without its
    TPU test: decided from the config alone, so CPU runs walk the GPU's
    path."""
    return (
        cfg.rcomp
        and cfg.k <= 31
        and cfg.edist == 0
        and (cfg.edist2 or 0) == 0
        and cfg.qhdist == 0
        and (cfg.hdist > 0 or (cfg.hdist2 or 0) > 0)
        and not (cfg.speed > 0 and cfg.use_short_kmers)
    )


def _join_eligible(cfg: BBDukConfig, n_keys: int) -> bool:
    """Sorted-join backend gate: panels past the lane cap, no query-side
    mutation (qhdist multiplies the query stream). Decided from the panel
    alone, never from the device, so CPU runs walk the GPU's path."""
    return SortJoinIndex.supports(n_keys, cfg.qhdist)


def build_index(cfg: BBDukConfig, return_keys: bool = False):
    scaffolds, names = load_reference(cfg)
    keys, ids = build_ref_keys(
        scaffolds,
        cfg.k,
        mink=cfg.mink if cfg.use_short_kmers else 0,
        hdist=cfg.hdist,
        hdist2=cfg.hdist2,
        edist=cfg.edist,
        edist2=cfg.edist2,
        mid_mask=cfg.mid_mask_bits,
        speed=cfg.speed,
    )
    index = None
    if len(keys):
        # small panels (adapters/artifacts/primers) go to the lane table
        # (kernel csrc/lane_lookup.cu); larger ones to the sorted join
        # (ops/sort_join.py, kernel csrc/cummax_i64.cu); expansion-heavy
        # panels past the join cap (hdist>=2) to the one-hot matcher,
        # which stores RAW keys and resolves the hamming ball in its
        # product (kernel csrc/mm_match.cu); qhdist>0 and the rest take
        # the bucket table. The JAX package's order.
        if LaneKmerIndex.supports(len(keys)):
            index = LaneKmerIndex.build(keys, ids)
        if index is None and _join_eligible(cfg, len(keys)):
            index = SortJoinIndex.build(keys, ids)
        if index is None and _mm_eligible(cfg):
            index = MMKmerIndex.build(
                scaffolds,
                cfg.k,
                mink=cfg.mink if cfg.use_short_kmers else 0,
                hdist=cfg.hdist,
                hdist2=cfg.hdist2,
                mid_mask=cfg.mid_mask_bits,
                rcomp=cfg.rcomp,
            )
        if index is None:
            index = BucketKmerIndex.build(keys, ids, pack=True)
    lengths = [len(s) for s in scaffolds]
    if return_keys:
        return index, names, lengths, keys, ids
    return index, names, lengths


class BBDuk:
    def __init__(self, cfg: BBDukConfig):
        self.cfg = cfg
        self.stats = BBDukStats()
        self.device = resolve_device(cfg.device)
        (self.index, self.scaffold_names, self.scaffold_lengths,
         self._ref_keys, self._ref_ids) = build_index(cfg, return_keys=True)
        self._mesh = None
        self.stats.scaffold_reads = np.zeros(len(self.scaffold_names) + 1, np.int64)
        self.stats.scaffold_bases = np.zeros(len(self.scaffold_names) + 1, np.int64)
        self.entropy = (
            EntropyModel(cfg.entropy_k, cfg.entropy_window)
            if cfg.entropy_cutoff >= 0
            else None
        )
        self.trim_e = float(np.float32(phred_to_prob_error(cfg.trimq)))
        mm = cfg.mid_mask_bits if cfg.mask_middle else -1
        self.scan_cfg = KScanConfig(
            k=cfg.k,
            mink=cfg.mink if cfg.use_short_kmers else 0,
            minlen2=(cfg.k - cfg.mid_mask_len) // 2 if cfg.mask_middle else cfg.k,
            mid_mask=mm,
            restrict_left=cfg.restrict_left,
            restrict_right=cfg.restrict_right,
            qhdist=cfg.qhdist,
            speed=cfg.speed,
            qskip=cfg.qskip,
            nb=getattr(self.index, "nb", 64),
            packed=bool(getattr(self.index, "packed", False)),
            rcomp=cfg.rcomp,
            lane=(
                self.index.static_params()
                if isinstance(self.index, LaneKmerIndex)
                else None
            ),
            join=(
                self.index.static_params()
                if isinstance(self.index, SortJoinIndex)
                else None
            ),
            mm=(
                self.index.static_params()
                if isinstance(self.index, MMKmerIndex)
                else None
            ),
        )
        self.table_dev = (
            self.index.device_arrays(self.device) if self.index else None
        )
        self.recalibrator = None
        if cfg.recalibrate:
            from .calctruequality import Recalibrator

            self.recalibrator = Recalibrator(
                cfg.recal_path, passes=cfg.recal_passes
            )
        if cfg.tp_shards > 1 and self.index is not None:
            self.enable_mesh(n_tp=cfg.tp_shards)

    # ------------------------------------------------------------------
    def enable_mesh(self, mesh=None, n_tp: int | None = None):
        """Multi-device mode (tpshards=N): shard the k-mer table over the
        tp mesh axis (kmer%WAYS, kmer/KmerTableSet.java:273-285) with
        reads data-parallel over dp; every scan sums the shards' lookups.
        Without `mesh`, the devices of `device=` (parallel/mesh.py
        `local_devices`): N must divide their count. Outputs are the
        single-device run's bytes."""
        from ..parallel.mesh import local_devices, make_mesh
        from ..parallel.sharded_index import ShardedKmerIndex

        if mesh is None:
            devices = local_devices(self.device)
            nd = len(devices)
            n_tp = n_tp or nd
            if n_tp > nd or nd % n_tp:
                raise ValueError(
                    f"tpshards={n_tp} does not divide {nd} devices"
                )
            mesh = make_mesh(n_dp=nd // n_tp, n_tp=n_tp, devices=devices)
        self._mesh = mesh
        self._sidx = ShardedKmerIndex.build(
            self._ref_keys, self._ref_ids, mesh.shape["tp"]
        )
        self._tables = self._sidx.place(mesh)
        self._sharded_scans = {}

    def _sharded_scan_all(self, b, short_left: bool, short_right: bool):
        """The scans of batch b over the mesh, its rows padded to a
        multiple of dp with empty reads (N bases, length 0) that are
        dropped again. Returns host arrays."""
        from ..parallel.sharded_index import make_sharded_kscan

        fn = self._sharded_scans.get((short_left, short_right))
        if fn is None:
            fn = make_sharded_kscan(
                self._mesh, self.scan_cfg, self._sidx,
                short_left, short_right,
            )
            self._sharded_scans[(short_left, short_right)] = fn
        n_dp = self._mesh.shape["dp"]
        B = b.bases.shape[0]
        pad = (-B) % n_dp
        bases = b.bases
        lengths = b.lengths
        if pad:
            bases = np.concatenate(
                [bases, np.full((pad, bases.shape[1]), 4, bases.dtype)]
            )
            lengths = np.concatenate(
                [lengths, np.zeros(pad, lengths.dtype)]
            )
        out, sl, sr = fn(
            self._tables, self._dev(bases), self._dev(lengths),
        )
        host = {k: v[:B].cpu().numpy() for k, v in out.items()}
        sl = tuple(x[:B].cpu().numpy() for x in sl) if sl is not None else None
        sr = tuple(x[:B].cpu().numpy() for x in sr) if sr is not None else None
        return host, sl, sr

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the scan device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    def process_pair(self, b1, b2):
        """Process one batch (and optional mate batch). Returns
        (b1, b2, keep_mask, single_mask1, single_mask2)."""
        cfg, st = self.cfg, self.stats
        n = b1.n
        init_len1 = b1.lengths.copy()
        init_len2 = b2.lengths.copy() if b2 is not None else np.zeros(n, np.int32)
        pair_count = 2 if b2 is not None else 1
        st.reads_in += n * pair_count
        st.bases_in += int(init_len1.sum() + init_len2.sum())
        minlen1 = np.maximum(
            (init_len1 * cfg.min_len_fraction).astype(np.int64), cfg.min_length
        )
        minlen2 = np.maximum(
            (init_len2 * cfg.min_len_fraction).astype(np.int64), cfg.min_length
        )
        disc1 = np.zeros(n, dtype=bool)
        disc2 = np.zeros(n, dtype=bool)

        # ---- quality recalibration (BBDuk.java:2634-2640) ----
        if self.recalibrator is not None:
            for pairnum, b in enumerate((b1, b2) if b2 is not None else (b1,)):
                if b.quals is not None:
                    b.quals = self.recalibrator.recalibrate(
                        b.bases, b.quals, b.lengths, pairnum=pairnum
                    )

        # ---- force trim (BBDukProcessorS:889-927) ----
        if (
            cfg.force_trim_left > 0
            or cfg.force_trim_right > 0
            or cfg.force_trim_right2 > 0
            or cfg.force_trim_modulo > 0
        ):
            b1, disc1 = self._force_trim(b1, disc1, minlen1)
            if b2 is not None:
                b2, disc2 = self._force_trim(b2, disc2, minlen2)

        disc1 |= b1.lengths < minlen1
        if b2 is not None:
            disc2 |= b2.lengths < minlen2

        if b2 is not None:
            remove = (
                (disc1 | disc2) if cfg.remove_if_either_bad else (disc1 & disc2)
            )
        else:
            remove = disc1.copy()
        st.reads_qfiltered += int(remove.sum()) * pair_count
        st.bases_qfiltered += int(
            init_len1[remove].sum() + init_len2[remove].sum()
        )

        # ---- kmer stage ----
        if self.index is not None and cfg.ktrim_n:
            b1, b2, disc1, disc2, remove = self._kmask_stage(
                b1, b2, disc1, disc2, remove, minlen1, minlen2
            )
        elif self.index is not None and cfg.kmer_trimming:
            b1, b2, disc1, disc2, remove = self._ktrim_stage(
                b1, b2, disc1, disc2, remove, minlen1, minlen2, init_len1, init_len2
            )
        elif self.index is not None:
            remove = self._kfilter_stage(
                b1, b2, disc1, disc2, remove, init_len1, init_len2
            )

        # ---- trim-by-overlap (:1100-1145) ----
        if cfg.trim_by_overlap and b2 is not None:
            b1, b2 = self._tbo_stage(b1, b2, remove)

        # ---- homopolymer trims/filters (BBDuk2.java:2239-2300) ----
        if (
            cfg.trim_polya > 0
            or cfg.trim_polyg_left > 0 or cfg.trim_polyg_right > 0
            or cfg.trim_polyc_left > 0 or cfg.trim_polyc_right > 0
            or cfg.filter_polyg > 0 or cfg.filter_polyc > 0
        ):
            b1, b2, disc1, disc2, remove = self._poly_stage(
                b1, b2, disc1, disc2, remove, minlen1, minlen2
            )

        # ---- quality trimming (:1292-1326) ----
        if cfg.qtrim_left or cfg.qtrim_right:
            alive = ~remove
            for b, disc, ml in (
                (b1, disc1, minlen1),
                ((b2, disc2, minlen2) if b2 is not None else (None, None, None)),
            )[: 1 + (b2 is not None)]:
                if b is None:
                    continue
                is_n = (
                    b.ascii_bases == ord("N")
                    if b.ascii_bases is not None
                    else b.bases >= 4
                )
                left, right = optimal_trim(
                    self._dev(b.quals),
                    self._dev(b.lengths),
                    self._dev(is_n),
                    self.trim_e,
                )
                left = left.cpu().numpy()
                right = right.cpu().numpy()
                if not cfg.qtrim_left:
                    left = np.zeros_like(left)
                if not cfg.qtrim_right:
                    right = np.zeros_like(right)
                # trimByAmount minResult=1: over-trim keeps leftmost base
                over = left + right + 1 > b.lengths
                right = np.where(
                    over, np.maximum(1, b.lengths - 1), right
                )
                left = np.where(over, 0, left)
                trimmed = (left + right) * alive
                nz = trimmed > 0
                st.reads_qtrimmed += int(nz.sum())
                st.bases_qtrimmed += int(trimmed.sum())
                b2_new = apply_trim(b, np.where(alive, left, 0), np.where(alive, right, 0))
                b.bases, b.quals, b.lengths = b2_new.bases, b2_new.quals, b2_new.lengths
                b.ascii_bases = b2_new.ascii_bases
            disc1 |= (b1.lengths < minlen1) | (b1.lengths > cfg.max_length)
            if b2 is not None:
                disc2 |= (b2.lengths < minlen2) | (b2.lengths > cfg.max_length)
            new_remove = self._should_remove(disc1, disc2, b2 is not None) & ~remove
            st.bases_qtrimmed += int(
                (b1.lengths[new_remove]).sum()
                + (b2.lengths[new_remove].sum() if b2 is not None else 0)
            )
            remove |= new_remove
        else:
            disc1 |= (b1.lengths < minlen1) | (b1.lengths > cfg.max_length)
            if b2 is not None:
                disc2 |= (b2.lengths < minlen2) | (b2.lengths > cfg.max_length)
            remove |= self._should_remove(disc1, disc2, b2 is not None)

        # ---- quality filters (:1330-1387) ----
        new_remove = np.zeros(n, dtype=bool)
        for b, disc in ((b1, disc1), (b2, disc2)) if b2 is not None else ((b1, disc1),):
            if cfg.min_avg_quality > 0 and b.quals is not None:
                avgq = _avg_quality_by_prob(b, cfg.min_avg_quality_bases)
                disc |= avgq < cfg.min_avg_quality
            if cfg.min_base_quality > 0 and b.quals is not None:
                minq = np.where(
                    b.valid_mask(), b.quals, 127
                ).min(axis=1)
                minq = np.where(b.lengths > 0, minq, 41)
                disc |= minq < cfg.min_base_quality
            if cfg.max_ns >= 0:
                nns = _count_undefined(b)
                bad = nns > cfg.max_ns
                st.reads_nfiltered += int((bad & ~disc).sum())
                st.bases_nfiltered += int(b.lengths[bad & ~disc].sum())
                disc |= bad
            if cfg.min_consecutive_bases > 0:
                disc |= ~_has_min_consecutive(b, cfg.min_consecutive_bases)
        nr = self._should_remove(disc1, disc2, b2 is not None) & ~remove
        st.reads_qfiltered += int(nr.sum()) * pair_count
        st.bases_qfiltered += int(
            b1.lengths[nr].sum() + (b2.lengths[nr].sum() if b2 is not None else 0)
        )
        remove |= nr

        # ---- entropy trim/mask (:1273-1286) ----
        if self.entropy is not None and (cfg.entropy_trim != "f" or cfg.entropy_mask):
            for b in (b1, b2) if b2 is not None else (b1,):
                low = self._low_entropy_windows(b)
                if cfg.entropy_mask:
                    to_mask = low & (b.bases < 4) & ~remove[:, None]
                    st.bases_efiltered += int(to_mask.sum())
                    st.reads_efiltered += int(to_mask.any(axis=1).sum())
                    b.bases[to_mask] = 4
                    if b.quals is not None:
                        b.quals[to_mask] = 0
                    if b.ascii_bases is not None:
                        b.ascii_bases[to_mask] = ord("N")
                else:
                    # trim low-entropy ends: left run and/or right run
                    ln = b.lengths.astype(np.int64)
                    left_amt = np.zeros(b.n, dtype=np.int64)
                    right_amt = np.zeros(b.n, dtype=np.int64)
                    if cfg.entropy_trim in ("l", "rl"):
                        first_good = np.argmin(low, axis=1)
                        all_low = low.all(axis=1)
                        left_amt = np.where(all_low, ln, first_good)
                    if cfg.entropy_trim in ("r", "rl"):
                        L = low.shape[1]
                        # mark padding as "low" so the scan from the padded
                        # end skips straight to the read's real tail
                        lowr = low | (np.arange(L)[None, :] >= ln[:, None])
                        pad_low = L - ln
                        all_low = lowr.all(axis=1)
                        first_good_r = np.argmin(lowr[:, ::-1], axis=1) - pad_low
                        right_amt = np.where(
                            all_low, ln, np.maximum(first_good_r, 0)
                        )
                    left_amt = np.where(remove, 0, np.minimum(left_amt, ln))
                    right_amt = np.where(
                        remove, 0, np.minimum(right_amt, ln - left_amt)
                    )
                    x = left_amt + right_amt
                    st.bases_efiltered += int(x.sum())
                    st.reads_efiltered += int((x > 0).sum())
                    nb = apply_trim(b, left_amt, right_amt)
                    b.bases, b.quals, b.lengths = nb.bases, nb.quals, nb.lengths
                    b.ascii_bases = nb.ascii_bases
            disc1 |= b1.lengths < minlen1
            if b2 is not None:
                disc2 |= b2.lengths < minlen2
            remove |= self._should_remove(disc1, disc2, b2 is not None)

        # ---- entropy filter (:1394-1404) ----
        if self.entropy is not None and cfg.entropy_trim == "f" and not cfg.entropy_mask:
            for b, disc in ((b1, disc1), (b2, disc2)) if b2 is not None else ((b1, disc1),):
                passes = self.entropy.passes(
                    b.bases, b.lengths, self.cfg.entropy_cutoff
                )
                disc |= ~passes
            nr = self._should_remove(disc1, disc2, b2 is not None) & ~remove
            st.reads_efiltered += int(nr.sum()) * pair_count
            st.bases_efiltered += int(
                b1.lengths[nr].sum()
                + (b2.lengths[nr].sum() if b2 is not None else 0)
            )
            remove |= nr

        keep = ~remove
        st.reads_out += int(keep.sum()) * pair_count
        st.bases_out += int(
            b1.lengths[keep].sum() + (b2.lengths[keep].sum() if b2 is not None else 0)
        )
        st.reads_outm += int(remove.sum()) * pair_count
        st.bases_outm += int(
            b1.lengths[remove].sum()
            + (b2.lengths[remove].sum() if b2 is not None else 0)
        )
        single1 = keep & disc2 & ~disc1 if b2 is not None else np.zeros(n, bool)
        single2 = keep & disc1 & ~disc2 if b2 is not None else np.zeros(n, bool)
        return b1, b2, keep, single1, single2

    # ------------------------------------------------------------------
    def _poly_stage(self, b1, b2, disc1, disc2, remove, minlen1, minlen2):
        """Homopolymer trimming/filtering (BBDuk.java:2954-3056): three
        sub-stages (poly-A max of A/T end runs, then poly-G, then poly-C
        with up to maxNonPoly interruptions), each gated on the pair not
        yet being removed.  Reference accounting, mirrored exactly:
        already-discarded reads in a surviving pair are still trimmed and
        counted; a filterPolyG/C discard counts one read in
        readsPolyTrimmed and suppresses the trim for that read; after
        each sub-stage shouldRemove() runs and a newly removed pair adds
        its remaining pairLength() to basesPolyTrimmed.  Quirk preserved:
        the reference's poly-C *filter* check for r2 reads r1's bases
        (BBDuk.java:3038)."""
        cfg, st = self.cfg, self.stats
        reads = [(b1, disc1, minlen1)]
        if b2 is not None:
            reads.append((b2, disc2, minlen2))

        def _close_substage(remove):
            # shouldRemove + basesPolyTrimmedT += r1.pairLength()
            if b2 is None:
                bad = disc1
            elif cfg.remove_if_either_bad:
                bad = disc1 | disc2
            else:
                bad = disc1 & disc2
            new = ~remove & bad
            if new.any():
                pair_len = b1.lengths.astype(np.int64)
                if b2 is not None:
                    pair_len = pair_len + b2.lengths.astype(np.int64)
                st.bases_polytrimmed += int(pair_len[new].sum())
            return remove | new

        if cfg.trim_polya > 0:
            act = ~remove
            for b, disc, ml in reads:
                lA = _count_end_run(b, 0, 0)  # A from left
                lT = _count_end_run(b, 3, 0)
                rA = _count_end_run(b, 0, 1)
                rT = _count_end_run(b, 3, 1)
                left = np.maximum(lA, lT)
                right = np.maximum(rA, rT)
                left[left < cfg.trim_polya] = 0
                right[right < cfg.trim_polya] = 0
                self._apply_poly_trim(b, left, right, act, st)
                disc |= act & (b.lengths < ml)
            remove = _close_substage(remove)
        for code, pl, pr, pf in (
            (2, cfg.trim_polyg_left, cfg.trim_polyg_right,
             cfg.filter_polyg),
            (1, cfg.trim_polyc_left, cfg.trim_polyc_right,
             cfg.filter_polyc),
        ):
            if not (pl or pr or pf):
                continue
            act = ~remove
            for ri, (b, disc, ml) in enumerate(reads):
                sub = act
                if pf > 0:
                    # reference quirk: the poly-C filter tests r1 even
                    # when discarding r2 (BBDuk.java:3038)
                    probe = b1 if (code == 1 and ri == 1) else b
                    hit = (
                        _detect_poly_left(probe, code, pf, cfg.max_non_poly)
                        >= pf
                    ) & act
                    disc |= hit
                    st.reads_polytrimmed += int(hit.sum())
                    sub = act & ~hit
                if pl > 0 or pr > 0:
                    left = (
                        _detect_poly_left(b, code, pl, cfg.max_non_poly)
                        if pl > 0 else np.zeros(b.n, np.int32)
                    )
                    right = (
                        _detect_poly_right(b, code, pr, cfg.max_non_poly)
                        if pr > 0 else np.zeros(b.n, np.int32)
                    )
                    self._apply_poly_trim(b, left, right, sub, st)
                    disc |= sub & (b.lengths < ml)
            remove = _close_substage(remove)
        return b1, b2, disc1, disc2, remove

    def _apply_poly_trim(self, b, left, right, alive, st):
        """TrimRead.trimByAmount(minResult=1) over the batch, in place
        (clamp at :322-325: over-trim keeps the leftmost base)."""
        left = np.where(alive, left, 0).astype(np.int64)
        right = np.where(alive, right, 0).astype(np.int64)
        over = left + right + 1 > b.lengths
        right = np.where(over, np.maximum(1, b.lengths - 1), right)
        left = np.where(over, 0, left)
        trimmed = left + right
        nz = trimmed > 0
        st.reads_polytrimmed += int(nz.sum())
        st.bases_polytrimmed += int(trimmed.sum())
        res = apply_trim(b, left, right)
        for attr in ("bases", "quals", "lengths", "ascii_bases"):
            setattr(b, attr, getattr(res, attr))

    def _low_entropy_windows(self, b):
        """bool [B, L]: positions covered by a window whose entropy is
        below the cutoff (maskLowEntropy coverage semantics)."""
        em = self.entropy
        cfg = self.cfg
        B, L = b.bases.shape
        W = em.window
        low = np.zeros((B, L), dtype=bool)
        lengths = b.lengths.astype(np.int64)
        if L < W:
            return low
        starts = np.arange(0, L - W + 1)
        # evaluate every window of every read (batch over reads, chunked
        # over window starts)
        for c0 in range(0, len(starts), 64):
            cs = starts[c0 : c0 + 64]
            wins = np.stack([b.bases[:, s0 : s0 + W] for s0 in cs], axis=1)
            wl = wins.reshape(-1, W)
            vals = em.average_entropy_batch(
                wl, np.full(len(wl), W, dtype=np.int64)
            ).reshape(B, len(cs))
            below = vals < np.float32(cfg.entropy_cutoff)
            for j, s0 in enumerate(cs):
                sel = below[:, j] & (s0 + W <= lengths)
                low[sel, s0 : s0 + W] = True
        return low

    def _should_remove(self, disc1, disc2, paired: bool):
        if not paired:
            return disc1.copy()
        if self.cfg.remove_if_either_bad:
            return disc1 | disc2
        return disc1 & disc2

    def _force_trim(self, b, disc, minlen):
        cfg, st = self.cfg, self.stats
        ln = b.lengths.astype(np.int64)
        a = np.full_like(ln, cfg.force_trim_left if cfg.force_trim_left > 0 else 0)
        b0 = np.where(
            cfg.force_trim_modulo > 0,
            ln - 1 - ln % max(cfg.force_trim_modulo, 1),
            ln,
        )
        b1v = np.full_like(ln, cfg.force_trim_right if cfg.force_trim_right > 0 else BIG)
        b1v = np.minimum(b1v, ln)
        b2v = np.where(cfg.force_trim_right2 > 0, ln - 1 - cfg.force_trim_right2, ln)
        bpos = np.minimum(np.minimum(b0, b1v), b2v)
        left_amt = np.maximum(a, 0)
        right_amt = np.maximum(ln - bpos - 1, 0)
        over = left_amt + right_amt + 1 > ln
        right_amt = np.where(over, np.maximum(1, ln - 1), right_amt)
        left_amt = np.where(over, 0, left_amt)
        alive = ~disc
        x = (left_amt + right_amt) * alive
        st.bases_ftrimmed += int(x.sum())
        st.reads_ftrimmed += int((x > 0).sum())
        nb = apply_trim(b, np.where(alive, left_amt, 0), np.where(alive, right_amt, 0))
        disc = disc | (nb.lengths < minlen)
        return nb, disc

    def _scan(self, b):
        """Run the full-k device scan for batch b. Returns host dict."""
        if self._mesh is not None:
            return self._sharded_scan_all(b, False, False)[0]
        out = kscan_full(
            self.scan_cfg, self.table_dev, self._dev(b.bases),
            self._dev(b.lengths),
        )
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _scan_all(self, b, short_left: bool, short_right: bool):
        """Full + short scans of batch b. Returns host arrays."""
        if self._mesh is not None:
            return self._sharded_scan_all(b, short_left, short_right)
        out, sl, sr = kscan_combined(
            self.scan_cfg, self.table_dev, self._dev(b.bases),
            self._dev(b.lengths), short_left, short_right,
        )
        host = {k: v.cpu().numpy() for k, v in out.items()}
        sl = tuple(x.cpu().numpy() for x in sl) if sl is not None else None
        sr = tuple(x.cpu().numpy() for x in sr) if sr is not None else None
        return host, sl, sr

    def _ktrim_stage(self, b1, b2, disc1, disc2, remove, minlen1, minlen2,
                     init_len1, init_len2):
        cfg, st = self.cfg, self.stats
        n = b1.n
        xsum = np.zeros(n, dtype=np.int64)
        rktsum = np.zeros(n, dtype=np.int64)
        alive = ~remove
        batches = [(b1, disc1, minlen1)]
        if b2 is not None:
            batches.append((b2, disc2, minlen2))
        new_batches = []
        for bi, (b, disc, ml) in enumerate(batches):
            if (cfg.skip_r1 and bi == 0) or (cfg.skip_r2 and bi == 1):
                new_batches.append(b)
                continue
            res, shortL, shortR = self._scan_all(
                b,
                cfg.use_short_kmers and cfg.ktrim_left,
                cfg.use_short_kmers and cfg.ktrim_right,
            )
            found = res["nhits"]
            id0 = res["id0"]
            min_loc = res["min_loc"].astype(np.int64)
            max_loc = res["max_loc"].astype(np.int64)
            ln = b.lengths.astype(np.int64)
            if cfg.use_short_kmers:
                need = (found == 0) & alive
                if shortL is not None:
                    hitL, idL, locL = shortL
                    upd = need & hitL
                    id0 = np.where(upd & (id0 <= 0), idL, id0)
                    min_loc = np.where(upd, 0, min_loc)
                    max_loc = np.where(upd, np.maximum(max_loc, locL), max_loc)
                    found = found + np.where(upd, 1, 0)
                if shortR is not None:
                    hitR, idR, locR = shortR
                    upd = need & hitR & (found == 0)
                    id0 = np.where(upd & (id0 <= 0), idR, id0)
                    min_loc = np.where(upd, np.minimum(min_loc, locR), min_loc)
                    max_loc = np.where(upd, ln - 1, max_loc)
                    found = found + np.where(upd, 1, 0)
            # minimum read length gate (ktrim: r.length() < max(1, mink or k))
            min_needed = max(
                1, min(cfg.k, cfg.mink) if cfg.use_short_kmers else cfg.k
            )
            act = alive & (ln >= min_needed) & (found > 0)
            # credit scaffold stats with id0
            np.add.at(st.scaffold_reads, id0[act], 1)
            np.add.at(st.scaffold_bases, id0[act], ln[act])
            if cfg.trim_pad:
                max_loc = np.clip(max_loc + cfg.trim_pad, 0, ln)
                min_loc = np.clip(min_loc - cfg.trim_pad, 0, ln)
            if cfg.ktrim_left and not cfg.ktrim_right:
                a_pos = max_loc + 1
                b_pos = ln - 1
            elif cfg.ktrim_right and not cfg.ktrim_left:
                a_pos = np.zeros_like(ln)
                b_pos = min_loc - 1
            else:
                raise NotImplementedError("ktrimTips/kmask handled separately")
            left_amt = np.maximum(a_pos, 0)
            right_amt = np.maximum(ln - b_pos - 1, 0)
            over = left_amt + right_amt + 1 > ln
            right_amt = np.where(over, np.maximum(1, ln - 1), right_amt)
            left_amt = np.where(over, 0, left_amt)
            left_amt = np.where(act, left_amt, 0)
            right_amt = np.where(act, right_amt, 0)
            x = left_amt + right_amt
            xsum += x
            rktsum += (x > 0).astype(np.int64)
            nb = apply_trim(b, left_amt, right_amt)
            if bi == 0:
                disc1 = disc | (nb.lengths < ml)
            else:
                disc2 = disc | (nb.lengths < ml)
            new_batches.append(nb)
        b1 = new_batches[0]
        if b2 is not None:
            b2 = new_batches[1]
        nr = self._should_remove(disc1, disc2, b2 is not None) & alive
        # removed pairs count all remaining bases as trimmed (:1016-1020)
        pair_len = b1.lengths.astype(np.int64) + (
            b2.lengths.astype(np.int64) if b2 is not None else 0
        )
        xsum = np.where(nr, xsum + pair_len, xsum)
        rktsum = np.where(nr, 2 if b2 is not None else 1, rktsum)
        remove = remove | nr
        # tpe: equalize pair lengths (:1022-1034)
        if (
            cfg.ktrim_right
            and cfg.trim_pairs_evenly
            and b2 is not None
        ):
            need = ~remove & (xsum > 0) & (b1.lengths != b2.lengths)
            tgt = np.minimum(b1.lengths, b2.lengths)
            for b in (b1, b2):
                amt = np.where(need, b.lengths - tgt, 0)
                nb = apply_trim(b, np.zeros_like(amt), amt)
                b.bases, b.quals, b.lengths = nb.bases, nb.quals, nb.lengths
                b.ascii_bases = nb.ascii_bases
                xsum += amt
            rktsum = np.where(need & (rktsum < 2), rktsum + 1, rktsum)
        st.bases_ktrimmed += int(xsum[alive].sum())
        st.reads_ktrimmed += int(rktsum[alive].sum())
        return b1, b2, disc1, disc2, remove

    def _kmask_stage(self, b1, b2, disc1, disc2, remove, minlen1, minlen2):
        """kmask (ktrim=n): mask hit-covered windows to N/lowercase
        (BBDukProcessorS.kmask :2147-2330, maskFromBitset :2629)."""
        cfg, st = self.cfg, self.stats
        minus = cfg.k - 1 - cfg.trim_pad
        plus = cfg.trim_pad + 1
        alive = ~remove
        for bi, b in enumerate((b1, b2) if b2 is not None else (b1,)):
            res, shortL, shortR = self._scan_all(
                b, cfg.use_short_kmers, cfg.use_short_kmers
            )
            hit = res["hit"]  # [B, L]
            B, L = hit.shape
            # covered[j] iff a hit exists at i in [j-plus+1, j+minus]
            cum = np.zeros((B, L + 1), dtype=np.int64)
            np.cumsum(hit, axis=1, out=cum[:, 1:])
            lo = np.clip(np.arange(L)[None, :] - plus + 1, 0, L)
            hi = np.clip(np.arange(L)[None, :] + minus + 1, 0, L)
            rows = np.arange(B)[:, None]
            covered = (cum[rows, hi] - cum[rows, lo]) > 0
            if cfg.use_short_kmers:
                hitL, idL, locL = shortL
                hitR, idR, locR = shortR
                pos = np.arange(L)[None, :]
                covered |= hitL[:, None] & (pos <= locL[:, None])
                covered |= hitR[:, None] & (pos >= locR[:, None])
            covered &= alive[:, None] & b.valid_mask()
            was_defined = b.bases < 4
            to_mask = covered & was_defined
            masked = to_mask.sum(axis=1)
            if cfg.kmask_lowercase and b.ascii_bases is not None:
                b.ascii_bases[covered] |= 0x20
            else:
                b.bases[to_mask] = 4
                if b.quals is not None:
                    b.quals[to_mask] = 0
                if b.ascii_bases is not None:
                    b.ascii_bases[to_mask] = ord("N")
            st.bases_ktrimmed += int(masked.sum())
            st.reads_ktrimmed += int((masked > 0).sum())
            id0 = res["id0"]
            act = alive & (masked > 0) & (id0 > 0)
            np.add.at(st.scaffold_reads, id0[act], 1)
            np.add.at(st.scaffold_bases, id0[act], b.lengths[act].astype(np.int64))
        return b1, b2, disc1, disc2, remove

    def _tbo_stage(self, b1, b2, remove):
        """trimByOverlap: detect pair overlap and trim both reads to the
        insert size (BBDukProcessorS :1100-1145), with BBMerge's
        non-quality ratio mode on the scan device (ops/overlap.py; the
        insert scan is kernel csrc/overlap_scan.cu on the GPU). Only the
        [B] winners come back to the host."""
        from ..ops.overlap import overlap_and_mate
        from .bbmerge import _rc_batch

        alens = b1.lengths.astype(np.int64)
        blens = b2.lengths.astype(np.int64)
        b_rc = _rc_batch(b2)
        min_insert0 = 13  # minInsert0 default in BBDuk tbo (minOverlap0-based)
        n_inserts = int(max(1, (alens + blens).max(initial=0) - min_insert0 + 1))
        insert, bad_int, ambig = (
            x.cpu().numpy()
            for x in overlap_and_mate(
                self._dev(b1.bases), self._dev(b_rc), self._dev(alens),
                self._dev(blens), min_insert0, n_inserts,
                8, 14, min_insert0, 16, 0.09, 0.1, 5.5, 0.55,
            )
        )
        ok = (insert > 0) & ~ambig & ~remove
        trim1 = np.where(ok & (insert < alens), alens - insert, 0)
        trim2 = np.where(ok & (insert < blens), blens - insert, 0)
        nz = (trim1 > 0) | (trim2 > 0)
        if nz.any():
            nb1 = apply_trim(b1, np.zeros_like(trim1), trim1)
            nb2 = apply_trim(b2, np.zeros_like(trim2), trim2)
            b1.bases, b1.quals, b1.lengths = nb1.bases, nb1.quals, nb1.lengths
            b1.ascii_bases = nb1.ascii_bases
            b2.bases, b2.quals, b2.lengths = nb2.bases, nb2.quals, nb2.lengths
            b2.ascii_bases = nb2.ascii_bases
        return b1, b2

    def _kfilter_stage(self, b1, b2, disc1, disc2, remove, init_len1, init_len2):
        cfg, st = self.cfg, self.stats
        n = b1.n
        alive = ~remove
        newdisc = [disc1, disc2]
        credited = np.zeros(n, dtype=np.int32)
        for bi, b in enumerate((b1, b2) if b2 is not None else (b1,)):
            if (cfg.skip_r1 and bi == 0) or (cfg.skip_r2 and bi == 1):
                continue
            res = self._scan(b)
            max_bad = np.full(n, cfg.max_bad_kmers, dtype=np.int32)
            if cfg.min_kmer_fraction > 0:
                valid_kmers = np.maximum(b.lengths - cfg.k + 1, 0)
                max_bad = np.maximum(
                    max_bad,
                    ((valid_kmers - 1) * cfg.min_kmer_fraction).astype(np.int32),
                )
            cid = credit_id(
                self._dev(res["ids"]), self._dev(max_bad)
            ).cpu().numpy()
            if cfg.rename or cfg.find_best_match:
                # findBestMatch/rename (BBDukProcessorS.java:1659-1705;
                # rename body BBDuk2.java:3654): credit the scaffold with
                # the MOST kmer hits (first-seen order breaks ties) and
                # append "\t<scaf>=<count>" per matched scaffold
                ids_np = np.asarray(res["ids"])
                nh = np.asarray(res["nhits"])
                for r in np.flatnonzero((nh > max_bad) & alive):
                    row = ids_np[r]
                    row = row[row > 0]
                    if not len(row):
                        continue
                    first_seen: list[int] = []
                    counts: dict[int, int] = {}
                    for v in row.tolist():
                        if v not in counts:
                            first_seen.append(v)
                            counts[v] = 0
                        counts[v] += 1
                    mx = max(counts[v] for v in first_seen)
                    for v in first_seen:
                        if counts[v] == mx:
                            cid[r] = v
                            break
                    if cfg.rename:
                        b.ids[r] = b.ids[r] + b"".join(
                            b"\t%s=%d"
                            % (self.scaffold_names[v - 1], counts[v])
                            for v in first_seen
                        )
            if cfg.kbig > cfg.k:
                # big-kmer counting (countSetKmersBig :1726): each run of
                # R consecutive 31-mer hits contributes R-(kbig-k) big
                # hits; reads shorter than kbig contribute none. (The
                # credit id approximates the reference's lastId-at-
                # crossing with the ordinal-hit id.)
                found = _count_big_kmer_hits(
                    np.asarray(res["hit"]), cfg.kbig - cfg.k - 1
                )
                over = (found > max_bad) & (b.lengths >= cfg.kbig)
            else:
                over = (res["nhits"] > max_bad) & (b.lengths >= cfg.k)
            ln = b.lengths.astype(np.int64)
            hit_act = over & alive
            np.add.at(st.scaffold_reads, cid[hit_act], 1)
            np.add.at(st.scaffold_bases, cid[hit_act], ln[hit_act])
            newdisc[bi] = newdisc[bi] | over
        disc1, disc2 = newdisc
        nr = self._should_remove(disc1, disc2, b2 is not None) & alive
        st.reads_kfiltered += int(nr.sum()) * (2 if b2 is not None else 1)
        st.bases_kfiltered += int(
            init_len1[nr].sum() + (init_len2[nr].sum() if b2 is not None else 0)
        )
        disc1 |= nr
        if b2 is not None:
            disc2 |= nr
        return remove | nr

    # ------------------------------------------------------------------
    def run(self):
        cfg, st = self.cfg, self.stats
        t0 = time.time()
        from ..io.fastq import interleave, paired_reader

        pairs = paired_reader(
            cfg.in1, cfg.in2, interleaved=cfg.interleaved,
            batch_reads=cfg.batch_reads,
        )
        w_out1 = FastqWriter(cfg.out1, ziplevel=cfg.ziplevel) if cfg.out1 else None
        w_out2 = FastqWriter(cfg.out2, ziplevel=cfg.ziplevel) if cfg.out2 else None
        w_outm1 = FastqWriter(cfg.outm1, ziplevel=cfg.ziplevel) if cfg.outm1 else None
        w_outm2 = FastqWriter(cfg.outm2, ziplevel=cfg.ziplevel) if cfg.outm2 else None
        w_outs = FastqWriter(cfg.outs, ziplevel=cfg.ziplevel) if cfg.outs else None
        rstats = None
        if cfg.qhist or cfg.lhist or cfg.gchist or cfg.aqhist or cfg.bhist:
            from ..utils.readstats import ReadStats

            rstats = ReadStats()
        side = None
        if cfg.align and cfg.align_ref:
            from .sidechannel import SideChannel

            side = SideChannel(
                cfg.align_ref, cfg.align_out, cfg.align_k1, cfg.align_k2,
                cfg.align_minid1, cfg.align_minid2, cfg.align_mm1,
                cfg.align_mm2, device=self.device,
            )
            self.side = side
        for b1, b2 in pairs:
            # interleaved input with single outputs -> interleaved output
            inter_out = b2 is not None and not cfg.in2 and cfg.out2 is None
            b1, b2, keep, s1, s2 = self.process_pair(b1, b2)
            if side is not None:
                # map surviving pairs (BBDukProcessorS.java:1411-1417)
                side.map_batch(b1, b2, np.asarray(keep))
            if inter_out:
                bi = interleave(b1, b2)
                keep2 = np.repeat(keep, 2)
                if w_out1:
                    w_out1.add(bi, keep2)
                if w_outm1:
                    w_outm1.add(bi, ~keep2)
            else:
                if w_out1:
                    w_out1.add(b1, keep)
                if w_out2 and b2 is not None:
                    w_out2.add(b2, keep)
                if w_outm1:
                    w_outm1.add(b1, ~keep)
                if w_outm2 and b2 is not None:
                    w_outm2.add(b2, ~keep)
            if w_outs and b2 is not None:
                pass  # singles: kept pair where one side discarded
            if rstats is not None:
                # histograms over surviving reads (addToHistograms after
                # processing, BBDukProcessorS:1411)
                rstats.add_batch(_subset(b1, keep), 0)
                if b2 is not None:
                    rstats.add_batch(_subset(b2, keep), 1)
        for w in (w_out1, w_out2, w_outm1, w_outm2, w_outs):
            if w:
                w.close()
        if side is not None:
            side.close()
        self.elapsed = time.time() - t0
        self._globalize_stats()
        self.write_stats_file()
        if rstats is not None:
            paired = cfg.in2 is not None
            if cfg.qhist:
                rstats.write_qhist(cfg.qhist, paired)
            if cfg.lhist:
                rstats.write_lhist(cfg.lhist)
            if cfg.gchist:
                rstats.write_gchist(cfg.gchist)
            if cfg.aqhist:
                rstats.write_aqhist(cfg.aqhist, paired)
            if cfg.bhist:
                rstats.write_bhist(cfg.bhist)
        return st

    def _globalize_stats(self):
        """In a process group (parallel/distributed.py): sum every counter
        and the per-scaffold hit vectors over the processes, so stats= and
        stderr report the one global answer while each process wrote its
        own ordered output shard. One process: no-op."""
        from ..parallel.distributed import global_sum_array, world_size

        if world_size() == 1:
            return
        st = self.stats
        fields = [
            f.name for f in st.__dataclass_fields__.values()
            if f.name not in ("scaffold_reads", "scaffold_bases")
        ]
        vec = np.array([getattr(st, f) for f in fields], np.int64)
        nsc = len(st.scaffold_reads) if st.scaffold_reads is not None else 0
        if nsc:
            vec = np.concatenate(
                [vec, st.scaffold_reads, st.scaffold_bases]
            )
        g = global_sum_array(vec)
        for i, f in enumerate(fields):
            setattr(st, f, int(g[i]))
        if nsc:
            st.scaffold_reads = g[len(fields) : len(fields) + nsc]
            st.scaffold_bases = g[len(fields) + nsc :]

    def write_stats_file(self):
        """Write the `stats=` scaffold hit-count file, byte-compatible with
        BBDukProcessorS.writeStats (:572-616, STATS_COLUMNS=3 default):
        sorted by (bases desc, reads desc, name asc)."""
        cfg, st = self.cfg, self.stats
        if not cfg.stats:
            return
        rows = []
        rsum = 0
        for i, name in enumerate(self.scaffold_names, start=1):
            reads = int(st.scaffold_reads[i])
            bases = int(st.scaffold_bases[i])
            if reads > 0:
                rsum += reads
                rows.append((name.decode(), self.scaffold_lengths[i - 1], reads, bases))
        rows.sort(key=lambda r: (-r[3], -r[2], r[0]))
        rmult = 100.0 / (st.reads_in if st.reads_in > 0 else 1)
        with open(cfg.stats, "w") as fh:
            fh.write(f"#File\t{cfg.in1}" + (f"\t{cfg.in2}" if cfg.in2 else "") + "\n")
            fh.write(f"#Total\t{st.reads_in}\n")
            fh.write(f"#Matched\t{rsum}\t{rmult * rsum:.5f}%\n")
            fh.write("#Name\tReads\tReadsPct\n")
            for name, _len, reads, _bases in rows:
                fh.write(f"{name}\t{reads}\t{reads * rmult:.5f}%\n")

    def print_stats(self, stream=None):
        if stream is None:
            stream = sys.stderr
        st = self.stats
        t = getattr(self, "elapsed", 0.0) or 1e-9
        if self.cfg.json_out:
            # JSON stats mode (PreParser json flag, BBDukProcessorS.toJson)
            import json as _json

            obj = {
                "readsIn": st.reads_in,
                "basesIn": st.bases_in,
                "readsRemoved": st.reads_outm,
                "basesRemoved": st.bases_outm,
                "readsOut": st.reads_out,
                "basesOut": st.bases_out,
                "qtrimmedReads": st.reads_qtrimmed,
                "qtrimmedBases": st.bases_qtrimmed,
                "qfilteredReads": st.reads_qfiltered,
                "qfilteredBases": st.bases_qfiltered,
                "ktrimmedReads": st.reads_ktrimmed,
                "ktrimmedBases": st.bases_ktrimmed,
                "kfilteredReads": st.reads_kfiltered,
                "kfilteredBases": st.bases_kfiltered,
                "mode": "ktrim" if self.cfg.kmer_trimming else "kFilter",
                "time": t,
            }
            print(_json.dumps(obj), file=stream)
            return
        print(f"Input:                  \t{st.reads_in} reads \t\t{st.bases_in} bases.", file=stream)
        if self.cfg.kmer_trimming:
            print(f"KTrimmed:               \t{st.reads_ktrimmed} reads ({100.0*st.reads_ktrimmed/max(st.reads_in,1):.2f}%) \t{st.bases_ktrimmed} bases ({100.0*st.bases_ktrimmed/max(st.bases_in,1):.2f}%)", file=stream)
        elif self.index is not None:
            print(f"Contaminants:           \t{st.reads_kfiltered} reads ({100.0*st.reads_kfiltered/max(st.reads_in,1):.2f}%) \t{st.bases_kfiltered} bases ({100.0*st.bases_kfiltered/max(st.bases_in,1):.2f}%)", file=stream)
        if self.cfg.qtrim_left or self.cfg.qtrim_right:
            print(f"QTrimmed:               \t{st.reads_qtrimmed} reads ({100.0*st.reads_qtrimmed/max(st.reads_in,1):.2f}%) \t{st.bases_qtrimmed} bases ({100.0*st.bases_qtrimmed/max(st.bases_in,1):.2f}%)", file=stream)
        print(f"Result:                 \t{st.reads_out} reads ({100.0*st.reads_out/max(st.reads_in,1):.2f}%) \t{st.bases_out} bases ({100.0*st.bases_out/max(st.bases_in,1):.2f}%)", file=stream)
        if getattr(self, "side", None) is not None:
            print(self.side.stats_line(st.reads_in, st.bases_in), file=stream)
        print(f"Time:                         \t{t:.3f} seconds.", file=stream)
        rps = st.reads_in / t
        bps = st.bases_in / t
        print(f"Reads Processed:    {st.reads_in:>10}\t{rps/1000:.2f}k reads/sec", file=stream)
        print(f"Bases Processed:    {st.bases_in:>10}\t{bps/1e6:.2f}m bases/sec", file=stream)


def _count_big_kmer_hits(hit: np.ndarray, sub: int) -> np.ndarray:
    """BBDukProcessorS.countSetKmersBig run accounting (:1760-1790): per
    read, sum max(0, run_len - 1 - sub) over maximal runs of consecutive
    k-mer hit positions."""
    B, L = hit.shape
    pos = np.arange(L)
    lastmiss = np.where(~hit, pos[None, :], -1)
    np.maximum.accumulate(lastmiss, axis=1, out=lastmiss)
    run_end = hit.copy()
    run_end[:, :-1] &= ~hit[:, 1:]
    run_len = pos[None, :] - lastmiss
    contrib = np.where(run_end, np.maximum(run_len - 1 - sub, 0), 0)
    return contrib.sum(axis=1).astype(np.int32)


def _count_end_run(b, code: int, side: int) -> np.ndarray:
    """Length of the homopolymer run of `code` at the left (side=0) or
    right (side=1) end of each read (Read.countLeft/countRight)."""
    B, L = b.bases.shape
    pos = np.arange(L)[None, :]
    within = pos < b.lengths[:, None]
    if side == 0:
        isc = (b.bases == code) & within
        notc = ~isc & within
        first_bad = np.where(notc.any(axis=1), notc.argmax(axis=1), b.lengths)
        return first_bad.astype(np.int32)
    # right end: mirror per-read
    rev_idx = b.lengths[:, None] - 1 - pos
    valid = rev_idx >= 0
    rev = np.take_along_axis(b.bases, np.maximum(rev_idx, 0), axis=1)
    isc = (rev == code) & valid
    notc = ~isc & valid
    first_bad = np.where(notc.any(axis=1), notc.argmax(axis=1), b.lengths)
    return first_bad.astype(np.int32)


def _detect_poly_scan(bases_iter_cols, lengths, code, min_poly, max_non,
                      B, L):
    """Column-sequential state machine shared by left/right detection
    (BBDuk2.detectPolyLeft :4014): track (polymer run, non-poly count),
    remember the last position where the run reached min_poly; stop a
    read once its non-poly count exceeds max_non."""
    polymer = np.zeros(B, np.int32)
    nonpoly = np.zeros(B, np.int32)
    trim_to = np.full(B, -1, np.int32)
    for i, col in bases_iter_cols:
        active = (nonpoly <= max_non) & (i < lengths)
        isc = col == code
        polymer = np.where(active & isc, polymer + 1,
                           np.where(active, 0, polymer))
        hit = active & isc & (polymer >= min_poly)
        trim_to = np.where(hit, i, trim_to)
        nonpoly = np.where(
            hit, 0, np.where(active & ~isc, nonpoly + 1, nonpoly)
        )
    return trim_to + 1


def _detect_poly_left(b, code: int, min_poly: int, max_non: int):
    B, L = b.bases.shape
    return _detect_poly_scan(
        ((i, b.bases[:, i]) for i in range(L)),
        b.lengths, code, min_poly, max_non, B, L,
    )


def _detect_poly_right(b, code: int, min_poly: int, max_non: int):
    """Right-side scan walks i = len-1 down; position i here counts
    bases FROM the right end (the trim amount)."""
    B, L = b.bases.shape
    pos = np.arange(L)
    rev_idx = np.maximum(b.lengths[:, None] - 1 - pos[None, :], 0)
    rev = np.take_along_axis(b.bases, rev_idx, axis=1)
    return _detect_poly_scan(
        ((i, rev[:, i]) for i in range(L)),
        b.lengths, code, min_poly, max_non, B, L,
    )


def _subset(b, keep):
    from ..io.batch import ReadBatch

    return ReadBatch(
        bases=b.bases[keep],
        quals=b.quals[keep] if b.quals is not None else None,
        lengths=b.lengths[keep],
        ids=[],
    )


def _avg_quality_by_prob(b, max_bases: int) -> np.ndarray:
    """Read.avgQualityByProbabilityDouble (stream/Read.java:2218-2227)."""
    lim = b.lengths if max_bases < 1 else np.minimum(max_bases, b.lengths)
    L = b.padded_len
    pos = np.arange(L)[None, :]
    within = pos < lim[:, None]
    defined = b.bases < 4
    q = np.where(defined, b.quals, 0)
    pe = PROB_ERROR[q]
    contrib = np.where(within & defined, pe, np.float32(0))
    # float32 sequential sum parity: sum in float32 via cumulative add
    e = contrib.astype(np.float32).sum(axis=1, dtype=np.float32)
    div = np.where(lim > 0, lim, 1)
    p = e / div.astype(np.float32)
    with np.errstate(divide="ignore"):
        phred = np.where(
            p >= 1, 0.0, np.where(p <= 1e-6, 60.0, -10.0 * np.log10(p))
        )
    return np.where(b.lengths > 0, phred, 0.0)


def _count_undefined(b) -> np.ndarray:
    return ((b.bases >= 4) & b.valid_mask()).sum(axis=1)


def _has_min_consecutive(b, min_run: int) -> np.ndarray:
    """Read.hasMinConsecutiveBases (stream/Read.java:2846)."""
    defined = (b.bases < 4) & b.valid_mask()
    B, L = defined.shape
    run = np.zeros(B, dtype=np.int64)
    best = np.zeros(B, dtype=np.int64)
    for i in range(L):
        run = np.where(defined[:, i], run + 1, 0)
        best = np.maximum(best, run)
    return best >= min_run


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    a = tokenize(argv)
    profile = a.get("profile")
    showtimes = a.get_bool("showtimes", "xtime", default=False)
    from ..utils.timer import PhaseTimer, device_profile

    timer = PhaseTimer()
    with device_profile(profile if profile not in ("f", "false") else None,
                        a.get("device", default="cuda")):
        cfg = parse_args(argv)
        with timer.phase("Setup"):
            tool = BBDuk(cfg)
        with timer.phase("Processing"):
            stats = tool.run()
    tool.print_stats()
    if showtimes:
        timer.report()
    return stats


if __name__ == "__main__":
    main()
