"""BBMap — seed-and-extend read mapping (BASELINE config #3).

The PyTorch port of bbtools_tpu/models/bbmap.py, itself a batched
redesign of align2/BBMap.java + AbstractMapThread: the per-read quickMap
loop becomes staged batch phases —

  1. seed:    k=13 keys at spaced offsets, fwd + rcomp (host numpy)
  2. cluster: candidate diagonals from the CSR SeedIndex, grouped within
              a max-indel window, ranked by seed votes (host numpy)
  3. score:   batched ungapped scoreNoIndels on every candidate site
              (ops/score_ungapped.py, torch on the device)
  4. extend:  the unpruned MultiStateAligner11ts fill with traceback
              planes (ops/msa_fill.py, the CUDA kernel csrc/msa_fill.cu)
              and the traceback walk (ops/msa.py), per window class
  5. emit:    match string -> CIGAR 1.4 / MAPQ / SAM (host)

The device phases run where `device=` says (cuda by default); on the
default single-end path they are one fused step per batch
(ops/map_fused.py). The host code (seeding, clustering, the clearzone
ladder, pairing, rescue selection, SAM) is a copy of the JAX package's;
only the device calls differ. With bloomfilter=t the reference's
31-mers go into a count-min sketch on the device (ops/cms.py), and each
batch is prescreened by one query of its reads' 31-mers. The mapPacBio
and bbmapskimmer presets widen the window classes to 7,640 extra columns
and take reads of up to 6,000 bases; a class whose traceback planes
would not fit the plane budget (ops/msa_fill.plane_budget: a share of
the card's free memory) sends its batch to the staged path, which fills
and walks the class in groups of tasks; no output changes. covstats=/basecov=/covhist=/bincov= write the
coverage of the primary alignments (models/pileup.py's writers).
tpshards=N shards the ungapped scoring and the fill and walk over N
devices (`enable_mesh`, parallel/sharded_count.py), with the same SAM.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fastq import FastqReader
from ..io.readwrite import open_output
from ..io.sam import (
    FFIRST,
    FPAIRED,
    FREVERSE,
    FSECOND,
    FUNMAPPED,
    SamRecord,
    SamWriter,
    match_to_cigar14,
    to_mapq,
)
from ..ops import msa_constants as MC
from ..ops.kmers import rolling_kmers_np
from ..ops.msa import match_strings_np
from ..ops.msa_fill import fill_walk
from ..ops.score_ungapped import score_no_indels, score_no_indels_offsets
from .bbmap_index import SeedIndex

BIG = 1 << 30


@dataclass
class BBMapConfig:
    ref: str | None = None
    index_path: str | None = None
    overwrite_index: bool = False
    in1: str | None = None
    in2: str | None = None
    out: str | None = None
    k: int = 13
    min_ratio: float = 0.56  # BBMap.java:62 minratio
    rescue_mates: bool = True  # AbstractMapThread rescue (paired only)
    rescue_dist: int = 800  # ungapped mate-search window beyond the anchor
    max_indel: int = 16000  # diagonal clustering window (BBMap.java maxindel)
    max_sites: int = 8  # candidate clusters per read/strand
    key_density: float = 1.9  # keys per (len-k+1)/... (KeyRing density)
    ambig: str = "best"  # best/toss/random/all
    #: local alignment output (bbmap.sh local=t): clip alignment ends
    #: that lower the score to soft-clips (Read.toLocalAlignment role)
    local: bool = False
    batch_reads: int = 4096
    pad: int = 12  # DP window slack each side
    max_hits_per_key: int = 2000
    #: static DP window width classes: extra columns beyond read length.
    #: A cluster whose diagonal spread fits E_c - 2*pad aligns in a width
    #: L + E_c window — the TPU analog of the reference's fixed
    #: ALIGN_COLUMNS arenas (BBMapThread.java ALIGN_COLUMNS=2000 for
    #: 600 bp rows; BBIndexPacBio.java:2643 ALIGN_COLUMNS=7600). Static
    #: per-class shapes keep XLA/Pallas compiles bounded.
    window_extras: tuple = (24, 152, 536, 2072)
    #: break FASTA input reads longer than this into chunks
    #: (bbmap.sh fastareadlen=500; mapPacBio.sh fastareadlen=6000)
    fastareadlen: int = 500
    #: print secondary alignments (skimmer semantics, flag 0x100)
    secondary: bool = False
    dp_top: int = 3  # gapped-extend the top-N ungapped sites per read
    #: fused single-dispatch device phase (ops/map_fused.py): ungapped +
    #: speculative DP + winner selection + walk-row gather in ONE device
    #: dispatch and ONE pull per batch (the reference's per-thread loop
    #: has no syncs either, AbstractMapThread.java:518-700). Applies to
    #: the default single-end path; keep-sites / ambig=random / sharded
    #: runs use the staged path
    fused: bool = True
    #: bloom prescreen (bbmap.sh bloomfilter flag): reads sharing NO
    #: 31-mer with the reference skip the alignment and come out unmapped
    bloom_prescreen: bool = False
    sam_version: str = "1.4"  # sam=1.3 emits M cigars
    mhist: str | None = None  # per-position match/sub/del/ins rates
    idhist: str | None = None  # identity histogram
    #: per-scaffold hit table (BBMap scafstats= flag,
    #: align2/BBSplitter scafstats/refstats machinery)
    scafstats: str | None = None
    #: inline coverage outputs, emitted by the mapper itself
    #: (align2/AbstractMapper.printOutput -> CoveragePileup; covstats=/
    #: basecov=/covhist=/bincov= flags) — no separate pileup pass needed
    covstats: str | None = None
    basecov: str | None = None
    covhist: str | None = None
    bincov: str | None = None
    binsize: int = 1000
    #: fastq split outputs (BBMap outu=/outm= flags): unmapped reads /
    #: mapped reads as fastq; pairs stay together (a pair counts as
    #: mapped when EITHER mate maps — AbstractMapThread pair semantics
    #: used by removehuman.sh-style decontamination wrappers)
    outu1: str | None = None
    outu2: str | None = None
    outm1: str | None = None
    outm2: str | None = None
    #: scaffold blacklist (align2/Blacklist.java): reads whose primary
    #: site lands on a listed scaffold are dropped from out=/outm= and
    #: routed to outb= instead (comma list of name files or fastas)
    blacklist: str | None = None
    outb1: str | None = None
    #: deletions at least this long print as N (intron) CIGAR ops
    #: (SamLine INTRON_LIMIT, bbmap.sh intronlen= — RNAseq output mode)
    intronlen: int = 999999999
    #: tpshards=N: shard the alignment compute (ungapped scoring + DP
    #: fill/walk) data-parallel over an N-device mesh; the same bytes
    tp_shards: int = 0
    #: penalizeambiguous=/pambig= (AbstractMapper.java:310): when true
    #: (reference default) near-best runner-up sites depress the map
    #: score (applyClearzone3) and messy alignment tips pay a score
    #: penalty (calcTipScorePenalty) — both feed MAPQ
    penalize_ambig: bool = True
    #: torch device of the alignment phases: cuda (default), cuda:N or cpu
    device: str = "cuda"


def pacbio_preset(c: "BBMapConfig"):
    """mapPacBio.sh defaults: align2.BBMapPacBio (minratio=0.40
    fastareadlen=6000, ALIGN_ROWS=6020 / ALIGN_COLUMNS=7600)."""
    c.k = 12
    c.min_ratio = 0.40
    c.fastareadlen = 6000
    c.max_indel = 16000
    c.window_extras = (24, 536, 2072, 7640)
    c.batch_reads = 512
    return c


def skimmer_preset(c: "BBMapConfig"):
    """bbmapskimmer.sh defaults: align2.BBMapPacBioSkimmer with
    ambig=all + secondary-site printing."""
    pacbio_preset(c)
    c.ambig = "all"
    c.secondary = True
    return c


def parse_args(argv, preset: str | None = None):
    """The JAX package's flag surface, plus `device=`."""
    a = tokenize(argv)
    c = BBMapConfig()
    if preset == "pacbio":
        pacbio_preset(c)
    elif preset == "skimmer":
        skimmer_preset(c)
    c.ref = a.get("ref")
    if not a.get_bool("nodisk", default=True):
        c.index_path = a.get("path", "indexpath", default=".") or "."
    elif a.get("path", "indexpath"):
        c.index_path = a.get("path", "indexpath")
    c.overwrite_index = a.get_bool("overwrite", "ow", default=False)
    c.in1 = a.get("in", "in1")
    c.in2 = a.get("in2")
    c.out = a.get("out")
    c.outu1 = a.get("outu", "outu1")
    c.outu2 = a.get("outu2")
    c.outm1 = a.get("outm", "outm1")
    c.outm2 = a.get("outm2")
    # `outm=` doubles as the SAM destination when it looks like SAM
    if c.out is None and c.outm1 and c.outm1.endswith((".sam", ".bam")):
        c.out, c.outm1 = c.outm1, None
    c.k = a.get_int("k", default=c.k)
    c.min_ratio = a.get_float("minratio", "minid", default=c.min_ratio)
    c.rescue_mates = a.get_bool("rescuemates", "rescue", default=True)
    c.rescue_dist = a.get_int("rescuedist", default=800)
    c.max_indel = a.get_int("maxindel", default=c.max_indel)
    c.max_sites = a.get_int("maxsites", default=8)
    c.ambig = a.get("ambiguous", "ambig", default=c.ambig) or "best"
    c.local = a.get_bool("local", default=c.local)
    c.secondary = a.get_bool("secondary", default=c.secondary)
    c.fastareadlen = a.get_int("fastareadlen", default=c.fastareadlen)
    c.batch_reads = a.get_int("batchreads", default=c.batch_reads)
    c.bloom_prescreen = a.get_bool("bloomfilter", "bloom", default=False)
    c.fused = a.get_bool("fused", "fusedpipeline", default=True)
    c.blacklist = a.get("blacklist")
    c.outb1 = a.get("outb", "outb1", "outblacklist", "outblacklist1")
    c.intronlen = a.get_int("intronlen", default=c.intronlen)
    c.penalize_ambig = a.get_bool(
        "penalizeambiguous", "penalizeambig", "pambig", default=True
    )
    c.tp_shards = a.get_int("tpshards", default=0)
    c.sam_version = a.get("sam", "samversion", default="1.4") or "1.4"
    c.mhist = a.get("mhist")
    c.idhist = a.get("idhist")
    c.scafstats = a.get("scafstats")
    c.covstats = a.get("covstats")
    c.basecov = a.get("basecov")
    c.covhist = a.get("covhist")
    c.bincov = a.get("bincov")
    c.binsize = a.get_int("binsize", default=1000)
    c.device = a.get("device", default="cuda")
    from ..core.parser import test_output_files

    test_output_files(
        a.get_bool("overwrite", "ow", default=True),
        c.out, inputs=(c.in1, c.in2, c.ref),
    )
    return c


def max_quality(length) -> np.ndarray:
    """MSA.maxQuality: perfect-read score."""
    return MC.POINTS_MATCH + (np.asarray(length, dtype=np.int64) - 1) * MC.POINTS_MATCH2


@dataclass
class MapResult:
    mapped: bool = False
    #: primary site on a blacklisted scaffold (align2/Blacklist): the
    #: read is removed from SAM/outm and routed to outb=
    blacklisted: bool = False
    flat_start: int = 0  # 0-based flat ref coordinate of alignment start
    strand: int = 0
    score: int = 0
    match: bytes = b""
    ambig: bool = False
    #: read base codes in the aligned orientation (tip-penalty input)
    codes: np.ndarray | None = None
    #: secondary sites (flat_start, strand, score, match) — skimmer output
    sites: list = field(default_factory=list)


class BBMap:
    def __init__(self, cfg: BBMapConfig, index: SeedIndex | None = None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        t0 = time.perf_counter()
        if index is None:
            index = self._load_or_build_index()
        #: seconds spent loading or building the seed index
        self.index_seconds = time.perf_counter() - t0
        self.index = index
        self.ref = index.ref
        self.bloom = None
        if cfg.bloom_prescreen:
            from ..ops.cms import CountMinSketch

            cms = CountMinSketch(device=self.device)
            codes = self.ref.codes
            CHUNK = 1 << 20
            for c0 in range(0, len(codes), CHUNK):
                seg = codes[max(c0 - 30, 0) : c0 + CHUNK]
                if len(seg) < 31:
                    continue
                fwd, rkm, runlen = rolling_kmers_np(seg[None, :], 31)
                ok = runlen[0] >= 31
                cms.add(np.maximum(fwd[0][ok], rkm[0][ok]))
            self.bloom = cms
        self.reads_mapped = 0
        self.prescreened = 0
        self.reads_unmapped = 0
        self.reads_in = 0
        self.rescued = 0
        #: batches whose fused phase overflowed its walk cap or the plane
        #: budget and ran staged
        self.fused_overflows = 0
        #: fill calls of the DP: one a window class in the fused phase,
        #: one per group of a class's tasks (ops.msa_fill.fill_groups) on
        #: the staged path
        self.plane_groups = 0
        self._mhist = np.zeros((4, 1024), np.int64)  # m, S, D, I by pos
        self._idhist = np.zeros(101, np.int64)
        self._scaf_counts = None  # [nscaf, 4]: reads_u, reads_a, bases_u, bases_a
        # scaffold blacklist (align2/Blacklist.addToBlacklist): names from
        # plain lists or fasta headers, matched on the first token
        self._blacklist_scafs: set | None = None
        if cfg.blacklist:
            names = set()
            from ..io.readwrite import open_input

            for path in cfg.blacklist.split(","):
                with open_input(path.strip()) as fh:
                    for line in fh.read().splitlines():
                        line = line.strip()
                        if not line:
                            continue
                        if line.startswith(b">"):
                            names.add(line[1:].split()[0])
                        else:
                            names.add(line.split()[0])
            self._blacklist_scafs = {
                i for i, n in enumerate(self.ref.names)
                if n.split()[0] in names
            }
        self._mesh = None
        if cfg.tp_shards > 1:
            self.enable_mesh(cfg.tp_shards)

    # ------------------------------------------------------------------
    def enable_mesh(self, n_dp: int | None = None, mesh=None):
        """Multi-device mode (bbmap tpshards=N): alignment tasks shard
        data-parallel over a dp mesh; the ungapped scoring pass and the
        banded DP fill and traceback walk run one slab per device
        (parallel/sharded_count.py). The reference parallelizes the same
        loop across worker threads (align2/AbstractMapThread batch loop,
        align2/BBMap.java:536-561). Without `mesh`, the first N devices
        of `device=` (parallel/mesh.py `local_devices`). The SAM is the
        single-device run's."""
        from ..parallel.mesh import local_devices, make_mesh

        if mesh is None:
            devices = local_devices(self.device)
            nd = len(devices)
            n_dp = n_dp or nd
            if n_dp > nd:
                raise ValueError(
                    f"tpshards={n_dp} exceeds {nd} devices"
                )
            mesh = make_mesh(n_dp=n_dp, n_tp=1, devices=devices[:n_dp])
        self._mesh = mesh

    def _dp_pad(self, *arrays):
        """Each task array padded to a multiple of dp with copies of task
        0 (dropped again from the outputs)."""
        n_dp = int(self._mesh.shape["dp"])
        extra = (-len(arrays[0])) % n_dp
        return [np.concatenate([a, np.repeat(a[:1], extra, 0)]) if extra else a
                for a in arrays]

    def _sharded_ungapped(self, L, W, task_reads, task_lens, refwins, pad):
        """score_no_indels of the tasks over the mesh; host int32 [T]."""
        from ..parallel.sharded_count import sharded_ungapped_score_step

        T0 = len(task_lens)
        task_reads, task_lens, refwins = self._dp_pad(
            task_reads, task_lens.astype(np.int32), refwins
        )
        Tp = len(task_lens)
        scores = sharded_ungapped_score_step(self._mesh, L, W)(
            self._dev(task_reads), self._dev(task_lens),
            self._dev(refwins), self._dev(np.full(Tp, pad, np.int32)),
        )
        return scores[:T0].cpu().numpy()

    def _sharded_fill_walk(self, sreads, slens, srefs):
        """The fill and walk of one window class over the mesh: (best
        score, column, state, walk ops, steps) on the mesh's first
        device, the ops [T, L+Wc]."""
        from ..parallel.sharded_count import make_sharded_fill_walk

        B0 = len(slens)
        sreads, slens, srefs = self._dp_pad(sreads, slens, srefs)
        fn = make_sharded_fill_walk(self._mesh, sreads.shape[1], srefs.shape[1])
        out = fn(sreads, slens, srefs)
        self.plane_groups += fn.fill_calls
        return tuple(x[:B0] for x in out)

    def _load_or_build_index(self) -> SeedIndex:
        """Build the seed index, caching it under `path=` like the
        reference's on-disk genome index (align2/IndexMaker4; reuse unless
        nodisk/overwrite)."""
        import os
        import sys as _sys
        import time as _time

        cfg = self.cfg
        cache = None
        if cfg.index_path:
            os.makedirs(cfg.index_path, exist_ok=True)
            tag = os.path.basename(cfg.ref or "ref")
            cache = os.path.join(
                cfg.index_path, f"{tag}.k{cfg.k}.seedindex.npz"
            )
            if os.path.exists(cache) and not cfg.overwrite_index:
                t0 = _time.time()
                idx = SeedIndex.load(cache)
                print(
                    f"Loaded index {cache} in {_time.time()-t0:.2f}s",
                    file=_sys.stderr,
                )
                return idx
        ref = load_ref(cfg.ref)
        idx = SeedIndex.build(ref, k=cfg.k, max_hits=cfg.max_hits_per_key)
        if cache is not None:
            idx.save(cache)
            print(f"Wrote index {cache}", file=_sys.stderr)
        return idx

    # ------------------------------------------------------------------
    def seed_offsets(self, length: int) -> np.ndarray:
        k = self.cfg.k
        n_slots = max(length - k + 1, 1)
        n_keys = max(2, min(n_slots, int(length * self.cfg.key_density / k)))
        return np.unique(np.linspace(0, n_slots - 1, n_keys).astype(np.int64))

    def _seed_slots(self, bases: np.ndarray, lengths: np.ndarray):
        """Per-read seed keys/masks/offsets ([2, B, K] planes) — the
        KeyRing.makeOffsets analog shared by the host and device
        cluster phases."""
        cfg = self.cfg
        k = cfg.k
        B, L = bases.shape
        kdtype = np.int32 if 2 * k <= 30 else np.int64
        fwd, rkm, runlen = rolling_kmers_np(bases, k, dtype=kdtype)
        space_mask = (1 << (2 * k)) - 1
        lengths = lengths.astype(np.int64)
        # per-read offsets matrix [B, K]
        n_slots = np.maximum(lengths - k + 1, 1)
        K = max(
            2, min(int(n_slots.max(initial=1)), int(L * cfg.key_density / k))
        )
        frac = np.linspace(0, 1, K)
        offs = np.round(frac[None, :] * (n_slots[:, None] - 1)).astype(np.int64)
        valid_off = np.ones((B, K), dtype=bool)
        valid_off[:, 1:] = offs[:, 1:] != offs[:, :-1]  # dedupe equal offsets
        valid_off &= (lengths >= k)[:, None]
        rows = np.arange(B)[:, None]
        # strand 0: key ends at offs+k-1; strand 1: rc-read offset o ->
        # rkm at forward index n-1-o
        kidx0 = np.minimum(offs + k - 1, L - 1)
        kidx1 = np.clip(lengths[:, None] - 1 - offs, 0, L - 1)
        keys = np.empty((2, B, K), dtype=np.int64)
        vmask = np.empty((2, B, K), dtype=bool)
        keys[0] = fwd[rows, kidx0] & space_mask
        vmask[0] = valid_off & (runlen[rows, kidx0] >= k)
        keys[1] = rkm[rows, kidx1] & space_mask
        vmask[1] = valid_off & (runlen[rows, kidx1] >= k)
        return keys, vmask, offs, K

    def candidates_for_batch(self, bases: np.ndarray, lengths: np.ndarray):
        """Seed + cluster phase, fully vectorized across the batch.

        Returns flat candidate arrays (read, diag_start, strand, votes,
        spread, modal_diag, nclusters[B]), ordered read-major (then
        strand, then votes descending) — no per-read Python lists
        anywhere. Host numpy: in production this stage runs in the
        prefetch thread, fully overlapped with the fused device phase
        of the previous batch (the round-4 device variant,
        ops/seed_cluster.seed_candidates_jnp, is output-identical but
        measured slower end-to-end: the extra dispatch cost more than
        the host work it saved — kept as an op-level building block,
        tests/test_bbmap_modes.py::test_device_seed_cluster_equals_host).
        """
        cfg = self.cfg
        B, L = bases.shape
        lengths = lengths.astype(np.int64)
        keys, vmask, offs, K = self._seed_slots(bases, lengths)
        bridge = min(cfg.max_indel, cfg.window_extras[-1] - 2 * cfg.pad)
        flat_keys = keys.reshape(-1)
        flat_valid = vmask.reshape(-1)
        flat_off = np.broadcast_to(offs[None], (2, B, K)).reshape(-1)
        empty = tuple(np.empty(0, np.int64) for _ in range(6)) + (
            np.zeros(B, np.int64),
        )
        sel = np.flatnonzero(flat_valid)
        if len(sel) == 0:
            return empty
        sites, owner = self.index.expand(flat_keys[sel])
        if len(sites) == 0:
            return empty
        src = sel[owner]  # index into the (2, B, K) flattening
        strand = src // (B * K)
        read = (src // K) % B
        diag = sites.astype(np.int64) - flat_off[src]
        # group by (read, strand, diag): sort then cluster within max_indel
        group = (read * 2 + strand) * np.int64(1)
        order = np.lexsort((diag, group))
        g = group[order]
        d = diag[order]
        # merge threshold: only diagonals one DP window can actually
        # bridge; farther same-strand clusters stay separate candidates
        # (repeat copies / giant deletions — the latter are re-joined by
        # the two-anchor stitch in map_batch, maxindel semantics)
        bridge = min(cfg.max_indel, cfg.window_extras[-1] - 2 * cfg.pad)
        boundary = np.ones(len(d), dtype=bool)
        boundary[1:] = (g[1:] != g[:-1]) | (np.diff(d) > bridge)
        cid = np.cumsum(boundary) - 1
        votes = np.bincount(cid)
        firsts = d[boundary]
        cgroup = g[boundary]
        # spread = diagonal range of the cluster (how many extra DP
        # columns a gapped alignment spanning it needs)
        ends = np.append(np.flatnonzero(boundary)[1:], len(d))
        spread = d[ends - 1] - firsts
        # modal diagonal (most seed hits) anchors the ungapped score; for
        # a clean site mode == first, for an indel site it is the bigger
        # exact-match flank
        b2 = boundary.copy()
        b2[1:] |= d[1:] != d[:-1]
        rid = np.cumsum(b2) - 1
        rcount = np.bincount(rid)
        rcluster = cid[b2]
        rdiag = d[b2]
        ro = np.lexsort((-rcount, rcluster))
        rc_sorted = rcluster[ro]
        firstrun = np.ones(len(ro), dtype=bool)
        firstrun[1:] = rc_sorted[1:] != rc_sorted[:-1]
        modal = np.empty(len(firsts), dtype=np.int64)
        modal[rc_sorted[firstrun]] = rdiag[ro[firstrun]]
        # top max_sites clusters per (read, strand) by votes
        corder = np.lexsort((-votes, cgroup))
        cg = cgroup[corder]
        # rank within group: positions since the group start (cg is sorted)
        rank = np.arange(len(cg)) - np.searchsorted(cg, cg)
        sel2 = corder[rank < cfg.max_sites]
        grp = cgroup[sel2]
        # pre-cap cluster census per read (CLEARZONE_LIMIT1e input)
        nclusters = np.bincount(cgroup // 2, minlength=B)[:B]
        return (
            grp // 2,
            firsts[sel2],
            grp & 1,
            votes[sel2].astype(np.int64),
            spread[sel2],
            modal[sel2],
            nclusters.astype(np.int64),
        )

    def _prefetch_candidates(self, reader):
        """Double-buffered host stage: read + seed/cluster for batch i+1
        run in a worker thread while batch i is in its device phases
        (the candidate host work was ~0.14 s per 4096 reads, serialized
        with the device before — the reference overlaps the same stages
        with its reader/worker thread split, AbstractMapThread :518)."""
        import os
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        workers = max(1, min(4, (os.cpu_count() or 2) - 1))
        fused_ok = self._fused_ok() and self.bloom is None

        def work(b):
            lengths = b.lengths.astype(np.int64)
            cand = self.candidates_for_batch(b.bases, lengths)
            prep = None
            if fused_ok and len(cand[0]):
                (t_read, _t_diag, t_strand, _t_votes, _t_spread,
                 t_anchor, _nc) = cand
                task = self._build_tasks(
                    b.bases, lengths, t_read, t_strand, t_anchor
                )
                task_reads, task_lens, refwins, _W = task
                fprep = self._fused_prep(
                    b.bases.shape[0], b.bases.shape[1], cand[0], cand[3],
                    cand[4], cand[5], cand[1], task_reads, task_lens,
                    refwins,
                )
                prep = (task, fprep)
            return b, cand, prep

        with ThreadPoolExecutor(workers) as ex:
            pending: deque = deque()
            for b in reader:
                pending.append(ex.submit(work, b))
                if len(pending) > workers:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

    # ------------------------------------------------------------------
    def _fused_ok(self) -> bool:
        cfg = self.cfg
        keep_sites = (
            cfg.secondary or cfg.ambig == "all"
            or getattr(self, "_keep_sites", False)
        )
        return (
            cfg.fused and self._mesh is None and not keep_sites
            and cfg.ambig != "random"
        )

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the alignment device."""
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def map_batch(self, batch, cand=None, prep=None) -> list[MapResult]:
        cfg = self.cfg
        bases = batch.bases
        lengths = batch.lengths.astype(np.int64)
        B, L = bases.shape
        self.reads_in += B
        (t_read, t_diag, t_strand, t_votes, t_spread, t_anchor,
         n_clusters) = (
            self.candidates_for_batch(bases, lengths)
            if cand is None
            else cand
        )
        if self.bloom is not None:
            fwd31, rkm31, run31 = rolling_kmers_np(bases, 31)
            ok31 = (run31 >= 31) & (
                np.arange(L)[None, :] < lengths[:, None]
            )
            keys31 = np.maximum(fwd31, rkm31)
            hits = np.zeros(B, np.int64)
            flat_ok = ok31.reshape(-1)
            if flat_ok.any():
                cnt = np.zeros(ok31.size, np.int64)
                cnt[flat_ok] = self.bloom.query(
                    keys31.reshape(-1)[flat_ok]
                )
                hits = (cnt.reshape(ok31.shape) > 0).sum(axis=1)
            self.prescreened += int((hits == 0).sum())
            tkeep = hits[t_read] != 0
            t_read = t_read[tkeep]
            t_diag = t_diag[tkeep]
            t_strand = t_strand[tkeep]
            t_votes = t_votes[tkeep]
            t_spread = t_spread[tkeep]
            t_anchor = t_anchor[tkeep]
        results = [MapResult() for _ in range(B)]
        if len(t_read) == 0:
            self.reads_unmapped += B
            return results
        T = len(t_read)
        if prep is not None and self.bloom is None:
            (task_reads, task_lens, refwins, W), fprep = prep
        else:
            task_reads, task_lens, refwins, W = self._build_tasks(
                bases, lengths, t_read, t_strand, t_anchor
            )
            fprep = None
        keep_sites = (
            cfg.secondary or cfg.ambig == "all"
            or getattr(self, "_keep_sites", False)
        )
        if self._fused_ok():
            # ONE device dispatch + ONE pull for the whole batch; None =
            # walk-cap overflow, redo staged
            fused_out = self._fused_phase(
                B, L, t_read, t_votes, t_spread, t_anchor, t_diag,
                task_reads, task_lens, refwins, lengths, fprep=fprep,
            )
            if fused_out is not None:
                emit, site_out, dp_score, best, second = fused_out
                return self._finalize_batch(
                    B, results, emit, site_out, dp_score, best, second,
                    t_read, t_strand, t_anchor, t_votes, task_reads,
                    lengths, n_clusters,
                )
            self.fused_overflows += 1
        if self._mesh is not None:
            ug = self._sharded_ungapped(
                L, W, task_reads, task_lens, refwins, cfg.pad
            )
        else:
            ug = score_no_indels(
                L,
                self._dev(task_reads),
                self._dev(task_lens.astype(np.int32)),
                self._dev(refwins),
                self._dev(np.full(T, cfg.pad, np.int32)),
                self._dev(np.full(T, W, np.int32)),
            ).cpu().numpy()
        maxq = max_quality(task_lens)
        # DP only when an indel alignment could beat the ungapped score
        # (maxImperfectScore gating, MultiStateAligner11ts.java:2293-2304)
        max_imperfect = maxq + min(MC.POINTS_DEL, MC.POINTS_INS - MC.POINTS_MATCH2)
        need_dp = (ug <= max_imperfect) & (task_lens >= cfg.k)
        # gapped-extend the top dp_top ungapped candidates per read (the
        # reference trims the site list before slow alignment,
        # BBMapThread.java:507 trimList) PLUS the top-votes cluster — a
        # long-indel site can rank low on its ungapped flank score alone
        order = np.lexsort((-ug, t_read))
        tr = t_read[order]
        rank = np.arange(len(tr)) - np.searchsorted(tr, tr)
        topk = np.zeros(T, dtype=bool)
        topk[order[rank < cfg.dp_top]] = True
        vorder = np.lexsort((-t_votes, t_read))
        tv = t_read[vorder]
        vrank = np.arange(len(tv)) - np.searchsorted(tv, tv)
        topk[vorder[vrank < 1]] = True
        need_dp &= topk

        # DP window class per task: smallest static width whose extra
        # columns cover the cluster's diagonal spread (static shapes ->
        # bounded XLA/Pallas compiles; the reference's fixed ALIGN_COLUMNS
        # arenas serve the same purpose)
        extras = cfg.window_extras
        n_cls = len(extras)
        t_cls = np.full(T, n_cls - 1, np.int64)
        for c in range(n_cls - 2, -1, -1):
            t_cls[t_spread <= extras[c] - 2 * cfg.pad] = c
        # spread beyond the largest class: re-anchor on the modal diagonal
        # (the alignment clips whatever the window misses — reference
        # behavior when a site exceeds ALIGN_COLUMNS)
        clamped = t_spread > extras[-1] - 2 * cfg.pad
        dp_start = np.where(
            clamped, t_anchor - extras[-1] // 2, t_diag - cfg.pad
        )

        dp_score = ug.astype(np.int64).copy()
        dp_col = np.full(T, -1, np.int64)  # end col within window
        dp_state = np.full(T, -1, np.int64)
        dp_subidx = np.full(T, -1, np.int64)  # index into the class subset
        dp_planes: dict[int, tuple] = {}
        dp_dev: dict[int, tuple] = {}
        for c in range(n_cls):
            sel = np.flatnonzero(need_dp & (t_cls == c))
            if not len(sel):
                continue
            Wc = L + extras[c]
            # unpruned fill (fillUnlimited semantics) with traceback
            # planes (the B4 kernel on CUDA). Unpruned scores are >= pruned
            # ones and the min-score filter runs at winner selection, so
            # site choice is unchanged.
            srefs = self._ref_windows(dp_start[sel], Wc)
            sreads = task_reads[sel]
            slens = task_lens[sel].astype(np.int32)
            if self._mesh is not None:
                dp_dev[c] = self._sharded_fill_walk(sreads, slens, srefs)
            else:
                # the class in groups of tasks whose planes fit the
                # budget, one group where they all fit; the walk over
                # every DP task on the device; only the winners' rows come
                # back (below)
                dp_dev[c], n_groups = fill_walk(sreads, slens, srefs, self.device)
                self.plane_groups += n_groups
            dp_planes[c] = (slens, sel, srefs, Wc)
        if dp_dev:
            # pull only the small per-task arrays now; the [T, steps] ops
            # planes stay on device until the winner subset is known (a
            # device gather pulls just the winner rows — the bulk of the
            # walk output never crosses the link)
            pulled = {
                c: tuple(x.cpu().numpy() for x in (v[0], v[1], v[2], v[4]))
                for c, v in dp_dev.items()
            }
            for c, (bs, bc, bst, nst_c) in pulled.items():
                slens, sel, srefs, Wc = dp_planes[c]
                bs = bs.astype(np.int64)
                dp_better = bs > ug[sel]
                dp_score[sel] = np.maximum(bs, ug[sel])
                dp_col[sel] = np.where(dp_better, bc, -1)
                dp_state[sel] = np.where(dp_better, bst, -1)
                dp_subidx[sel] = np.arange(len(sel))
                dp_planes[c] = (dp_dev[c][3], nst_c, bc, slens, sel, srefs, Wc)
        # pick best + second best per read: stable sort by (read, -score)
        # keeps the sequential loop's lowest-task-index tie-break
        worder = np.lexsort((-dp_score, t_read))
        twr = t_read[worder]
        wrank = np.arange(T) - np.searchsorted(twr, twr)
        best = {
            int(t_read[i]): (int(dp_score[i]), int(i))
            for i in worder[wrank == 0]
        }
        second = {
            int(t_read[i]): (int(dp_score[i]), int(i))
            for i in worder[wrank == 1]
        }
        # emit set: the primary winner per read, plus secondary sites when
        # skimmer semantics are on (secondary=t / ambig=all)
        emit: list[tuple[int, int, int, bool]] = []  # (b, i, score, primary)
        if cfg.ambig == "random":
            # ambiguous=random (AbstractMapThread AMBIGUOUS_RANDOM):
            # the primary is drawn uniformly from the sites inside the
            # winner's clearzone, deterministic per (seed, read)
            if not hasattr(self, "_ambig_rng"):
                self._ambig_rng = np.random.default_rng(0)
            ties_by_read: dict[int, list[int]] = {}
            for i in range(T):
                b = int(t_read[i])
                s0 = best.get(b, (-BIG, -1))[0]
                cz = clearzone_for(s0, int(max_quality(lengths[b])))
                if dp_score[i] >= s0 - cz:
                    ties_by_read.setdefault(b, []).append(i)
        for b, (s, i) in best.items():
            if s >= min_score_for(int(lengths[b]), cfg.min_ratio):
                if cfg.ambig == "random":
                    ties = ties_by_read.get(b, [int(i)])
                    i = ties[int(self._ambig_rng.integers(len(ties)))]
                    s = int(dp_score[i])
                emit.append((b, int(i), int(s), True))
        if keep_sites:
            prim = {b: i for b, (s, i) in best.items()}
            by_read: dict[int, list] = {}
            for i in range(T):
                b = int(t_read[i])
                if i == prim.get(b):
                    continue
                s = int(dp_score[i])
                if s >= min_score_for(int(lengths[b]), cfg.min_ratio):
                    by_read.setdefault(b, []).append((s, i))
            for b, lst in by_read.items():
                lst.sort(key=lambda t: -t[0])
                for s, i in lst[: cfg.max_sites - 1]:
                    emit.append((b, i, s, False))
        # match strings: winners resolved ungapped (no indels possible)
        # get a direct comparison string (genMatchNoIndels analog); DP
        # winners get a plane walk, batched per window class
        gapped = [e for e in emit if dp_col[e[1]] >= 0]
        plain = [e for e in emit if dp_col[e[1]] < 0]
        site_out: dict[int, tuple[int, bytes]] = {}  # task -> (flat_start, match)
        if plain:
            p_task = np.asarray([e[1] for e in plain])
            rd = task_reads[p_task]  # [P, L]
            rf = refwins[p_task, cfg.pad : cfg.pad + L]
            mm = np.where(
                (rd == rf) & (rd < 4), ord("m"),
                np.where((rd >= 4) | (rf >= 4), ord("N"), ord("S")),
            ).astype(np.uint8)
            mbytes = mm.tobytes()
            for j, (b, i, s, _p) in enumerate(plain):
                n = int(lengths[b])
                site_out[i] = (int(t_anchor[i]), mbytes[j * L : j * L + n])
        bycls: dict[int, list] = {}
        for e in gapped:
            bycls.setdefault(int(t_cls[e[1]]), []).append(e)
        # gather the winners' walk rows on the device, then pull them
        subs: dict[int, np.ndarray] = {}
        ops_pulled: dict[int, np.ndarray] = {}
        for c, ws in bycls.items():
            sub = np.asarray([dp_subidx[e[1]] for e in ws])
            subs[c] = sub
            ops_pulled[c] = dp_planes[c][0][self._dev(sub)].cpu().numpy()
        for c, ws in bycls.items():
            _ops_d, nsteps, bc_all, slens_all, sel, srefs, Wc = dp_planes[c]
            sub = subs[c]
            matches = match_strings_np(
                ops_pulled[c],
                nsteps[sub],
                task_reads[sel][sub],
                slens_all[sub],
                srefs[sub],
                np.full(len(sub), Wc, np.int32),
                bc_all[sub],
            )
            for j, (b, i, s, _p) in enumerate(ws):
                m = matches[j]
                ndiag = sum(m.count(x) for x in (b"m", b"S", b"N", b"D"))
                start_col = int(bc_all[sub[j]]) - ndiag
                site_out[i] = (int(dp_start[i] + start_col), m)
        return self._finalize_batch(
            B, results, emit, site_out, dp_score, best, second,
            t_read, t_strand, t_anchor, t_votes, task_reads, lengths,
            n_clusters,
        )

    def _build_tasks(self, bases, lengths, t_read, t_strand, t_anchor):
        """Task planes for a batch: oriented read rows (rc for strand 1,
        ONE rc row per input read then row-gather per task) and the
        ungapped scoring windows at the cluster's modal diagonal (the
        bigger exact flank when the site has an indel)."""
        cfg = self.cfg
        B, L = bases.shape
        task_lens0 = lengths[t_read]
        pos32 = np.arange(L, dtype=np.int32)[None, :]
        ln32 = lengths.astype(np.int32)
        rc_src = ln32[:, None] - 1 - pos32
        np.clip(rc_src, 0, L - 1, out=rc_src)
        rc_vals = np.take_along_axis(bases, rc_src, axis=1)
        rc_all = np.where(rc_vals < 4, 3 - rc_vals, 4).astype(np.uint8)
        rc_all[pos32 >= ln32[:, None]] = 4
        task_reads = np.where(
            (t_strand == 0)[:, None], bases[t_read], rc_all[t_read]
        )
        task_reads[pos32 >= task_lens0[:, None]] = 4
        W = L + 2 * cfg.pad
        refwins = self._ref_windows(t_anchor - cfg.pad, W)
        return task_reads, task_lens0, refwins, W

    def _fused_prep(self, B, L, t_read, t_votes, t_spread, t_anchor,
                    t_diag, task_reads, task_lens, refwins):
        """Host half of the fused phase: slot grid, vote-speculated DP
        subsets per window class, and the step's arguments on the
        device. The classes are not padded: the kernel takes any number
        of tasks, so every index is in range."""
        cfg = self.cfg
        T = len(t_read)
        K = 2 * cfg.max_sites
        W = refwins.shape[1]
        rank = np.arange(T) - np.searchsorted(t_read, t_read)
        slot_map = np.full((B, K), -1, np.int32)
        slot_map[t_read, rank] = np.arange(T, dtype=np.int32)
        flat_slot = (t_read * K + rank).astype(np.int32)
        # speculative DP set: top dp_top clusters per read by votes
        vorder = np.lexsort((-t_votes, t_read))
        tv = t_read[vorder]
        vrank = np.arange(T) - np.searchsorted(tv, tv)
        spec = np.zeros(T, bool)
        spec[vorder[vrank < cfg.dp_top]] = True
        spec &= task_lens >= cfg.k
        extras = cfg.window_extras
        n_cls = len(extras)
        t_cls = np.full(T, n_cls - 1, np.int64)
        for c in range(n_cls - 2, -1, -1):
            t_cls[t_spread <= extras[c] - 2 * cfg.pad] = c
        clamped = t_spread > extras[-1] - 2 * cfg.pad
        dp_start = np.where(
            clamped, t_anchor - extras[-1] // 2, t_diag - cfg.pad
        )
        maxq = max_quality(task_lens)
        max_imperfect = (
            maxq + min(MC.POINTS_DEL, MC.POINTS_INS - MC.POINTS_MATCH2)
        )
        cls_shapes: list[tuple] = []
        dp_args: list[tuple] = []
        cls_host: list[tuple] = []
        for c in range(n_cls):
            sel = np.flatnonzero(spec & (t_cls == c))
            n = len(sel)
            if not n:
                continue
            Wc = L + extras[c]
            srefs = self._ref_windows(dp_start[sel], Wc)
            cls_shapes.append((Wc, n))
            dp_args.append(tuple(self._dev(x) for x in (
                sel.astype(np.int32), flat_slot[sel],
                max_imperfect[sel].astype(np.int32), task_reads[sel],
                task_lens[sel].astype(np.int32), srefs,
            )))
            cls_host.append((sel, srefs, Wc, dp_start[sel]))
        # walked-winner cap: DP-improved winners are the indel reads —
        # a small fraction of B; overflow falls back to the staged path
        wcap = max(8, B // 8)
        return {
            "args": (
                L, W, K, tuple(cls_shapes), wcap,
                self._dev(task_reads), self._dev(task_lens.astype(np.int32)),
                self._dev(refwins), self._dev(slot_map), tuple(dp_args),
            ),
            "cls_host": cls_host,
            "K": K,
            "W": W,
        }

    def _fused_phase(self, B, L, t_read, t_votes, t_spread, t_anchor,
                     t_diag, task_reads, task_lens, refwins, lengths,
                     fprep=None):
        """ONE fused device dispatch + ONE pull
        (ops/map_fused.fused_map_step); returns the same
        (emit, site_out, dp_score, best, second) contract as the staged
        phase. DP speculation = top dp_top clusters per read by seed
        votes (host-known), maxImperfect-gated on the device."""
        from ..ops.map_fused import NEG, fused_map_step

        cfg = self.cfg
        T = len(t_read)
        prep = fprep if fprep is not None else self._fused_prep(
            B, L, t_read, t_votes, t_spread, t_anchor, t_diag,
            task_reads, task_lens, refwins,
        )
        cls_host = prep["cls_host"]
        (eff, win_task, win_score, second_s, win_used, win_cls, win_pos,
         win_bc, overflow, ops_subs, nst_subs, n_fills) = fused_map_step(*prep["args"])
        self.plane_groups += n_fills
        if overflow:
            # more DP-improved winners than the walk cap, or a class past
            # the plane budget: redo on the staged path
            return None
        (eff, win_task, win_score, second_s, win_used, win_cls, win_pos,
         win_bc) = (x.cpu().numpy() for x in (
             eff, win_task, win_score, second_s, win_used, win_cls, win_pos,
             win_bc))
        ops_subs = [x.cpu().numpy() for x in ops_subs]
        nst_subs = [x.cpu().numpy() for x in nst_subs]
        dp_score = eff[:T].astype(np.int64)
        best: dict[int, tuple] = {}
        second: dict[int, tuple] = {}
        for b in np.flatnonzero(win_task >= 0):
            b = int(b)
            best[b] = (int(win_score[b]), int(win_task[b]))
            if second_s[b] > NEG:
                second[b] = (int(second_s[b]), -1)
        emit: list[tuple[int, int, int, bool]] = []
        for b, (s, i) in best.items():
            if s >= min_score_for(int(lengths[b]), cfg.min_ratio):
                emit.append((b, i, s, True))
        site_out: dict[int, tuple[int, bytes]] = {}
        plain = [e for e in emit if not win_used[e[0]]]
        if plain:
            p_task = np.asarray([e[1] for e in plain])
            rd = task_reads[p_task]
            rf = refwins[p_task, cfg.pad : cfg.pad + L]
            mm = np.where(
                (rd == rf) & (rd < 4), ord("m"),
                np.where((rd >= 4) | (rf >= 4), ord("N"), ord("S")),
            ).astype(np.uint8)
            mbytes = mm.tobytes()
            for j, (b, i, s, _p) in enumerate(plain):
                n = int(lengths[b])
                site_out[i] = (int(t_anchor[i]), mbytes[j * L : j * L + n])
        gapped = [e for e in emit if win_used[e[0]]]
        bycls: dict[int, list] = {}
        for e in gapped:
            bycls.setdefault(int(win_cls[e[0]]), []).append(e)
        for ci, ws in bycls.items():
            sel, srefs, Wc, dps = cls_host[ci]
            bs_list = np.asarray([e[0] for e in ws])
            tk_list = np.asarray([e[1] for e in ws])
            pos = win_pos[bs_list]
            # walk rows are compacted per class in ascending read order;
            # reproduce the device's rank with a cumsum over win_cls
            ranks = np.cumsum(win_cls == ci) - 1
            rows = ranks[bs_list]
            matches = match_strings_np(
                ops_subs[ci][rows],
                nst_subs[ci][rows],
                task_reads[tk_list],
                task_lens[tk_list],
                srefs[pos],
                np.full(len(ws), Wc, np.int32),
                win_bc[bs_list],
            )
            for j, (b, i, s, _p) in enumerate(ws):
                m = matches[j]
                ndiag = sum(m.count(x) for x in (b"m", b"S", b"N", b"D"))
                start_col = int(win_bc[b]) - ndiag
                site_out[i] = (int(dps[pos[j]]) + start_col, m)
        return emit, site_out, dp_score, best, second

    def _finalize_batch(self, B, results, emit, site_out, dp_score, best,
                        second, t_read, t_strand, t_anchor, t_votes,
                        task_reads, lengths, n_clusters):
        """Shared post-scoring tail for the fused and staged phases:
        clearzone ambiguity ladder, secondary-site attach, giant-deletion
        stitch, local clipping, tip penalty (BBMapThread.processRead
        :589-790 order)."""
        cfg = self.cfg
        T = len(t_read)
        paired_run = cfg.in2 is not None
        # per-read site score lists (descending, winner first) feed the
        # ambiguity ladder and the PENALIZE_AMBIG penalties below
        worder = np.lexsort((-dp_score, t_read))
        read_scores: dict[int, list[int]] = {}
        for i2 in worder:
            read_scores.setdefault(int(t_read[i2]), []).append(
                int(dp_score[i2])
            )
        for b, i, s, primary in emit:
            if i not in site_out:
                continue
            fs, m = site_out[i]
            if primary:
                r = results[b]
                r.mapped = True
                r.score = s
                r.strand = int(t_strand[i])
                r.flat_start = fs
                r.match = m
                r.codes = task_reads[i][: int(lengths[b])]
                n = int(lengths[b])
                maxsw = int(max_quality(n))
                sec = second.get(b, (-BIG, -1))[0]
                cz = clearzone_for(r.score, maxsw)
                r.ambig = sec >= r.score - cz
                scores_b = read_scores.get(b, [r.score])
                # The blocks below are the reference's SINGLE-END ladder
                # (BBMapThread.processRead); its paired path
                # (processReadPair :1240-1260) uses a stepwise clearzone
                # with no CLEARZONE3/tip penalties, and pairing happens
                # before any penalty — so paired runs skip them here.
                # many-near-best-sites limit (BBMapThread.java:619-627):
                # the reference marks a read ambiguous when more than
                # lim sites sit within CLEARZONE1e (one edit) of the
                # top, lim tiered by CLEARZONE_LIMIT1e=40 (:49) as
                # 161/81/41 for perfect / near-perfect / other reads.
                # Our kept list is capped at 2*max_sites, so the site
                # total comes from the PRE-cap cluster census
                # (n_clusters) and the kept sites confirm CZ1e
                # saturation — a 16-40-copy repeat no longer flags
                # where the reference maps it.
                if not paired_run and not r.ambig and cz < _CZ1E:
                    lim = (
                        int(4.0 * _CZ_LIMIT1E) if r.score >= maxsw
                        else 2 * _CZ_LIMIT1E
                        if r.score + _CZ1E >= maxsw
                        else _CZ_LIMIT1E
                    ) + 1
                    if (
                        int(n_clusters[b]) > lim
                        and len(scores_b) >= 2 * cfg.max_sites
                        and scores_b[-1] >= r.score - _CZ1E
                    ):
                        r.ambig = True
                # runner-up proximity score penalty (applyClearzone3 with
                # the cz3v2 scaling, BBMapThread.java:752-766); dropping
                # below the alignment-score floor flips to ambiguous
                if cfg.penalize_ambig and not paired_run and not r.ambig:
                    subi = apply_clearzone3(scores_b, r.score, maxsw, n)
                    if subi:
                        r.score -= subi
                        if r.score < min_score_for(n, cfg.min_ratio):
                            r.ambig = True
                if cfg.ambig == "toss" and r.ambig:
                    r.mapped = False
                    r.match = b""
        # secondary sites attach after primaries resolve (skip overlaps
        # of an already-kept site: Tools.removeOverlappingSites analog)
        for b, i, s, primary in emit:
            if primary or i not in site_out or not results[b].mapped:
                continue
            fs, m = site_out[i]
            r = results[b]
            near = abs(fs - r.flat_start) < 10 and int(t_strand[i]) == r.strand
            for fs2, st2, _s2, _m2 in r.sites:
                near |= abs(fs - fs2) < 10 and int(t_strand[i]) == st2
            if not near:
                r.sites.append((fs, int(t_strand[i]), s, m))
        # giant-deletion stitch (GapTools/makeGappedSiteScore role):
        # same-strand cluster pairs farther apart than any DP window can
        # bridge become ONE two-anchor gapped site when that site outscores
        # the best windowed alignment
        bridge = min(cfg.max_indel, cfg.window_extras[-1] - 2 * cfg.pad)
        if cfg.max_indel > bridge and T > 0:
            self._stitch_gapped(
                t_read, t_strand, t_anchor, t_votes, task_reads,
                lengths, bridge, results, best,
            )
        if cfg.local:
            for b in range(B):
                r = results[b]
                if r.mapped and r.match:
                    m2, shift = to_local_match(r.match)
                    if m2 is not r.match:
                        r.match = m2
                        r.flat_start += shift
                        r.score = score_match_bytes(m2)
                        # clip can drop the score below the alignment
                        # floor: unmap unless ambiguity already holds
                        # (BBMapThread.java:781 post-local clearMapping)
                        if not r.ambig and r.score < min_score_for(
                            int(lengths[b]), cfg.min_ratio
                        ):
                            r.mapped = False
                            r.match = b""
        for b in range(B):
            r = results[b]
            if r.mapped:
                # PENALIZE_AMBIG tip penalty (BBMapThread.java:788-790):
                # applied last, after local clipping, feeding MAPQ only;
                # single-end path only (processReadPair has none)
                if (
                    cfg.penalize_ambig
                    and not paired_run
                    and r.match
                    and r.codes is not None
                ):
                    r.score -= tip_score_penalty(
                        r.match, r.codes,
                        int(max_quality(len(r.codes))), r.score,
                    )
                self.reads_mapped += 1
                if self.cfg.mhist or self.cfg.idhist:
                    self._tally_match(r.match)
            else:
                self.reads_unmapped += 1
        return results

    def _stitch_gapped(self, t_read, t_strand, t_anchor, t_votes,
                       task_reads, lengths, bridge, results, best):
        """Two-anchor gapped sites for deletions in (bridge, maxindel].

        The reference spans giant deletions by building a gap-compressed
        reference buffer and running its single DP arena across it
        (align2/GapTools.java, BBIndex makeGappedSiteScore,
        MultiStateAligner gref/GAPC machinery). The TPU design keeps DP
        windows static and instead aligns the read on BOTH anchor
        diagonals at once, then picks the optimal junction split s:
        left of s scores on diagonal A, right of s on diagonal B, plus
        the calc_del_score gap penalty — one vectorized pass, no
        compressed buffer. Deletion length is exact (d2 - d1), emitted
        as a D (or N, intronlen=) run in the match/CIGAR."""
        cfg = self.cfg
        # group tasks by (read, strand); enumerate in-range anchor pairs
        pairs = []  # (votes_sum, i_task, j_task)
        bykey: dict[tuple, list] = {}
        for t in range(len(t_read)):
            bykey.setdefault(
                (int(t_read[t]), int(t_strand[t])), []
            ).append(t)
        for (b, _s), ts in bykey.items():
            n = int(lengths[b])
            # a perfect windowed site cannot be beaten by a gapped one
            bscore = best.get(b, (-(1 << 40), -1))[0]
            if bscore >= int(max_quality(n)) + MC.POINTS_DEL:
                continue
            if len(ts) < 2:
                continue
            ts = sorted(ts, key=lambda t: int(t_anchor[t]))
            cand = None
            for x in range(len(ts) - 1):
                for y in range(x + 1, len(ts)):
                    gap = int(t_anchor[ts[y]]) - int(t_anchor[ts[x]])
                    if gap <= bridge or gap > cfg.max_indel:
                        continue
                    v = int(t_votes[ts[x]]) + int(t_votes[ts[y]])
                    if cand is None or v > cand[0]:
                        cand = (v, ts[x], ts[y])
            if cand is not None:
                pairs.append(cand)
        if not pairs:
            return
        P = len(pairs)
        L = task_reads.shape[1]
        ii = np.asarray([p[1] for p in pairs])
        jj = np.asarray([p[2] for p in pairs])
        d1 = t_anchor[ii].astype(np.int64)
        d2 = t_anchor[jj].astype(np.int64)
        rd = task_reads[ii]  # [P, L]
        refA = self._ref_windows(d1, L)
        refB = self._ref_windows(d2, L)
        ns = lengths[t_read[ii]].astype(np.int64)
        valid = np.arange(L)[None, :] < ns[:, None]
        mA = (rd == refA) & (rd < 4) & valid
        mB = (rd == refB) & (rd < 4) & valid
        # junction split: argmax_s matches(A[:s]) + matches(B[s:])
        cumA = np.cumsum(mA, axis=1)
        cumB = np.cumsum(mB, axis=1)
        zer = np.zeros((P, 1), np.int64)
        pA = np.concatenate([zer, cumA], axis=1)  # matches in [0, s)
        pB = np.concatenate([zer, cumB], axis=1)
        tot = cumB[:, -1][:, None]
        split_score = pA + (tot - pB)  # [P, L+1] over s = 0..L
        svec = np.arange(L + 1)[None, :]
        k = cfg.k
        ok_s = (svec >= k) & (svec <= np.maximum(ns[:, None] - k, k))
        split_score = np.where(ok_s, split_score, -1)
        s_star = np.argmax(split_score, axis=1)
        from ..ops.gaps import MINGAP, fix_gaps

        for p in range(P):
            b = int(t_read[ii[p]])
            n = int(ns[p])
            s = int(s_star[p])
            if split_score[p, s] < 0:
                continue
            gap = int(d2[p] - d1[p])
            # both anchors must sit on one scaffold (no chimeric stitch)
            sc = self.ref.scaffold_of(
                np.asarray([d1[p], d2[p] + n - 1], np.int64)
            )
            if sc[0] != sc[1]:
                continue
            ga = fix_gaps(
                int(d1[p]), int(d2[p]) + n - 1,
                [int(d1[p]), int(d1[p]) + s - 1,
                 int(d2[p]) + s, int(d2[p]) + n - 1],
                MINGAP,
            )
            if ga is None:  # junction degenerate after normalization
                continue
            left = np.where(
                mA[p, :s], ord("m"),
                np.where((rd[p, :s] >= 4) | (refA[p, :s] >= 4),
                         ord("N"), ord("S")),
            ).astype(np.uint8)
            right = np.where(
                mB[p, s:n], ord("m"),
                np.where((rd[p, s:n] >= 4) | (refB[p, s:n] >= 4),
                         ord("N"), ord("S")),
            ).astype(np.uint8)
            match = (left.tobytes() + b"D" * gap + right.tobytes())
            score = score_match_bytes(match)
            r = results[b]
            old = r.score if r.mapped else -(1 << 40)
            if score <= old or score < min_score_for(n, cfg.min_ratio):
                continue
            r.mapped = True
            r.blacklisted = False
            r.score = int(score)
            r.strand = int(t_strand[ii[p]])
            r.flat_start = int(d1[p])
            r.match = match
            r.codes = rd[p, :n]
            cz = clearzone_for(int(score), int(max_quality(n)))
            r.ambig = old >= score - cz

    def _tally_match(self, match: bytes):
        """mhist/idhist accumulation (align2 MHIST/IDHIST roles): read-
        position-resolved op counts and an identity histogram."""
        pos = 0
        n_m = n_s = n_i = n_d = 0
        H = self._mhist.shape[1]
        for ch in match:
            if ch in (109, 115):  # m s
                if pos < H:
                    self._mhist[0, pos] += 1
                pos += 1
                n_m += 1
            elif ch in (83, 86, 78):  # S V N
                if pos < H:
                    self._mhist[1, pos] += 1
                pos += 1
                n_s += 1
            elif ch == 68:  # D
                if pos < H:
                    self._mhist[2, pos] += 1
                n_d += 1
            elif ch in (73, 88, 89, 67):  # I X Y C
                if pos < H:
                    self._mhist[3, pos] += 1
                pos += 1
                n_i += 1
        denom = n_m + n_s + n_i + n_d
        if denom:
            self._idhist[int(round(100 * n_m / denom))] += 1

    def _write_hists(self):
        cfg = self.cfg
        if cfg.mhist:
            tot = self._mhist.sum(axis=0)
            lastp = int(np.max(np.flatnonzero(tot), initial=0))
            with open(cfg.mhist, "wb") as fh:
                fh.write(b"#BaseNum\tMatch\tSub\tDel\tIns\n")
                for p in range(lastp + 1):
                    t = max(int(tot[p]), 1)
                    fh.write(
                        b"%d\t%.5f\t%.5f\t%.5f\t%.5f\n"
                        % (
                            p,
                            self._mhist[0, p] / t,
                            self._mhist[1, p] / t,
                            self._mhist[2, p] / t,
                            self._mhist[3, p] / t,
                        )
                    )
        if cfg.idhist:
            with open(cfg.idhist, "wb") as fh:
                fh.write(b"#Identity\tReads\n")
                for i in range(101):
                    fh.write(b"%d\t%d\n" % (i, self._idhist[i]))

    def _padded_ref(self, W: int):
        """Reference codes padded with >= W bytes of 4 (N) each side, so
        every window that merely overhangs the genome reads its N fill
        without any per-element bounds arithmetic. Grown lazily; the pad
        doubles so repeated growth is amortized."""
        pad = getattr(self, "_pad_n", 0)
        if pad < W:
            pad = max(W, 2 * pad, 4096)
            codes = self.ref.codes
            p = np.full(len(codes) + 2 * pad, 4, np.uint8)
            p[pad : pad + len(codes)] = codes
            self._padded = p
            self._pad_n = pad
        return self._padded, self._pad_n

    def _ref_windows(self, starts: np.ndarray, W: int) -> np.ndarray:
        """[T, W] ref-code windows at flat coords `starts`, OOB filled
        with 4 (N). Row-gather from a sliding view of the padded
        reference: no [T, W] int64 index matrix is ever materialized
        (fresh multi-MB int64 allocations are pathologically slow under
        gVisor first-touch)."""
        padded, pad = self._padded_ref(W)
        sw = np.lib.stride_tricks.sliding_window_view(padded, W)
        s = starts.astype(np.int64) + pad
        s_cl = np.clip(s, 0, len(padded) - W)
        wins = sw[s_cl]  # fancy row index -> fresh writable [T, W] uint8
        bad = s != s_cl  # start so far out even the pad can't cover it
        if bad.any():
            wins[bad] = 4
        return wins

    # ------------------------------------------------------------------
    def _read_batches(self, path: str):
        """Input batches: FASTQ streams directly; FASTA reads longer than
        `fastareadlen` are broken into chunks named name_chunk<off>
        (AbstractMapThread.java:3274 fastareadlen semantics)."""
        from ..io.fileformat import Format, test_input

        cfg = self.cfg
        if test_input(path).format != Format.FASTA:
            yield from FastqReader(path, batch_reads=cfg.batch_reads,
                                   pad_to=None)
            return
        from ..io.batch import ReadBatch
        from ..io.fasta import iter_fasta

        seqs: list[bytes] = []
        ids: list[bytes] = []
        ordinal = 0
        FL = max(cfg.fastareadlen, 32)
        for rec in iter_fasta(path):
            s = rec.seq
            if len(s) <= FL:
                seqs.append(s)
                ids.append(rec.name)
            else:
                for off in range(0, len(s), FL):
                    part = s[off : off + FL]
                    if len(part) < 32:
                        break
                    seqs.append(part)
                    ids.append(rec.name + b"_chunk%d" % off)
            while len(seqs) >= cfg.batch_reads:
                yield ReadBatch.from_sequences(
                    seqs[: cfg.batch_reads], ids=ids[: cfg.batch_reads],
                    ordinal=ordinal,
                )
                seqs = seqs[cfg.batch_reads :]
                ids = ids[cfg.batch_reads :]
                ordinal += 1
        if seqs:
            yield ReadBatch.from_sequences(seqs, ids=ids, ordinal=ordinal)

    def run(self):
        cfg = self.cfg
        t0 = time.time()
        reader = self._read_batches(cfg.in1)
        reader2 = (
            FastqReader(cfg.in2, batch_reads=cfg.batch_reads, pad_to=None)
            if cfg.in2
            else None
        )
        writer = (
            SamWriter(
                cfg.out,
                self.ref.names,
                self.ref.lengths,
                cmdline=b"bbmap " + " ".join(sys.argv[1:]).encode(),
            )
            if cfg.out
            else None
        )
        split = any((cfg.outu1, cfg.outu2, cfg.outm1, cfg.outm2))
        wu1 = open_output(cfg.outu1) if cfg.outu1 else None
        wu2 = open_output(cfg.outu2) if cfg.outu2 else None
        wm1 = open_output(cfg.outm1) if cfg.outm1 else None
        wm2 = open_output(cfg.outm2) if cfg.outm2 else None
        it2 = iter(reader2) if reader2 else None
        wb1 = open_output(cfg.outb1) if cfg.outb1 else None
        # paired runs retain top-N candidate sites per read so the
        # pairing pass can re-select winners (pairSiteScoresFinal role)
        self._keep_sites = it2 is not None
        it2p = (
            iter(self._prefetch_candidates(reader2)) if it2 is not None
            else None
        )
        for batch, cand, prep in self._prefetch_candidates(reader):
            results = self.map_batch(batch, cand, prep)
            batch2 = results2 = None
            if it2p is not None:
                batch2, cand2, prep2 = next(it2p)
                results2 = self.map_batch(batch2, cand2, prep2)
                self.pair_site_scores(batch, results, batch2, results2)
                if cfg.rescue_mates:
                    self.rescue(batch, results, batch2, results2)
                    self.rescue(batch2, results2, batch, results)
            blk = np.zeros(len(results), bool)
            if self._blacklist_scafs is not None:
                blk = self._mark_blacklisted(results)
                if results2 is not None:
                    blk |= self._mark_blacklisted(results2)
                    # a blacklisted mate blacklists the pair (pairs
                    # route together, AbstractMapThread semantics)
                    for i in np.flatnonzero(blk):
                        results[i].blacklisted = True
                        results2[i].blacklisted = True
                if wb1 is not None and blk.any():
                    from ..io.fastq import encode_fastq

                    wb1.write(encode_fastq(batch, blk))
                    if batch2 is not None:
                        wb1.write(encode_fastq(batch2, blk))
            if it2 is not None:
                payload = self.to_sam_paired(batch, results, batch2, results2)
            else:
                payload = self.to_sam(batch, results) if writer else b""
            if split:
                from ..io.fastq import encode_fastq

                mapped = np.array(
                    [bool(r.mapped) for r in results], dtype=bool
                )
                if results2 is not None:
                    mapped |= np.array(
                        [bool(r.mapped) for r in results2], dtype=bool
                    )
                mapped &= ~blk  # blacklisted pairs leave both streams
                if wu1 is not None:
                    wu1.write(encode_fastq(batch, ~mapped & ~blk))
                if wm1 is not None:
                    wm1.write(encode_fastq(batch, mapped))
                if batch2 is not None:
                    if wu2 is not None:
                        wu2.write(encode_fastq(batch2, ~mapped & ~blk))
                    if wm2 is not None:
                        wm2.write(encode_fastq(batch2, mapped))
            if cfg.scafstats:
                self._scafstats_add(batch, results)
                if it2 is not None:
                    self._scafstats_add(batch2, results2)
            if self._want_coverage():
                self._coverage_add(results)
                if results2 is not None:
                    self._coverage_add(results2)
            if writer:
                writer.add_batch(batch.ordinal, payload)
        if writer:
            writer.close()
        if wb1 is not None:
            wb1.close()
        for w in (wu1, wu2, wm1, wm2):
            if w is not None:
                w.close()
        if cfg.mhist or cfg.idhist:
            self._write_hists()
        if cfg.scafstats:
            self._write_scafstats()
        if self._want_coverage():
            self._write_coverage()
        self.elapsed = time.time() - t0
        return self

    def _mark_blacklisted(self, results) -> np.ndarray:
        """Flag primary sites on blacklisted scaffolds; returns mask."""
        blk = np.zeros(len(results), bool)
        starts = [
            max(r.flat_start, 0) for r in results if r.mapped
        ]
        if not starts:
            return blk
        rows = [i for i, r in enumerate(results) if r.mapped]
        scafs = self.ref.scaffold_of(np.asarray(starts, np.int64))
        for i, sc in zip(rows, scafs):
            if int(sc) in self._blacklist_scafs:
                results[i].blacklisted = True
                blk[i] = True
        return blk

    # ---- inline coverage (AbstractMapper.printOutput pileup role) ----
    def _want_coverage(self) -> bool:
        c = self.cfg
        return bool(c.covstats or c.basecov or c.covhist or c.bincov)

    def _cov_init(self):
        # the Reference flat space may carry separators between
        # scaffolds; use its own starts for exact bounds
        starts = np.asarray(self.ref.starts, dtype=np.int64)
        lens = np.asarray(self.ref.lengths, dtype=np.int64)
        self._cov_lo = starts
        self._cov_hi = starts + lens
        self._cov_diff = np.zeros(int(self._cov_hi[-1]) + 1, np.int64)
        self._cov_plus = np.zeros(len(lens), np.int64)
        self._cov_minus = np.zeros(len(lens), np.int64)

    def _coverage_add(self, results):
        """Accumulate coverage intervals as a flat diff array: one +1/-1
        pair per mapped primary site; cumsum at the end materializes
        per-base depth with no per-base work in the batch loop."""
        if getattr(self, "_cov_diff", None) is None:
            self._cov_init()
        starts = []
        spans = []
        strands = []
        for r in results:
            if not r.mapped:
                continue
            m = r.match
            span = (
                m.count(b"m") + m.count(b"S") + m.count(b"N")
                + m.count(b"D")
            )
            starts.append(max(r.flat_start, 0))
            spans.append(span)
            strands.append(r.strand)
        if not starts:
            return
        st = np.asarray(starts, np.int64)
        sp = np.asarray(spans, np.int64)
        scaf = self.ref.scaffold_of(st)
        # clamp to the scaffold: columns outside [0, reflen) soft-clip in
        # the emitted CIGAR (io/sam.match_to_cigar14), so coverage from
        # the mapper's own SAM starts/ends at the scaffold bounds
        end = np.minimum(st + sp, self._cov_hi[scaf])
        st = np.maximum(st, self._cov_lo[scaf])
        end = np.maximum(end, st)
        np.add.at(self._cov_diff, st, 1)
        np.add.at(self._cov_diff, end, -1)
        strands = np.asarray(strands)
        np.add.at(self._cov_plus, scaf[strands == 0], 1)
        np.add.at(self._cov_minus, scaf[strands == 1], 1)

    def _write_coverage(self):
        from .pileup import (
            write_basecov,
            write_bincov,
            write_covhist,
            write_covstats,
        )

        cfg = self.cfg
        if getattr(self, "_cov_diff", None) is None:
            self._cov_init()
        flat = np.cumsum(self._cov_diff[:-1]).astype(np.int32)
        cov = [
            flat[int(self._cov_lo[i]) : int(self._cov_hi[i])]
            for i in range(len(self.ref.lengths))
        ]
        if cfg.covstats:
            write_covstats(
                cfg.covstats, self.ref, cov, self._cov_plus,
                self._cov_minus,
            )
        if cfg.basecov:
            write_basecov(cfg.basecov, self.ref, cov)
        if cfg.covhist:
            write_covhist(cfg.covhist, cov)
        if cfg.bincov:
            write_bincov(cfg.bincov, self.ref, cov, cfg.binsize)

    def _scafstats_add(self, batch, results):
        """Per-scaffold hit accumulation (scafstats= flag; the
        align2/BBSplitter scafstats table: unambiguous vs ambiguous
        reads and bases per scaffold)."""
        if self._scaf_counts is None:
            self._scaf_counts = np.zeros(
                (len(self.ref.names), 4), dtype=np.int64
            )
        for i in range(batch.n):
            r = results[i]
            if not r.mapped:
                continue
            scaf = int(
                self.ref.scaffold_of(np.array([max(r.flat_start, 0)]))[0]
            )
            col = 1 if r.ambig else 0
            self._scaf_counts[scaf, col] += 1
            self._scaf_counts[scaf, 2 + col] += int(batch.lengths[i])

    def _write_scafstats(self):
        counts = (
            self._scaf_counts
            if self._scaf_counts is not None
            else np.zeros((len(self.ref.names), 4), dtype=np.int64)
        )
        total = max(self.reads_in, 1)
        order = np.argsort(-(counts[:, 0] + counts[:, 1]), kind="stable")
        with open(self.cfg.scafstats, "wb") as fh:
            fh.write(
                b"#name\t%unambiguousReads\tunambiguousMB\t"
                b"%ambiguousReads\tambiguousMB\tunambiguousReads\t"
                b"ambiguousReads\n"
            )
            for s in order:
                ru, ra_, bu, ba_ = (int(x) for x in counts[s])
                if ru == 0 and ra_ == 0:
                    continue
                fh.write(
                    b"%s\t%.5f\t%.5f\t%.5f\t%.5f\t%d\t%d\n"
                    % (
                        self.ref.names[s].split()[0],
                        100.0 * ru / total, bu / 1e6,
                        100.0 * ra_ / total, ba_ / 1e6, ru, ra_,
                    )
                )

    def pair_site_scores(self, ba, rs1, bb, rs2):
        """Paired site re-selection (AbstractMapThread
        pairSiteScoresFinal, align2/AbstractMapThread.java:2284-2460):
        every (site1, site2) combination on one scaffold with sane
        orientation and inner distance <= MAX_PAIR_DIST earns a paired
        score — score1 + 1 + max(1, score2*mult - deviation penalty) —
        and the combination with the best total becomes the primary
        pair. Repeats resolve consistently: a mate anchored uniquely
        pulls its partner to the copy that forms a proper pair."""
        MAX_PAIR_DIST = 32000  # AbstractMapThread.java:3547
        AVG_PAIR_DIST = 100  # INITIAL_AVERAGE_PAIR_DIST (:3499)
        for b in range(len(rs1)):
            r1, r2 = rs1[b], rs2[b]
            if not (r1.mapped and r2.mapped):
                continue
            cands1 = [(r1.flat_start, r1.strand, r1.score, r1.match)]
            cands1 += r1.sites
            cands2 = [(r2.flat_start, r2.strand, r2.score, r2.match)]
            cands2 += r2.sites
            if len(cands1) == 1 and len(cands2) == 1:
                continue
            l1 = int(ba.lengths[b])
            l2 = int(bb.lengths[b])
            mult1 = min(0.5, max(0.25, l1 / (4.0 * l2)))
            mult2 = min(0.5, max(0.25, l2 / (4.0 * l1)))
            outer_limit = max(l1, l2) * 14 // 32  # OUTER_DIST_MULT/DIV
            efl = AVG_PAIR_DIST + l1 + l2  # expectedFragLength
            best = None  # (total, i1, i2, p1, p2)
            second = -(1 << 40)  # runner-up combo total (ambiguity)
            for i1, (fs1, st1, s1, m1) in enumerate(cands1):
                stop1 = fs1 + _reflen(m1)
                for i2, (fs2, st2, s2, m2) in enumerate(cands2):
                    if st1 == st2:  # FR orientation only
                        continue
                    stop2 = fs2 + _reflen(m2)
                    outer = max(stop1, stop2) - min(fs1, fs2)
                    inner = (fs2 - stop1) if fs2 >= stop1 else (fs1 - stop2)
                    if outer < outer_limit or inner > MAX_PAIR_DIST:
                        continue
                    sc1 = self.ref.scaffold_of(
                        np.asarray([max(fs1, 0), max(fs2, 0)], np.int64)
                    )
                    if sc1[0] != sc1[1]:
                        continue
                    dev = abs(AVG_PAIR_DIST - inner)
                    p1 = s1 + 1 + max(
                        1, int(s2 * mult1) - dev * s2 // max(
                            100, 10 * efl + 100)
                    )
                    p2 = s2 + 1 + max(
                        1, int(s1 * mult2) - dev * s1 // max(
                            100, 10 * efl + 100)
                    )
                    if best is None or p1 + p2 > best[0]:
                        if best is not None:
                            second = max(second, best[0])
                        best = (p1 + p2, i1, i2, p1, p2)
                    else:
                        second = max(second, p1 + p2)
            if best is None:
                continue
            total, i1, i2, p1, p2 = best
            for r, cands, idx, ps in ((r1, cands1, i1, p1),
                                      (r2, cands2, i2, p2)):
                fs, st, s, m = cands[idx]
                if idx != 0:
                    # the primary moves to the paired-consistent site;
                    # the old primary drops into the secondary list
                    r.sites = [c for ci, c in enumerate(cands[1:])
                               if ci + 1 != idx]
                    r.sites.insert(0, cands[0])
                    r.flat_start, r.strand, r.match = fs, st, m
                if ps > r.score:
                    r.score = ps  # setScore(pairedScore)
                # a decisively best combo resolves repeat ambiguity; a
                # runner-up combo inside the clearzone keeps it
                cz = clearzone_for(int(r.score),
                                   int(max_quality(len(r.match))))
                r.ambig = second >= total - cz

    def rescue(self, ba, ra, bb, rb):
        """Mate rescue (AbstractMapThread.rescue): when read A mapped and
        its mate B did not, slide mate-rc ungapped across the expected
        insert window next to A and accept the best offset above the
        rescue threshold. One batched score_no_indels call covers every
        (candidate, offset) pair."""
        cfg = self.cfg
        cands = [
            i
            for i in range(ba.n)
            if ra[i].mapped and not rb[i].mapped
            and int(bb.lengths[i]) >= 20
        ]
        if not cands:
            return
        G = len(self.ref.codes)
        Lb = bb.bases.shape[1]
        wlen = cfg.rescue_dist + Lb
        # one [C, NOFF] lane block scores every (candidate, offset) pair
        # in a single fused scan — no per-offset task duplication
        NOFF = max(1, wlen - 20)
        ci = np.asarray(cands)
        ln = bb.lengths[ci].astype(np.int64)
        a_strand = np.array([ra[i].strand for i in cands], np.int64)
        a_start = np.array([ra[i].flat_start for i in cands], np.int64)
        a_len = ba.lengths[ci].astype(np.int64)
        w0s = np.where(a_strand == 0, a_start, a_start + a_len - wlen)
        w0s = np.clip(w0s, 0, G - 1)
        # window width covers every slid read position; columns past wlen
        # are never read at a valid offset (o < wlen - ln, i < ln)
        wins = self._ref_windows(w0s, NOFF + Lb - 1)
        # mate orientation is opposite the anchor's
        rows = bb.bases[ci]  # [C, Lb]
        pos = np.arange(Lb, dtype=np.int64)[None, :]
        rc_src = np.clip(ln[:, None] - 1 - pos, 0, Lb - 1)
        rc_vals = rows[np.arange(len(ci))[:, None], rc_src]
        rc_rows = np.where(rc_vals < 4, 3 - rc_vals.astype(np.int16), 4)
        mrows = np.where((a_strand == 0)[:, None], rc_rows, rows).astype(
            np.uint8
        )
        mrows[pos >= ln[:, None]] = 4
        scores = score_no_indels_offsets(
            Lb,
            NOFF,
            self._dev(mrows),
            self._dev(ln.astype(np.int32)),
            self._dev(wins),
        ).cpu().numpy().astype(np.int64)
        # offsets the sequential loop never evaluated stay out of the argmax
        n_off = np.maximum(1, wlen - ln)
        scores[np.arange(NOFF)[None, :] >= n_off[:, None]] = -BIG
        best_o = np.argmax(scores, axis=1)
        best_sc = scores[np.arange(len(ci)), best_o]
        best = {
            int(ci[j]): (int(best_sc[j]), int(w0s[j]), int(best_o[j]))
            for j in range(len(ci))
        }
        for i, (sc, w0, o) in best.items():
            ln_b = int(bb.lengths[i])
            # rescue threshold: half the normal ratio floor (the reference
            # accepts rescued sites below minRatio but above a floor)
            if sc < min_score_for(ln_b, cfg.min_ratio * 0.7):
                continue
            row = bb.bases[i, :ln_b]
            mate = (
                np.where(row < 4, 3 - row, 4)[::-1]
                if ra[i].strand == 0
                else row
            )
            refseg = self.ref.codes[w0 + o : w0 + o + ln_b]
            if len(refseg) < ln_b:
                continue
            eq = mate == refseg
            m = np.where(
                (mate >= 4) | (refseg >= 4),
                ord("N"),
                np.where(eq, ord("m"), ord("S")),
            ).astype(np.uint8).tobytes()
            r = rb[i]
            r.mapped = True
            r.flat_start = w0 + o
            r.strand = 1 - ra[i].strand
            r.score = sc
            r.match = bytes(m)
            r.ambig = False
            self.reads_mapped += 1
            self.reads_unmapped -= 1
            self.rescued += 1

    def to_sam_paired(self, b1, r1s, b2, r2s) -> bytes:
        """Emit pair records with mate fields (SamLine pairing semantics:
        flags 0x1/0x2/0x20/0x40/0x80, RNEXT/PNEXT/TLEN; proper pair =
        same scaffold, opposite strands, |TLEN| <= pairlen limit)."""
        out = []
        ref = self.ref
        for b in range(len(r1s)):
            if r1s[b].blacklisted or r2s[b].blacklisted:
                continue  # removeBlacklisted: no SAM records for the pair
            recs = []
            for pairnum, (batch, r, mate) in enumerate(
                ((b1, r1s[b], r2s[b]), (b2, r2s[b], r1s[b]))
            ):
                n = int(batch.lengths[b])
                name = batch.ids[b].split()[0]
                flag = FPAIRED | (FFIRST if pairnum == 0 else FSECOND)
                scaf = rstart0 = -1
                cigar = "*"
                mapq = 0
                tags = []
                if r.mapped:
                    scaf = int(ref.scaffold_of(np.array([max(r.flat_start, 0)]))[0])
                    scaf_start = int(ref.starts[scaf])
                    rstart0 = r.flat_start - scaf_start
                    cigar = match_to_cigar14(r.match, rstart0, int(ref.lengths[scaf]))
                    if self.cfg.intronlen < (1 << 30):
                        cigar = dels_to_introns(cigar, self.cfg.intronlen)
                    if self.cfg.sam_version.startswith("1.3"):
                        from ..io.sam import cigar14_to_13

                        cigar = cigar14_to_13(cigar)
                    mapq = to_mapq(r.score, n, True, r.ambig)
                    if r.strand:
                        flag |= FREVERSE
                    tags = [b"AS:i:%d" % r.score, b"NM:i:%d" % _nm(r.match)]
                else:
                    flag |= FUNMAPPED
                mate_scaf = -1
                if mate.mapped:
                    mate_scaf = int(
                        ref.scaffold_of(np.array([max(mate.flat_start, 0)]))[0]
                    )
                    if mate.strand:
                        flag |= 0x20  # mate reverse
                else:
                    flag |= 0x8  # mate unmapped
                tlen = 0
                rnext = b"*"
                pnext = 0
                if r.mapped and mate.mapped and mate_scaf == scaf:
                    rnext = b"="
                    mate_start0 = mate.flat_start - int(ref.starts[scaf])
                    pnext = max(mate_start0, 0) + 1
                    left = min(rstart0, mate_start0)
                    right = max(
                        rstart0 + _reflen(r.match), mate_start0 + _reflen(mate.match)
                    )
                    tlen = right - left
                    if rstart0 > mate_start0 or (
                        rstart0 == mate_start0 and pairnum == 1
                    ):
                        tlen = -tlen
                    # proper pair: opposite strands, sane insert
                    if r.strand != mate.strand and abs(tlen) < 32000:
                        flag |= 0x2
                elif mate.mapped:
                    rnext = ref.names[mate_scaf].split()[0]
                    pnext = max(mate.flat_start - int(ref.starts[mate_scaf]), 0) + 1
                seq = batch.sequence(b)
                qual = batch.quality_string(b) or b"*"
                if r.mapped and r.strand:
                    from ..core.dna import reverse_complement

                    seq = reverse_complement(seq)
                    qual = qual[::-1]
                recs.append(
                    SamRecord(
                        qname=name,
                        flag=flag,
                        rname=ref.names[scaf].split()[0] if r.mapped else b"*",
                        pos=(max(rstart0, 0) + 1) if r.mapped else 0,
                        mapq=mapq,
                        cigar=cigar,
                        rnext=rnext,
                        pnext=pnext,
                        tlen=tlen,
                        seq=seq,
                        qual=qual,
                        tags=tags,
                    ).to_bytes()
                )
            out.extend(recs)
        return b"".join(out)

    def to_sam(self, batch, results) -> bytes:
        out = []
        ref = self.ref
        for b, r in enumerate(results):
            if r.blacklisted:
                continue  # removeBlacklisted: no SAM record at all
            n = int(batch.lengths[b])
            name = batch.ids[b].split()[0]
            if not r.mapped:
                out.append(
                    SamRecord(
                        qname=name,
                        flag=FUNMAPPED,
                        rname=b"*",
                        pos=0,
                        mapq=0,
                        cigar="*",
                        seq=batch.sequence(b),
                        qual=batch.quality_string(b) or b"*",
                    ).to_bytes()
                )
                continue
            scaf = int(ref.scaffold_of(np.array([max(r.flat_start, 0)]))[0])
            scaf_start = int(ref.starts[scaf])
            scaf_len = int(ref.lengths[scaf])
            rstart0 = r.flat_start - scaf_start
            cigar = match_to_cigar14(r.match, rstart0, scaf_len)
            if self.cfg.intronlen < (1 << 30):
                cigar = dels_to_introns(cigar, self.cfg.intronlen)
            if self.cfg.sam_version.startswith("1.3"):
                from ..io.sam import cigar14_to_13

                cigar = cigar14_to_13(cigar)
            mapq = to_mapq(r.score, n, True, r.ambig)
            flag = FREVERSE if r.strand else 0
            seq = batch.sequence(b)
            qual = batch.quality_string(b) or b"*"
            if r.strand:
                from ..core.dna import reverse_complement

                seq = reverse_complement(seq)
                qual = qual[::-1]
            out.append(
                SamRecord(
                    qname=name,
                    flag=flag,
                    rname=ref.names[scaf].split()[0],
                    pos=max(rstart0, 0) + 1,
                    mapq=mapq,
                    cigar=cigar,
                    seq=seq,
                    qual=qual,
                    tags=[b"AS:i:%d" % r.score, b"NM:i:%d" % _nm(r.match)],
                ).to_bytes()
            )
            # secondary alignments (flag 0x100, seq/qual omitted per SAM
            # convention; AbstractMapThread.java:264 secondary-site print)
            for fs, st, sc, m in (
                r.sites if (self.cfg.secondary or self.cfg.ambig == "all")
                else ()
            ):
                sscaf = int(ref.scaffold_of(np.array([max(fs, 0)]))[0])
                sstart0 = fs - int(ref.starts[sscaf])
                out.append(
                    SamRecord(
                        qname=name,
                        flag=0x100 | (FREVERSE if st else 0),
                        rname=ref.names[sscaf].split()[0],
                        pos=max(sstart0, 0) + 1,
                        mapq=min(mapq, 3),
                        cigar=match_to_cigar14(
                            m, sstart0, int(ref.lengths[sscaf])
                        ),
                        seq=b"*",
                        qual=b"*",
                        tags=[b"AS:i:%d" % sc, b"NM:i:%d" % _nm(m)],
                    ).to_bytes()
                )
        return b"".join(out)

    def print_stats(self, stream=None):
        if stream is None:
            stream = sys.stderr
        if self.rescued:
            print(f"rescued mates:       \t{self.rescued}", file=stream)
        t = getattr(self, "elapsed", 0) or 1e-9
        print(f"Reads Used:          \t{self.reads_in}", file=stream)
        pct = 100.0 * self.reads_mapped / max(self.reads_in, 1)
        print(f"mapped:              \t{pct:.4f}% \t{self.reads_mapped} reads", file=stream)
        print(
            f"Reads/sec:           \t{self.reads_in / t:.2f}",
            file=stream,
        )


def score_match_bytes(match: bytes) -> int:
    """Score a long-form match string with the MSA point model
    (Read.calcQuality / MultiStateAligner11ts score semantics): match
    streaks POINTS_MATCH then POINTS_MATCH2, sub/ins streaks through
    their tiered arrays, deletion runs through calc_del_score. Used to
    put stitched gapped sites on the same scale as MSA dp_score."""
    import itertools

    score = 0
    for ch, grp in itertools.groupby(match):
        n = sum(1 for _ in grp)
        if ch in (ord("m"), ord("s")):
            score += MC.POINTS_MATCH + (n - 1) * MC.POINTS_MATCH2
        elif ch in (ord("S"), ord("V")):
            score += int(MC.POINTS_SUB_ARRAY_C[min(n, 603)])
        elif ch in (ord("I"), ord("X"), ord("Y")):
            score += int(MC.calc_ins_score(n))
        elif ch == ord("D"):
            score += int(MC.calc_del_score(n))
        elif ch in (ord("N"), ord("B"), ord("R")):
            score += n * MC.POINTS_NOCALL
        elif ch == ord("C"):
            pass  # soft-clipped
    return score


def to_local_match(match: bytes) -> tuple[bytes, int]:
    """Clip a glocal match string to its best-scoring LOCAL window
    (Read.toLocalAlignment / bbmap.sh local=t): per-op streak-aware
    scores, maximum-sum subarray (Kadane), query-consuming ops outside
    the window become soft-clips (C) and boundary deletions vanish.
    Returns (match, ref_start_shift); the original object comes back
    unchanged when nothing clips."""
    n = len(match)
    scores = np.empty(n, np.int64)
    streak = 0
    prev = -1
    for idx in range(n):
        ch = match[idx]
        streak = streak + 1 if ch == prev else 1
        prev = ch
        if ch in (109, 115):  # m s
            scores[idx] = MC.POINTS_MATCH if streak == 1 else MC.POINTS_MATCH2
        elif ch in (83, 86):  # S V
            scores[idx] = MC.POINTS_SUB_ARRAY[min(streak, 603)]
        elif ch in (73, 88, 89):  # I X Y
            scores[idx] = MC.POINTS_INS_ARRAY[min(streak, 603)]
        elif ch == 68:  # D: per-byte increment of the tiered curve
            scores[idx] = int(MC.calc_del_score(streak)) - int(
                MC.calc_del_score(streak - 1)
            )
        else:  # N B R C
            scores[idx] = MC.POINTS_NOCALL
    # Kadane with window tracking
    best = cur = np.int64(-1)
    b0 = b1 = c0 = 0
    for idx in range(n):
        if cur < 0:
            cur = scores[idx]
            c0 = idx
        else:
            cur += scores[idx]
        if cur > best:
            best, b0, b1 = cur, c0, idx
    if best < 0 or (b0 == 0 and b1 == n - 1):
        return match, 0
    QRY = (109, 115, 83, 86, 73, 88, 89, 78, 66)  # query-consuming ops
    REF = (109, 115, 83, 86, 78, 66, 68, 82)  # ref-consuming ops
    pre = match[:b0]
    n_pre_q = sum(1 for ch in pre if ch in QRY)
    pre_ref = sum(1 for ch in pre if ch in REF)
    suf = match[b1 + 1 :]
    n_suf_q = sum(1 for ch in suf if ch in QRY)
    out = b"C" * n_pre_q + match[b0 : b1 + 1] + b"C" * n_suf_q
    # POS convention: leading C consume ref 1:1 in toCigar14, so the
    # start shifts by (ref consumed by the clipped prefix) - (#C)
    return out, pre_ref - n_pre_q


def dels_to_introns(cigar: str, intronlen: int) -> str:
    """D ops at least intronlen long print as N (SamLine's
    INTRON_LIMIT / bbmap.sh intronlen= RNAseq convention)."""
    if "D" not in cigar:
        return cigar
    out = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            if ch == "D" and int(num) >= intronlen:
                ch = "N"
            out.append(num + ch)
            num = ""
    return "".join(out)


def _reflen(match: bytes) -> int:
    return sum(match.count(x) for x in (b"m", b"S", b"N", b"D"))


def _nm(match: bytes) -> int:
    return (
        match.count(b"S") + match.count(b"I") + match.count(b"D")
    )


def min_score_for(length: int, min_ratio: float) -> int:
    return int(max_quality(length) * min_ratio)


# clearzone constants (align2/BBMapThread.java:39-74, scaled by
# POINTS_MATCH2): an alignment is ambiguous when the runner-up is within
# `clearzone` of the winner; the zone widens as the best score drops
# (two-segment linear interpolation CZ1 -> CZ1b -> CZ1c, :590-606).
# values follow Java float32 arithmetic: (int)(ratio_f32 * 100) — e.g.
# 4.6f*100 rounds to 460.0f then truncates to 460, where Python doubles
# give int(459.999...) = 459. Computed with numpy float32 to stay exact.
_CZP = int(np.float32(1.6) * MC.POINTS_MATCH2)  # 160
_CZ1 = int(np.float32(2.0) * MC.POINTS_MATCH2)  # 200
_CZ1B = int(np.float32(2.6) * MC.POINTS_MATCH2)  # 260
_CZ1C = int(np.float32(4.6) * MC.POINTS_MATCH2)  # 460
_CZ1B_FLAT = 12 * MC.POINTS_MATCH2
_CZ1C_FLAT = 26 * MC.POINTS_MATCH2


def clearzone_for(score: int, max_sw: int) -> int:
    # float32 arithmetic throughout, matching the Java expression types
    # (BBMapThread.java:595-603: int*int products stay int, the limit
    # terms and the division are float)
    if score >= max_sw:
        return _CZP
    f32 = np.float32
    blim = f32(max_sw) * f32(0.97) - f32(_CZ1B_FLAT)
    clim = f32(max_sw) * f32(0.92) - f32(_CZ1C_FLAT)
    if score > blim:
        num = f32((max_sw - score) * _CZ1B) + (f32(score) - blim) * f32(_CZ1)
        return int(num / (f32(max_sw) - blim))
    if score > clim:
        num = (blim - f32(score)) * f32(_CZ1C) + (f32(score) - clim) * f32(
            _CZ1B
        )
        return int(num / (blim - clim))
    return _CZ1C


# -- PENALIZE_AMBIG machinery (reference default on) ------------------
# CLEARZONE3 (BBMapThread.java:197) prices runner-up proximity into the
# map score; CLEARZONE1e (AbstractMapThread.java:145) is the "one edit"
# score distance used by the many-near-best-sites ambiguity limit.
_CZ3 = int(8.0 * MC.POINTS_MATCH2)
_CZ1E = 2 * MC.POINTS_MATCH2 - MC.POINTS_MATCH - MC.POINTS_SUB + 1  # 258
_CZ_LIMIT1E = 40  # CLEARZONE_LIMIT1e, BBMapThread.java:49
_CZ3_MULTS = (0.0, 1.0, 0.75, 0.5, 0.25, 0.125, 0.0625)


def _cz3_fraction(score1: int, score2: int, cz3: int, inv_cz3: float) -> float:
    """AbstractMapThread.calcCZ3_fraction: 0 when the runner-up is a full
    clearzone below the winner, rising superlinearly to 5 at a tie."""
    dif = score1 - score2
    if dif >= cz3:
        return 0.0
    dif2 = cz3 - dif
    f = dif2 * inv_cz3
    f2 = f * f
    return f + 2.0 * f2 + 2.0 * f2 * f


def apply_clearzone3(scores_desc, map_score: int, max_sw: int,
                     read_len: int) -> int:
    """Score penalty for unambiguous-but-contested alignments
    (AbstractMapThread.applyClearzone3 :2159 with the cz3v2 scaling of
    BBMapThread.java:755-756). Returns the points to subtract from the
    map score (0 = no change). `scores_desc` is the site score list in
    descending order, winner first."""
    if len(scores_desc) < 2 or map_score <= 0:
        return 0
    cz3v2 = _CZ3 * min(1.25, max_sw / map_score)
    cz3i = int(cz3v2)
    inv = 1.0 / cz3v2
    score1 = scores_desc[0]
    sub = 0.0
    for i in range(1, min(len(_CZ3_MULTS), len(scores_desc))):
        s2 = int(scores_desc[i])
        if i > 2 and s2 < int(scores_desc[i - 1]):
            break
        f = _cz3_fraction(score1, s2, cz3i, inv)
        if f <= 0:
            break
        sub += f * _CZ3_MULTS[i]
    if sub <= 0:
        return 0
    asymptote = 4.0 + 0.03 * read_len
    sub *= 1.8
    sub2 = cz3i * ((asymptote * sub) / (sub + asymptote))
    subi = int(sub2 + 0.5)
    if subi >= map_score - 300:
        subi = map_score - 300
    return subi if subi > 0 else 0


def tip_score_penalty(match: bytes, codes, max_score: int,
                      map_score: int, tiplen: int = 7) -> int:
    """Alignment-tip quality penalty (AbstractMapThread.
    calcTipScorePenalty :2895): errors within `tiplen` bases of either
    read end, weighted by proximity to the tip, plus homopolymer-tip
    points; squashed through an asymptote and capped so the score stays
    above maxScore/10. `codes` are the 0-4 base codes of the aligned
    read orientation (the homopolymer term is tip-symmetric, so
    orientation does not change the total)."""
    n = len(codes)
    if not match or n < 2 * tiplen:
        return 0
    points = 0
    mlen = len(match)
    for direction in (1, -1):
        prev = ord("m")
        cpos = 0
        i = 0 if direction == 1 else mlen - 1
        while cpos <= tiplen and 0 <= i < mlen:
            b = match[i]
            if b == ord("m"):
                cpos += 1
            elif b == ord("D"):
                if prev != ord("D"):
                    points += 2 * (tiplen + 2 - cpos)
            elif b in (ord("N"), ord("C"), ord("R")):
                points += tiplen + 2 - cpos
                cpos += 1
            else:  # I / S / X / Y
                points += 2 * (tiplen + 2 - cpos)
                cpos += 1
            prev = b
            i += direction
    b0 = codes[0]
    if b0 < 4 and b0 == codes[1]:
        i = 2
        while i <= tiplen and codes[i] == b0:
            points += 1
            i += 1
    bl = codes[n - 1]
    if bl < 4 and bl == codes[n - 2]:
        i = n - 3
        while i >= n - 1 - tiplen and codes[i] == bl:
            points += 1
            i -= 1
    if points < 1:
        return 0
    asymptote = 80.0
    f = (asymptote * points) / (points + asymptote)
    penalty = int(f * 0.0022 * max_score)
    max_penalty = map_score - max_score // 10
    if max_penalty <= 0:
        return 0
    return min(penalty, max_penalty)


def load_ref(path: str):
    from ..io.fasta import load_reference as _lr

    return _lr(path)


def main(argv=None, preset: str | None = None):
    cfg = parse_args(argv if argv is not None else sys.argv[1:], preset)
    tool = BBMap(cfg)
    tool.run()
    tool.print_stats()
    return tool


if __name__ == "__main__":
    main()
