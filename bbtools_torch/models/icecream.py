"""IceCreamFinder — detect PacBio missing-adapter (inverted-repeat)
artifacts ("ice cream cones" / triangle reads).

Reference: icecream/IceCreamFinder.java (icecreamfinder.sh) +
IceCreamAlignerJava/JNI — one of the four JNI kernel families (SURVEY.md
§2.4). Detection (processReadPair/checkRead :1280-1380): take the first
(and last) qlen bases — qlen = clamp(minQlen=100, len*0.15,
targetQlen=352) — reverse-complement them, and align against the rest of
the read. A hit above minRatio1=0.59 (refined pass minRatio2=0.64) means
the read straddles a missed adapter: the second pass realigns with a
query sized to the putative junction (:1315-1329), junction =
maxRpos/2 for a left-tip hit (:1300-1306). Reads whose junction sits
mid-read (junctionFraction >= 0.4) are flagged ice cream; outputs split
good/bad, or trim at the junction (`trim=t`).

The alignment engine here is the glocal identity aligner
(ops/idalign.py), which plays the IceCreamAligner role: query global,
free location in the remainder of the read.

The PyTorch port of bbtools_tpu/models/icecream.py. On the run's device
(`device=`, cuda by default) a read batch's tip alignments run in one
`glocal_identity` call, and the junction refinements of its hits in one
`glocal_counts` call, whose matches over columns is the host aligner's
float64 identity (the JAX package refines each hit on the host with
`glocal_align_np`, one Python step a DP cell: seconds a read at PacBio
lengths). That per-read host path, `check_read`, and reformatpb are the
JAX package's host code.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..core.parser import tokenize
from ..io.fastq import FastqReader, FastqWriter
from ..ops.idalign import glocal_align_np

TARGET_QLEN = 352
MIN_QLEN = 100
MAX_QLEN_FRACTION = 0.15
MIN_RATIO1 = 0.59
MIN_RATIO2 = 0.64
MIN_JUNCTION_FRACTION = 0.4


@dataclass
class ICConfig:
    in1: str = ""
    outg: str | None = None  # good
    outb: str | None = None  # ice cream
    trim: bool = False
    min_ratio1: float = MIN_RATIO1
    min_ratio2: float = MIN_RATIO2
    #: keep all subreads of a ZMW together (ZMWStreamer role,
    #: icecream/ZMW.java): one flagged subread sends the whole ZMW to
    #: outb — a missed adapter corrupts the molecule, not one subread
    kzt: bool = False
    device: str = "cuda"


def parse_args(argv) -> ICConfig:
    a = tokenize(argv)
    c = ICConfig()
    c.in1 = a.get("in", "in1", default="")
    c.outg = a.get("outg", "outgood", "out")
    c.outb = a.get("outb", "outbad")
    c.trim = a.get_bool("trim", "trimreads", default=False)
    c.min_ratio1 = a.get_float("minratio1", "ratio1", default=MIN_RATIO1)
    c.min_ratio2 = a.get_float("minratio2", "ratio2", default=MIN_RATIO2)
    c.kzt = a.get_bool("kzt", "keepzmwstogether", default=False)
    c.device = a.get("device", default="cuda")
    return c


def zmw_of(name: bytes) -> bytes:
    """PacBio subread header movie/zmw/start_end -> movie/zmw key;
    reads without the PacBio shape get a unique key (their own name)."""
    parts = name.split()[0].split(b"/")
    if len(parts) >= 3:
        return parts[0] + b"/" + parts[1]
    return name


def _rc(codes: np.ndarray) -> np.ndarray:
    return np.where(codes < 4, 3 - codes, 4)[::-1].copy()


def check_batch(codes_list: list[np.ndarray], cfg: ICConfig):
    """Batched check on cfg.device: the pass-1 tip-vs-remainder
    alignments of the whole batch in ONE glocal_identity call, the
    junction refinements of its hits in one glocal_counts call. Verdicts
    are identical to the per-read host check_read's."""
    from ..ops.idalign import glocal_counts, glocal_identity

    tasks = []  # (read index, side) aligned with kernel rows
    qs, rs, qls, rls = [], [], [], []
    meta = {}
    for i, codes in enumerate(codes_list):
        n = len(codes)
        qlen = int(max(MIN_QLEN, min(TARGET_QLEN, n * MAX_QLEN_FRACTION)))
        if qlen > 0.45 * n:
            continue
        meta[i] = qlen
        for q, r in (
            (_rc(codes[:qlen]), codes[qlen:]),
            (_rc(codes[-qlen:]), codes[:-qlen]),
        ):
            tasks.append(i)
            qs.append(q)
            rs.append(r)
            qls.append(len(q))
            rls.append(len(r))
    results = {i: (False, -1) for i in range(len(codes_list))}
    if not tasks:
        return [results[i] for i in range(len(codes_list))]
    ident, rstart, rstop = (
        x.cpu().numpy()
        for x in glocal_identity(*_pad_tasks(qs, rs), cfg.device)
    )
    hits = {}
    for t in range(0, len(tasks), 2):
        i = tasks[t]
        hits[i] = _tip_hit(
            codes_list[i], meta[i], cfg,
            float(ident[t]), int(rstart[t]), int(rstop[t]),
            float(ident[t + 1]), int(rstart[t + 1]), int(rstop[t + 1]),
        )
    refine = [i for i, h in hits.items() if h is not None and h[2] >= meta[i]]
    if refine:
        pairs = [_refine_pair(codes_list[i], *hits[i][1:]) for i in refine]
        matches, cols, rs2, re2 = (
            x.cpu().numpy()
            for x in glocal_counts(*_pad_tasks(*zip(*pairs)), cfg.device)
        )
    slot = {i: k for k, i in enumerate(refine)}
    for i, h in hits.items():
        if h is None:
            continue
        if i in slot:
            k = slot[i]
            results[i] = _refined_verdict(
                len(codes_list[i]), cfg, *h,
                int(matches[k]) / int(cols[k]), int(rs2[k]), int(re2[k]),
            )
        else:
            results[i] = _verdict(len(codes_list[i]), h[0], h[1])
    return [results[i] for i in range(len(codes_list))]


def check_read(codes: np.ndarray, cfg: ICConfig):
    """Returns (is_icecream, junction) — junction in read coords or -1."""
    n = len(codes)
    qlen = int(max(MIN_QLEN, min(TARGET_QLEN, n * MAX_QLEN_FRACTION)))
    if qlen > 0.45 * n:
        return False, -1
    # left tip vs remainder
    ident_l, rs_l, re_l = glocal_align_np(_rc(codes[:qlen]), codes[qlen:])
    # right tip vs remainder
    ident_r, rs_r, re_r = glocal_align_np(_rc(codes[-qlen:]), codes[:-qlen])
    return _finish_read(
        codes, qlen, cfg, ident_l, rs_l, re_l, ident_r, rs_r, re_r
    )


def _finish_read(codes, qlen, cfg, ident_l, rs_l, re_l, ident_r, rs_r, re_r):
    n = len(codes)
    left = ident_l >= ident_r
    ident = max(ident_l, ident_r)
    if ident < cfg.min_ratio1:
        return False, -1
    if left:
        max_rpos = qlen + re_l  # end of the IR copy, whole-read coords
        junction = max_rpos // 2
    else:
        inner_left = rs_r
        inner_right = n - qlen
        junction = (inner_left + inner_right) // 2
    # refinement pass with a junction-sized query (:1315-1329)
    expected = n // 2
    if junction < expected:
        q2 = int(junction * 0.9)
        if q2 >= qlen:
            ident2, _, re2 = glocal_align_np(_rc(codes[:q2]), codes[q2:])
            if ident2 < cfg.min_ratio2:
                return False, -1
            junction = (q2 + re2) // 2
    else:
        q2 = int((n - junction) * 0.9)
        if q2 >= qlen:
            ident2, rs2, _ = glocal_align_np(_rc(codes[-q2:]), codes[:-q2])
            if ident2 < cfg.min_ratio2:
                return False, -1
            junction = (rs2 + (n - q2)) // 2
    frac = (
        junction / n if left else (n - junction) / n
    )
    return frac >= MIN_JUNCTION_FRACTION, junction


def _pad_tasks(qs, rs):
    """Code arrays -> (qs [T, Mx], qlens, rs [T, Nx], rlens), padded
    with 4 (N)."""
    qls = np.array([len(q) for q in qs], np.int32)
    rls = np.array([len(r) for r in rs], np.int32)
    qa = np.full((len(qs), int(qls.max())), 4, np.uint8)
    ra = np.full((len(rs), int(rls.max())), 4, np.uint8)
    for t, (q, r) in enumerate(zip(qs, rs)):
        qa[t, : len(q)] = q
        ra[t, : len(r)] = r
    return qa, qls, ra, rls


def _tip_hit(codes, qlen, cfg, ident_l, rs_l, re_l, ident_r, rs_r, re_r):
    """Pass 1 (:1280-1306): None when neither tip reaches min_ratio1;
    else (left, junction, q2), q2 the query length of the refinement
    pass, which runs when q2 >= qlen."""
    n = len(codes)
    left = ident_l >= ident_r
    ident = max(ident_l, ident_r)
    if ident < cfg.min_ratio1:
        return None
    if left:
        max_rpos = qlen + re_l  # end of the IR copy, whole-read coords
        junction = max_rpos // 2
    else:
        inner_left = rs_r
        inner_right = n - qlen
        junction = (inner_left + inner_right) // 2
    # refinement pass with a junction-sized query (:1315-1329)
    if junction < n // 2:
        q2 = int(junction * 0.9)
    else:
        q2 = int((n - junction) * 0.9)
    return left, junction, q2


def _refine_pair(codes, junction, q2):
    """The refinement's (query, reference): the tip of q2 bases on the
    junction's side, reverse-complemented, against the rest."""
    if junction < len(codes) // 2:
        return _rc(codes[:q2]), codes[q2:]
    return _rc(codes[-q2:]), codes[:-q2]


def _refined_verdict(n, cfg, left, junction, q2, ident2, rs2, re2):
    if ident2 < cfg.min_ratio2:
        return False, -1
    if junction < n // 2:
        junction = (q2 + re2) // 2
    else:
        junction = (rs2 + (n - q2)) // 2
    return _verdict(n, left, junction)


def _verdict(n, left, junction):
    frac = (
        junction / n if left else (n - junction) / n
    )
    return frac >= MIN_JUNCTION_FRACTION, junction


class IceCreamFinder:
    def __init__(self, cfg: ICConfig):
        from ..device import resolve_device

        cfg.device = resolve_device(str(cfg.device))
        self.cfg = cfg
        self.flagged = 0
        self.kept = 0
        self.trimmed_bases = 0

    def run(self):
        cfg = self.cfg
        wg = FastqWriter(cfg.outg) if cfg.outg else None
        wb = FastqWriter(cfg.outb) if cfg.outb else None
        bad_zmws: set[bytes] = set()
        if cfg.kzt:
            # pass 1 (ZMWStreamer role): find ZMWs with any flagged
            # subread; untrimmed flagged reads poison their whole ZMW
            for b in FastqReader(cfg.in1):
                codes_list = [
                    b.bases[i, : int(b.lengths[i])] for i in range(b.n)
                ]
                for i, (ic, junction) in enumerate(
                    check_batch(codes_list, cfg)
                ):
                    if ic and not (cfg.trim and junction > 0):
                        bad_zmws.add(zmw_of(b.ids[i]))
            self.zmws_flagged = len(bad_zmws)
        for b in FastqReader(cfg.in1):
            bad = np.zeros(b.n, dtype=bool)
            codes_list = [
                b.bases[i, : int(b.lengths[i])] for i in range(b.n)
            ]
            verdicts = check_batch(codes_list, cfg)
            for i in range(b.n):
                L = int(b.lengths[i])
                ic, junction = verdicts[i]
                if ic:
                    bad[i] = True
                    self.flagged += 1
                    if cfg.trim and junction > 0:
                        self.trimmed_bases += L - junction
                        b.lengths[i] = junction
                        b.bases[i, junction:] = 4
                        bad[i] = False  # trimmed read is kept as good
                else:
                    self.kept += 1
            if bad_zmws:
                for i in range(b.n):
                    if zmw_of(b.ids[i]) in bad_zmws:
                        bad[i] = True
            if wg:
                wg.add(b, ~bad)
            if wb:
                wb.add(b, bad)
        for w in (wg, wb):
            if w:
                w.close()
        print(f"Ice cream flagged:   \t{self.flagged}", file=sys.stderr)
        if cfg.kzt:
            print(
                f"ZMWs discarded:      \t{len(bad_zmws)}", file=sys.stderr
            )
        if cfg.trim:
            print(
                f"Bases trimmed:       \t{self.trimmed_bases}",
                file=sys.stderr,
            )
        return self


def main(argv=None):
    return IceCreamFinder(
        parse_args(argv if argv is not None else sys.argv[1:])
    ).run()


def reformatpb(argv=None):
    """ReformatPacBio (reformatpb.sh, icecream/ReformatPacBio.java) —
    ZMW-aware reformat: minlen filtering, poly-A/T end trimming
    (trimpolya= with minpolymer=/polyerror=), ZMW whitelist/blacklist,
    reads=/zmws= sampling caps, bestpass= (keep the median-length read
    of each ZMW's non-outermost subreads), kzt= whole-ZMW routing, and
    schist= subreads-per-ZMW histogram.
    """
    from ..core.parser import tokenize
    from ..io.fastq import FastqReader, encode_fastq
    from ..io.readwrite import open_output

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "outgood")
    outb = a.get("outb", "outbad")
    minlen = a.get_int("minlen", "minlength", default=40)
    kzt = a.get_bool("kzt", "keepzmwstogether", default=False)
    trimpolya = a.get_bool("trimpolya", default=False)
    minpolymer = a.get_int("minpolymer", default=5)
    max_reads = a.get_int("reads", default=-1)
    max_zmws = a.get_int("zmws", default=-1)
    bestpass = a.get_bool("bestpass", default=False)
    schist = a.get("schist")

    def load_zmw_set(spec):
        if not spec:
            return None
        out = set()
        import os

        for tok in spec.split(","):
            if os.path.exists(tok):
                with open(tok) as fh:
                    out |= {int(l) for l in fh.read().split() if l.strip()}
            elif tok.strip():
                out.add(int(tok))
        return out

    whitelist = load_zmw_set(a.get("whitelist"))
    blacklist = load_zmw_set(a.get("blacklist")) or set()

    def zmw_num(name: bytes) -> int:
        parts = name.split()[0].split(b"/")
        try:
            return int(parts[1])
        except (IndexError, ValueError):
            return -1

    def trim_poly(seq: bytes) -> bytes:
        if not trimpolya:
            return seq
        for base in (b"A", b"T"):
            # trim a terminal homopolymer run >= minpolymer
            n = 0
            while n < len(seq) and seq[len(seq) - 1 - n : len(seq) - n] == base:
                n += 1
            if n >= minpolymer:
                seq = seq[: len(seq) - n]
            n = 0
            while n < len(seq) and seq[n : n + 1] == base:
                n += 1
            if n >= minpolymer:
                seq = seq[n:]
        return seq

    # group records by ZMW (subreads are adjacent in PacBio output)
    zmw_reads: dict[int, list] = {}
    order: list[int] = []
    for b in FastqReader(in1):
        for i in range(b.n):
            name = bytes(b.ids[i])
            z = zmw_num(name)
            if z not in zmw_reads:
                zmw_reads[z] = []
                order.append(z)
            seq = b.record_bytes(i) if hasattr(b, "record_bytes") else None
            m = int(b.lengths[i])
            raw = b.ascii_bases[i, :m].tobytes() if b.ascii_bases is not None \
                else None
            if raw is None:
                from ..core.dna import CODE_TO_BASE

                raw = CODE_TO_BASE[np.minimum(b.bases[i, :m], 4)].tobytes()
            qual = (
                (b.quals[i, :m] + 33).astype(np.uint8).tobytes()
                if b.quals is not None else b"I" * m
            )
            zmw_reads[z].append((name, raw, qual))

    n_good = n_bad = 0
    zmws_out = 0
    schist_counts: dict[int, int] = {}
    wg = open_output(out1) if out1 else None
    wb = open_output(outb) if outb else None
    stop = False
    for z in order:
        if stop:
            break
        recs = zmw_reads[z]
        schist_counts[len(recs)] = schist_counts.get(len(recs), 0) + 1
        zmw_bad = (
            (whitelist is not None and z not in whitelist)
            or z in blacklist
        )
        if bestpass and len(recs) > 2:
            inner = recs[1:-1]
            inner.sort(key=lambda r: len(r[1]))
            recs = [inner[len(inner) // 2]]
        out_recs = []
        for name, seq, qual in recs:
            seq2 = trim_poly(seq)
            qual2 = qual[: len(seq2)]
            bad = zmw_bad or len(seq2) < minlen
            out_recs.append((name, seq2, qual2, bad))
        if kzt and any(bad for _, _, _, bad in out_recs):
            out_recs = [(n_, s, q, True) for n_, s, q, _ in out_recs]
        wrote_any = False
        for name, seq, qual, bad in out_recs:
            target = wb if bad else wg
            if bad:
                n_bad += 1
            else:
                n_good += 1
                wrote_any = True
            if target is not None:
                target.write(
                    b"@" + name + b"\n" + seq + b"\n+\n" + qual + b"\n"
                )
            if 0 < max_reads <= n_good + n_bad:
                stop = True
                break
        if wrote_any:
            zmws_out += 1
            if 0 < max_zmws <= zmws_out:
                stop = True
    for w in (wg, wb):
        if w is not None:
            w.close()
    if schist:
        with open_output(schist) as fh:
            fh.write(b"#Subreads\tZMWs\n")
            for k in sorted(schist_counts):
                fh.write(b"%d\t%d\n" % (k, schist_counts[k]))
    print(
        f"Reads kept:       \t{n_good}", file=sys.stderr,
    )
    print(
        f"Reads discarded:  \t{n_bad}", file=sys.stderr,
    )
    return n_good, n_bad
