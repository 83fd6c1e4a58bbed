"""Sequence/stream utility tools: shuffle, getreads, replaceheaders,
filterbycoverage, randomgenome, makepolymers, tetramerfreq, callpeaks.

References (semantics source, no code reuse):
  - sort/Shuffle.java (shuffle.sh) — reorder reads randomly, keeping
    pairs together (in2/out2 shuffled with the same permutation).
  - driver/GetReads.java (getreads.sh) — select reads by numeric id
    (first read/pair is 0); id= takes numbers and ranges (5,17-31,...).
  - driver/ReplaceHeaders.java (replaceheaders.sh) — replace read names
    with names from hin= (a sequence file, or one name per line).
  - jgi/FilterByCoverage.java (filterbycoverage.sh) — filter an
    assembly by pileup covstats: minc (avg fold), minp (covered %),
    minr (mapped reads), minl (length after trim=), outd= for removed.
  - jgi/RandomGenome.java (randomgenome.sh) — random repeat-free
    genome: len=, chroms=, gc=, seed.
  - jgi/MakePolymers.java (makepolymers.sh) — every repeating polymer
    unit of length k (mink..maxk sweep) tiled to minlen so all kmers of
    length minlen are present.
  - jgi/TetramerFrequencies.java (tetramerfreq.sh) — sliding-window
    canonical tetramer frequency table per window (window=, step=).
  - jgi/CallPeaks.java (callpeaks.sh) — call peaks from a 2-column
    depth histogram; minHeight/minVolume/minWidth/minPeak gates, plus
    genome-size and ploidy estimates from the primary peak.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core.parser import parse_kmg, tokenize
from ..io.fasta import FastaRecord, read_fasta, write_fasta
from ..io.fastq import FastqReader
from ..io.readwrite import open_input, open_output

BASES = b"ACGT"


def _records(path: str):
    for b in FastqReader(path):
        for i in range(b.n):
            yield (b.ids[i], b.sequence(i), b.quality_string(i))


def _write_rec(fh, rec):
    fh.write(b"@%s\n%s\n+\n%s\n" % rec)


def shuffle(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1, in2 = a.get("in", "in1"), a.get("in2")
    out1, out2 = a.get("out", "out1"), a.get("out2")
    rng = np.random.default_rng(a.get_int("seed", default=None))
    r1 = list(_records(in1))
    r2 = list(_records(in2)) if in2 else None
    perm = rng.permutation(len(r1))
    with open_output(out1) as fh1:
        fh2 = open_output(out2) if (r2 and out2) else None
        for j in perm:
            _write_rec(fh1, r1[j])
            if r2 is not None:
                _write_rec(fh2 if fh2 is not None else fh1, r2[j])
        if fh2 is not None:
            fh2.close()
    print(f"Shuffled {len(r1)} reads.", file=sys.stderr)
    return len(r1)


def _parse_id_spec(spec: str) -> set[int]:
    ids: set[int] = set()
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "-" in tok:
            lo, hi = tok.split("-")
            ids.update(range(int(lo), int(hi) + 1))
        else:
            ids.add(int(tok))
    return ids


def getreads(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1, in2 = a.get("in", "in1"), a.get("in2")
    out1, out2 = a.get("out", "out1"), a.get("out2")
    ids = _parse_id_spec(a.get("id", "ids", default="") or "")
    kept = 0
    with open_output(out1) as fh1:
        fh2 = open_output(out2) if (in2 and out2) else None
        it2 = _records(in2) if in2 else None
        for rid, rec in enumerate(_records(in1)):
            mate = next(it2) if it2 is not None else None
            if rid not in ids:
                continue
            kept += 1
            _write_rec(fh1, rec)
            if mate is not None:
                _write_rec(fh2 if fh2 is not None else fh1, mate)
        if fh2 is not None:
            fh2.close()
    print(f"Kept {kept} reads.", file=sys.stderr)
    return kept


def replaceheaders(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    hin = a.get("hin", "headers")
    out1 = a.get("out", "out1")
    prefix = a.get_bool("prefix", default=False)
    # header source: fasta/fastq sequence file, or one name per line
    with open_input(hin) as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.strip()]
    if lines and lines[0].startswith(b">"):
        names = [ln[1:].strip() for ln in lines if ln.startswith(b">")]
    elif lines and lines[0].startswith(b"@") and len(lines) % 4 == 0:
        names = [lines[i][1:].strip() for i in range(0, len(lines), 4)]
    else:
        names = [ln.strip() for ln in lines]
    n = 0
    with open_output(out1) as fh:
        for i, rec in enumerate(_records(in1)):
            nm = names[i % len(names)] if names else rec[0]
            if prefix:
                nm = nm + b"_" + rec[0]
            _write_rec(fh, (nm, rec[1], rec[2]))
            n += 1
    print(f"Renamed {n} reads.", file=sys.stderr)
    return n


def _read_covstats(path):
    """Parse a pileup covstats file into {id: dict} keyed by the header
    line (jgi/CovStatsLine.java initializeHeader :100 — columns located
    by name, any Under_* column aliased to under_min)."""
    stats = {}
    with open_input(path) as fh:
        lines = fh.read().splitlines()
    if not lines:
        return stats
    hdr = lines[0].lstrip(b"#").split(b"\t")
    col = {}
    for i, h in enumerate(hdr):
        h = h.lower()
        if h.startswith(b"under_"):
            h = b"under_min"
        col[h.decode()] = i
    for line in lines[1:]:
        if not line or line.startswith(b"#"):
            continue
        f = line.split(b"\t")

        def g(name, cast=float, default=0):
            i = col.get(name)
            return cast(f[i]) if i is not None and i < len(f) else default

        stats[f[0]] = dict(
            avg=g("avg_fold"),
            pct=g("covered_percent"),
            reads=g("plus_reads", int) + g("minus_reads", int),
            under=g("under_min", int),
        )
    return stats


def filterbycoverage(argv=None):
    """FilterByCoverage (filterbycoverage.sh) — split an assembly into
    clean/dirty by covstats thresholds. Decision logic mirrors
    jgi/FilterByCoverage.java process() :295-330: with a cov0 (pre-
    normalization) file, a contig is contaminant when its normalized
    stats fail minr/minl/minp, OR (avgFold<minc AND the raw/normalized
    coverage ratio exceeds minratio) OR avgFold<0.5, OR the low-coverage
    window base count exceeds basesundermin; without cov0, avgFold<minc
    is unconditional. Contigs missing from covstats are contaminants.
    """
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    cov1 = a.get("cov", "cov1")
    cov0 = a.get("cov0")
    out1 = a.get("out", "out1", "outclean")
    outd = a.get("outd", "outdirty")
    minc = a.get_float("minc", "mincov", "mincoverage", default=5.0)
    minp = a.get_float("minp", "minpercent", default=40.0)
    minr = a.get_int("minr", "minreads", default=20)
    minl = a.get_int("minl", "minlen", "minlength", default=0)
    trim = a.get_int("trim", "trimends", default=0)
    minratio = a.get_float("minratio", "ratio", default=0.0)
    basesundermin = a.get_int("basesundermin", default=-1)
    logfile = a.get("log", "results")
    logheader = a.get_bool("logheader", default=True)
    logappend = a.get_bool(
        "appendlog", "logappend", "appendresults", default=False
    )

    stats1 = _read_covstats(cov1)
    stats0 = _read_covstats(cov0) if cov0 else None
    assembly = os.path.basename(in1)
    logfh = None
    if logfile:
        logfh = open(logfile, "ab" if logappend else "wb")
        if logheader:
            logfh.write(
                b"#assembly\tcontig\tcontam\tlength\tavgFold\treads\t"
                b"percentCovered"
                + (b"" if stats0 is None else b"\tavgFold0\treads0\tnormRatio")
                + b"\n"
            )
    clean, dirty = [], []
    for rec in read_fasta(in1):
        name = rec.name.split()[0]
        seq = rec.seq
        if trim:
            if len(seq) - 2 * trim < minl:
                seq = b""
            else:
                seq = seq[trim : len(seq) - trim]
        length = len(seq)
        s1 = stats1.get(name)
        s0 = stats0.get(name) if stats0 is not None else None
        ratio = 0.0
        if s1 is None:
            contam = True
        elif s0 is not None:
            ratio = s0["avg"] / max(0.01, s1["avg"])
            under = s0["under"] - s1["under"]
            contam = (
                s1["reads"] < minr
                or length < minl
                or s1["pct"] < minp
                or (s1["avg"] < minc and ratio > minratio)
                or s1["avg"] < 0.5
                or (basesundermin > 0 and under > basesundermin)
            )
        else:
            contam = (
                s1["reads"] < minr
                or length < minl
                or s1["pct"] < minp
                or s1["avg"] < minc
                or (basesundermin > 0 and s1["under"] > basesundermin)
            )
        if logfh is not None:
            a1 = s1 or dict(avg=0.0, reads=0, pct=0.0)
            row = b"%s\t%s\t%s\t%d\t%.2f\t%d\t%.2f" % (
                assembly.encode(), name, b"1" if contam else b"0", length,
                a1["avg"], a1["reads"], a1["pct"],
            )
            if stats0 is not None:
                a0 = s0 or dict(avg=0.0, reads=0)
                row += b"\t%.2f\t%d\t%.2f" % (a0["avg"], a0["reads"], ratio)
            logfh.write(row + b"\n")
        if length > 0:
            (dirty if contam else clean).append(FastaRecord(rec.name, seq))
    if logfh is not None:
        logfh.close()
    if out1:
        write_fasta(out1, clean)
    if outd:
        write_fasta(outd, dirty)
    print(
        f"Kept {len(clean)} contigs, removed {len(dirty)}.", file=sys.stderr
    )
    return clean, dirty


def randomgenome(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    total = parse_kmg(a.get("len", "length", default="1m"))
    chroms = a.get_int("chroms", default=1)
    gc = a.get_float("gc", default=0.5)
    out1 = a.get("out", "out1")
    rng = np.random.default_rng(a.get_int("seed", default=0))
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    per = total // chroms
    recs = []
    for c in range(chroms):
        n = per if c < chroms - 1 else total - per * (chroms - 1)
        codes = rng.choice(4, size=n, p=p)
        seq = np.frombuffer(BASES, dtype=np.uint8)[codes].tobytes()
        recs.append(FastaRecord(b"chr%d" % (c + 1), seq))
    if out1:
        write_fasta(out1, recs)
    return recs


def makepolymers(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    out1 = a.get("out", "out1")
    k = a.get_int("k", default=1)
    mink = a.get_int("mink", default=k)
    maxk = a.get_int("maxk", default=k)
    minlen = a.get_int("minlen", default=31)
    recs = []
    for kk in range(mink, maxk + 1):
        for idx in range(4**kk):
            unit = bytes(
                BASES[(idx >> (2 * (kk - 1 - j))) & 3] for j in range(kk)
            )
            # long enough that all kmers of length minlen are present
            reps = -(-(minlen + kk - 1) // kk)
            seq = (unit * reps)[: minlen + kk - 1]
            recs.append(FastaRecord(b"poly_%s" % unit, seq))
    if out1:
        write_fasta(out1, recs)
    print(f"Wrote {len(recs)} polymers.", file=sys.stderr)
    return recs


_TET_INDEX = None


def _tetramer_index():
    """Map each of the 256 tetramers to its canonical slot (136 total)."""
    global _TET_INDEX
    if _TET_INDEX is None:
        canon = {}
        idx = np.zeros(256, dtype=np.int64)
        for v in range(256):
            codes = [(v >> (2 * (3 - j))) & 3 for j in range(4)]
            rc = 0
            for c in codes:
                rc = (rc << 2) | (3 - c)
            key = min(v, rc)
            if key not in canon:
                canon[key] = len(canon)
            idx[v] = canon[key]
        _TET_INDEX = (idx, len(canon))
    return _TET_INDEX


def tetramerfreq(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    window = a.get_int("window", "w", default=2000)
    step = a.get_int("step", "s", default=window)
    short = a.get_bool("short", default=False)
    idx, nslots = _tetramer_index()
    lines = [b"#scaffold\tstart\tlength\t" + b"\t".join(
        b"t%d" % i for i in range(nslots)
    ) + b"\n"]
    B2C = np.full(256, 4, dtype=np.uint8)
    for i, b in enumerate(b"ACGT"):
        B2C[b] = i
        B2C[b + 32] = i
    for rec in read_fasta(in1):
        codes = B2C[np.frombuffer(rec.seq, dtype=np.uint8)]
        L = len(codes)
        if L < 4 or (short and L < window):
            continue
        # rolling 4-mer values; invalid where any base is N
        v = codes[:-3].astype(np.int64) * 64 + codes[1:-2] * 16 \
            + codes[2:-1] * 4 + codes[3:]
        valid = (
            (codes[:-3] < 4) & (codes[1:-2] < 4)
            & (codes[2:-1] < 4) & (codes[3:] < 4)
        )
        slots = idx[np.clip(v, 0, 255)]
        for start in range(0, max(L - 3, 1), step):
            stop = min(start + window - 3, len(slots))
            if stop <= start:
                break
            w_slots = slots[start:stop][valid[start:stop]]
            counts = np.bincount(w_slots, minlength=nslots)
            lines.append(
                rec.name.split()[0]
                + b"\t%d\t%d\t" % (start, min(window, L - start))
                + b"\t".join(b"%d" % c for c in counts)
                + b"\n"
            )
            if start + window >= L:
                break
    if out1:
        with open_output(out1) as fh:
            fh.writelines(lines)
    return lines


def callpeaks(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    min_height = a.get_int("minheight", "h", default=2)
    min_volume = a.get_int("minvolume", "v", default=5)
    min_width = a.get_int("minwidth", "w", default=3)
    min_peak = a.get_int("minpeak", "minp", default=2)
    max_peak = a.get_int("maxpeak", "maxp", default=1_000_000_000)
    max_count = a.get_int("maxpeakcount", "maxpc", default=12)
    ploidy_in = a.get_int("ploidy", default=-1)
    k = a.get_int("k", default=31)

    # 2-column histogram (depth, count); '#' comments ignored
    xs, ys = [], []
    with open_input(in1) as fh:
        for line in fh.read().splitlines():
            if not line or line.startswith(b"#"):
                continue
            f = line.split()
            xs.append(int(f[0]))
            ys.append(int(float(f[1])))
    size = (max(xs) + 2) if xs else 2
    hist = np.zeros(size, dtype=np.int64)
    for x, y in zip(xs, ys):
        hist[x] = y
    sm = hist.astype(np.float64).copy()
    sm[1:-1] = (hist[:-2] + hist[1:-1] + hist[2:]) / 3.0

    peaks = []  # (start, center, stop, max, volume)
    i = max(min_peak, 1)
    while i < len(sm) - 1:
        if sm[i] > sm[i - 1] and sm[i] >= sm[i + 1] and hist[i] > 0:
            lo = i
            while lo > 1 and sm[lo - 1] < sm[lo]:
                lo -= 1
            hi = i
            while hi < len(sm) - 1 and sm[hi + 1] < sm[hi]:
                hi += 1
            vol = int(hist[lo : hi + 1].sum())
            if (
                hist[i] >= min_height and vol >= min_volume
                and hi - lo + 1 >= min_width and min_peak <= i <= max_peak
            ):
                peaks.append((lo, i, hi, int(hist[i]), vol))
            i = hi + 1
        else:
            i += 1
    peaks = peaks[:max_count]

    # genome size / ploidy estimates from the primary (largest-volume) peak
    text = [b"#k\t%d\n" % k]
    if peaks:
        primary = max(peaks, key=lambda p: p[4])
        center = primary[1]
        # unique kmer volume above the error valley
        first_lo = peaks[0][0]
        total_kmers = int((hist[first_lo:] * np.arange(first_lo, size)).sum())
        genome_size = total_kmers // max(center, 1)
        # ploidy: a half-coverage peak with substantial volume implies 2
        ploidy = ploidy_in if ploidy_in > 0 else (
            2 if any(
                abs(p[1] * 2 - center) <= max(2, center // 10)
                and p[4] >= primary[4] * 0.2
                for p in peaks
            ) else 1
        )
        text.append(b"#unique_kmers\t%d\n" % int(hist[first_lo:].sum()))
        text.append(b"#main_peak\t%d\n" % center)
        text.append(b"#genome_size_in_peaks\t%d\n" % genome_size)
        text.append(b"#ploidy\t%d\n" % ploidy)
    text.append(b"#start\tcenter\tstop\tmax\tvolume\n")
    for p in peaks:
        text.append(("\t".join(str(x) for x in p) + "\n").encode())
    blob = b"".join(text)
    if out1:
        with open_output(out1) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return peaks


def _read_ranges(path):
    """Parse a pileup rangecov file: '#contig' header lines followed by
    'start-end\\tdepth' rows, 0-based inclusive (CoveragePileup.java
    writeCoverageRanges :1927)."""
    out: dict[bytes, list] = {}
    cur = None
    with open_input(path) as fh:
        for line in fh.read().splitlines():
            if not line:
                continue
            if line.startswith(b"#"):
                cur = line[1:].split()[0]
                out[cur] = []
            else:
                span, depth = line.split(b"\t")
                a, b = span.split(b"-")
                out[cur].append([int(a), int(b), float(depth)])
    return out


def trimcontigs(argv=None):
    """TrimContigs (trimcontigs.sh) — trim/break contigs to read-supported
    coverage ranges. Mirrors jgi/TrimContigs.java: ranges separated by
    <=maxuncovered defined bases (or poly-N gaps up to 2x that, when
    skippolyn) are fused (fixPolyN :551); with break=f all ranges collapse
    to the bounding range (toMaximalRange :534); each surviving part is
    trimmed with trimmin/trimmax/trimextra clamps and discarded below
    mincov/minlen (processSeq :432).
    """
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    ranges_path = a.get("ranges", "rangefile")
    out1 = a.get("out", "out1", "outclean")
    outd = a.get("outd", "outdirty")
    minc = a.get_float("mincov", "minc", "mincoverage", default=1.0)
    minl = max(1, a.get_int("minlen", "minl", "minlength", default=1))
    trimmin = max(0, a.get_int("trimmin", "trim", "trimends", default=0))
    trimmax = a.get_int("trimmax", "maxtrim", default=2_000_000_000)
    extra = a.get_int("trimextra", "extra", default=5)
    maxuncov = a.get_int("maxuncovered", "maxuncoveredlength", default=3)
    breakc = a.get_bool("break", "breakcontigs", default=True)
    skippolyn = a.get_bool("skippolyn", default=True)
    breaklist = a.get("breaklist")

    rmap = _read_ranges(ranges_path) if ranges_path else {}
    clean, dirty, broken = [], [], []

    def mid(x, lo, hi):
        # Tools.mid: the median of the three values
        return sorted((x, lo, hi))[1]

    for rec in read_fasta(in1):
        name = rec.name.split()[0]
        seq = rec.seq
        ranges = [list(r) for r in rmap.get(name, [])]
        if len(ranges) > 1:
            if not breakc:
                depth_sum = sum((b - a0 + 1) * d for a0, b, d in ranges)
                a0 = min(r[0] for r in ranges)
                b0 = max(r[1] for r in ranges)
                ranges = [[a0, b0, depth_sum / (b0 - a0 + 1)]]
            else:
                # fixPolyN: fuse across small or poly-N gaps
                fused = []
                left = ranges[0]
                for right in ranges[1:]:
                    gap = seq[left[1] + 1 : right[0]]
                    undefined = sum(
                        1 for ch in gap if ch not in b"ACGTacgt"
                    )
                    defined = len(gap) - undefined
                    if not skippolyn:
                        defined += undefined
                        undefined = 0
                    if defined <= maxuncov or (
                        undefined > 0 and defined <= maxuncov * 2
                    ):
                        ds = (left[1] - left[0] + 1) * left[2] + (
                            right[1] - right[0] + 1
                        ) * right[2]
                        left = [
                            left[0], right[1],
                            ds / (right[1] - left[0] + 1),
                        ]
                    else:
                        fused.append(left)
                        left = right
                fused.append(left)
                ranges = fused
        if not ranges or len(seq) - 2 * trimmin < minl:
            dirty.append(rec)
            continue
        if len(ranges) > 1:
            broken.append(name)
        parts_kept = 0
        for pi, (ra, rb, depth) in enumerate(ranges):
            if depth < minc:
                continue
            # processSeq trimming clamps
            if len(ranges) == 1 and (
                depth >= minc and len(seq) >= minl and trimmin < 1
                and ra <= maxuncov and len(seq) - rb - 1 <= maxuncov
            ):
                clean.append(rec)
                parts_kept += 1
                continue
            a1 = ra + extra if ra >= maxuncov else 0
            a1 = mid(a1, trimmin, trimmax)
            b1 = rb - extra if len(seq) - rb - 1 > maxuncov else len(seq) - 1
            b1 = mid(b1, len(seq) - trimmin - 1, len(seq) - trimmax - 1)
            sub = seq[a1 : b1 + 1]
            if len(sub) < minl:
                continue
            pname = (
                rec.name if len(ranges) == 1
                else rec.name + b"_part%d" % (pi + 1)
            )
            clean.append(FastaRecord(pname, sub))
            parts_kept += 1
        if parts_kept == 0:
            dirty.append(rec)
    if out1:
        write_fasta(out1, clean)
    if outd:
        write_fasta(outd, dirty)
    if breaklist:
        with open_output(breaklist) as fh:
            for n in broken:
                fh.write(n + b"\n")
    print(
        f"Kept {len(clean)} contigs, removed {len(dirty)}, "
        f"broke {len(broken)}.", file=sys.stderr,
    )
    return clean, dirty


if __name__ == "__main__":
    shuffle()
