"""Small reporting/conversion utilities: readlength, countgc,
testformat, translate6frames, statswrapper, and the text and sketch
tools of the same module.

The PyTorch port of bbtools_tpu/models/texttools.py. Every function is
the JAX package's, but two that do device work:
  - bloomfilter (bloom/BloomFilterWrapper, bloomfilter.sh) builds a
    counting filter of the ref= k-mers (keys max(forward, reverse), as
    the JAX package takes them) in a count-min sketch on the run's
    device (`device=`, cuda by default; ops/cms.py), then keeps (or with
    include=f tosses) reads with >= minhits k-mer hits, one sketch query
    a batch. The k-mers are rolled on the device too
    (`ops/kmer_count.read_keys_t`; host numpy in the JAX package).
  - kmercountmulti keeps its LogLog trackers on the run's device
    (models/loglog.py; `device=`, cuda by default).

References (semantics source):
  - jgi/MakeLengthHistogram.java (readlength.sh) — binned read-length
    histogram with the reference's #Reads/#Bases/#Max/#Min/#Avg/#Median
    header block.
  - jgi/CountGC.java (countgc.sh) — per-sequence GC fraction and summary.
  - fileIO/FileFormat test mode (testformat.sh) — report format,
    compression, quality offset and interleaving per file.
  - jgi/TranslateSixFrames.java (translate6frames.sh) — all six reading
    frames to amino acids, frame tagged in the header.
  - driver/StatsWrapper.java (statswrapper.sh) — assemblystats over many
    files, one table row each.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fasta import iter_fasta, write_fasta
from ..io.fastq import FastqReader
from ..io.fileformat import Format, test_input
from ..io.readwrite import open_input, open_output


def _iter_lengths(path: str):
    if test_input(path).format is Format.FASTA:
        for rec in iter_fasta(path):
            yield len(rec.seq)
    else:
        for b in FastqReader(path):
            for i in range(b.n):
                yield int(b.lengths[i])


def readlength(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out = a.get("out", "hist")
    binsz = a.get_int("bin", default=10)
    lens = np.fromiter(_iter_lengths(in1), dtype=np.int64)
    n = len(lens)
    total = int(lens.sum()) if n else 0
    lines = [
        b"#Reads:\t%d" % n,
        b"#Bases:\t%d" % total,
        b"#Max:\t%d" % (int(lens.max()) if n else 0),
        b"#Min:\t%d" % (int(lens.min()) if n else 0),
        b"#Avg:\t%.1f" % (total / n if n else 0.0),
        b"#Median:\t%d" % (int(np.median(lens)) if n else 0),
        b"#Length\treads\tpct_reads\tcum_reads\tcum_pct_reads\tbases\tpct_bases\tcum_bases\tcum_pct_bases",
    ]
    if n:
        bins = (lens // binsz) * binsz
        uniq, counts = np.unique(bins, return_counts=True)
        bsum = np.array(
            [int(lens[bins == u].sum()) for u in uniq], dtype=np.int64
        )
        cum_r = np.cumsum(counts)
        cum_b = np.cumsum(bsum)
        for u, c, bs, cr, cb in zip(uniq, counts, bsum, cum_r, cum_b):
            lines.append(
                b"%d\t%d\t%.3f\t%d\t%.3f\t%d\t%.3f\t%d\t%.3f"
                % (u, c, 100 * c / n, cr, 100 * cr / n,
                   bs, 100 * bs / total, cb, 100 * cb / total)
            )
    text = b"\n".join(lines) + b"\n"
    if out:
        with open_output(out) as fh:
            fh.write(text)
    else:
        sys.stdout.buffer.write(text)
    print(f"Reads:               \t{n}", file=sys.stderr)
    return lens


def countgc(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out = a.get("out")
    rows = []
    total_gc = total_at = 0
    if test_input(in1).format is Format.FASTA:
        it = ((rec.name.split()[0], np.frombuffer(rec.seq.upper(), np.uint8))
              for rec in iter_fasta(in1))
    else:
        def gen():
            for b in FastqReader(in1):
                for i in range(b.n):
                    yield b.ids[i].split()[0], np.frombuffer(
                        b.sequence(i).upper(), np.uint8
                    )
        it = gen()
    for name, arr in it:
        gc = int(np.isin(arr, np.frombuffer(b"GC", np.uint8)).sum())
        at = int(np.isin(arr, np.frombuffer(b"AT", np.uint8)).sum())
        total_gc += gc
        total_at += at
        rows.append((name, len(arr), gc / max(gc + at, 1)))
    if out:
        with open_output(out) as fh:
            for name, ln, frac in rows:
                fh.write(b"%s\t%d\t%.4f\n" % (name, ln, frac))
    frac = total_gc / max(total_gc + total_at, 1)
    print(f"Overall GC:          \t{frac:.4f}", file=sys.stderr)
    return rows, frac


def testformat(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    paths = [t for t in argv if "=" not in t] or [
        tokenize(argv).get("in", "in1")
    ]
    out = []
    for p in paths:
        ff = test_input(p)
        parts = [ff.format.value, ff.compression.value]
        if ff.format is Format.FASTQ:
            from ..io.fastq import FastqReader

            b = next(iter(FastqReader(p, batch_reads=256)), None)
            if b is not None:
                qo = getattr(b, "qual_offset", 33)
                parts.append(f"sanger" if qo == 33 else f"illumina")
                names = [b.ids[i] for i in range(min(b.n, 2))]
                inter = (
                    len(names) == 2
                    and names[0].split()[0] == names[1].split()[0]
                )
                parts.append("interleaved" if inter else "single-ended")
        line = "\t".join([p] + parts)
        print(line)
        out.append(line)
    return out


def translate6frames(argv=None):
    from .callgenes import translate

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out = a.get("out", "out1")
    from ..core.dna import encode

    recs = []
    for rec in iter_fasta(in1):
        codes = encode(rec.seq)
        rc = np.where(codes < 4, 3 - codes, 4)[::-1]
        for strand, c in ((0, codes), (1, rc)):
            for frame in range(3):
                aa = translate(c[frame:])
                tag = b" fr%d%s" % (frame + 1, b"+" if strand == 0 else b"-")
                recs.append((rec.name.split()[0] + tag, aa.encode()))
    if out:
        write_fasta(out, recs)
    print(f"Frames Out:          \t{len(recs)}", file=sys.stderr)
    return recs


def statswrapper(argv=None):
    from .assemblystats import analyze, n_metrics

    a = tokenize(argv if argv is not None else sys.argv[1:])
    ins = a.get_list("in") or [
        t for t in (argv or []) if "=" not in t
    ]
    rows = []
    print("n_scaffolds\tscaf_bp\tscaf_N50\tscaf_L50\tscaf_max\tgc_avg\tfilename")
    for p in ins:
        scafs, contigs, gc, at, ns = analyze(p)
        n50, l50 = n_metrics(scafs, 0.5)
        row = (
            len(scafs), int(scafs.sum()), n50, l50,
            int(scafs.max(initial=0)), gc / max(gc + at, 1), p,
        )
        print("%d\t%d\t%d\t%d\t%d\t%.4f\t%s" % row)
        rows.append(row)
    return rows


def sketchblacklist(argv=None):
    """sketchblacklist.sh (sketch/BlacklistMaker.java role): build a
    blacklist of sketch hashes shared by >= mintaxcount input
    sequences/files — keys so widely shared they carry no taxonomic
    signal. Output is this repo's TSV sketch format, consumable by
    sketch blacklist= (models/sketch.load_blacklist)."""
    from .sketch import sketch_sequences, write_sketch
    from ..core.dna import encode

    a = tokenize(argv if argv is not None else sys.argv[1:])
    ins = a.get_list("in") or []
    out = a.get("out")
    k = a.get_int("k", default=31)
    size = a.get_int("size", default=100000)
    mintax = a.get_int("mintaxcount", default=2)
    per_seq = a.get_bool("perseq", "persequence", default=True)
    counts: dict[int, int] = {}
    n_units = 0
    for path in ins:
        units = []
        if per_seq:
            for rec in iter_fasta(path):
                units.append([encode(rec.seq)])
        else:
            units.append([encode(rec.seq) for rec in iter_fasta(path)])
        for u in units:
            n_units += 1
            for h in sketch_sequences(iter(u), k, size).tolist():
                counts[h] = counts.get(h, 0) + 1
    bl = np.sort(
        np.array(
            [h for h, c in counts.items() if c >= mintax], dtype=np.uint64
        )
    )
    if out:
        write_sketch(out, bl, "blacklist", k)
    print(f"Units Sketched:      \t{n_units}", file=sys.stderr)
    print(f"Blacklisted Keys:    \t{len(bl)}", file=sys.stderr)
    return bl


def bloomfilter(argv=None):
    """bloomfilter.sh (bloom/BloomFilterWrapper role): build a counting
    filter from ref= k-mers on device (ops/cms.CountMinSketch), then
    keep (or with include=f toss) reads with >= minhits k-mer hits."""
    from ..core.dna import encode
    from ..io.fastq import FastqWriter
    from ..ops.cms import CountMinSketch
    from ..ops.kmer_count import read_keys_t

    a = tokenize(argv if argv is not None else sys.argv[1:])
    device = resolve_device(a.get("device", default="cuda"))
    in1 = a.get("in", "in1")
    ref = a.get("ref")
    out1 = a.get("out", "out1")
    outm = a.get("outm", "outmatch")
    k = a.get_int("k", default=31)
    minhits = a.get_int("minhits", default=1)
    include = a.get_bool("include", default=False)
    cms = CountMinSketch(device=device)
    for rec in iter_fasta(ref):
        codes = encode(rec.seq)
        if len(codes) < k:
            continue
        flat, _ = read_keys_t(codes[None, :], [len(codes)], k, device, canonical=False)
        cms.add(flat)
    kept = total = 0
    w = FastqWriter(out1) if out1 else None
    wm = FastqWriter(outm) if outm else None
    for b in FastqReader(in1):
        flat, counts = read_keys_t(b.bases, b.lengths, k, device, canonical=False)
        hits = np.zeros(b.n, np.int64)
        if len(flat):
            found = cms.query(flat) > 0
            hits = np.bincount(np.repeat(np.arange(b.n), counts), weights=found,
                               minlength=b.n).astype(np.int64)
        matched = hits >= minhits
        keep = matched if include else ~matched
        total += b.n
        kept += int(keep.sum())
        if w:
            w.add(b, keep)
        if wm:
            wm.add(b, matched)
    for x in (w, wm):
        if x:
            x.close()
    print(f"Reads Processed:    \t{total}", file=sys.stderr)
    print(f"Reads Out:          \t{kept}", file=sys.stderr)
    return kept, total


def rename(argv=None):
    """rename.sh (jgi/RenameReads.java): rename reads with prefix= and a
    running number (or addprefix=t to keep the old name after it)."""
    from ..io.batch import ReadBatch
    from ..io.fastq import FastqWriter

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    prefix = (a.get("prefix") or "").encode()
    addprefix = a.get_bool("addprefix", default=False)
    renumber = a.get_bool("renumber", default=True)
    n = 0
    with FastqWriter(out1) as w:
        for b in FastqReader(in1):
            ids = []
            for i in range(b.n):
                if addprefix:
                    ids.append(prefix + b" " + b.ids[i])
                elif renumber:
                    ids.append(
                        (prefix + b"_" if prefix else b"") + b"%d" % n
                    )
                else:
                    ids.append(prefix or b.ids[i])
                n += 1
            b.ids = ids
            w.add(b)
    print(f"Reads Renamed:       \t{n}", file=sys.stderr)
    return n


def kmercountmulti(argv=None):
    """kmercountmulti.sh (jgi/KmerCountMulti.java): HLL cardinality
    estimates for a sweep of k values in one pass."""
    from .loglog import LogLog

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    ks = [
        int(x) for x in (a.get("k") or "17,24,31").replace("-", ",").split(",")
    ]
    sweep = a.get("sweep")
    if sweep:
        lo, hi, step = (int(x) for x in sweep.split(","))
        ks = list(range(lo, hi + 1, step))
    out = a.get("out")
    device = resolve_device(a.get("device", default="cuda"))
    lls = {k: LogLog(k=k, device=device) for k in ks}
    for b in FastqReader(in1):
        for k in ks:
            lls[k].add_batch(b.bases, b.lengths)
    rows = [(k, int(lls[k].cardinality())) for k in ks]
    lines = ["#k\tunique_kmers"] + [f"{k}\t{c}" for k, c in rows]
    text = "\n".join(lines) + "\n"
    if out:
        with open_output(out) as fh:
            fh.write(text.encode())
    else:
        print(text, end="")
    return rows


def filterlines(argv=None):
    """filterlines.sh (driver/FilterLines.java): keep/toss text lines
    matching names= (exact, prefix=t first-token, substring=t/line)."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    include = a.get_bool("include", default=False)
    prefix = a.get_bool("prefix", default=False)
    substring = (a.get("substring") or "f").lower()
    case = a.get_bool("casesensitive", "case", default=True)
    names: set[bytes] = set()
    spec = a.get("names", default="") or ""
    for tok in spec.split(","):
        if os.path.exists(tok):
            with open_input(tok) as fh:
                for ln in fh.read().splitlines():
                    if ln.strip():
                        names.add(ln.strip() if case else ln.strip().lower())
        elif tok:
            names.add(tok.encode() if case else tok.encode().lower())

    def matches(line: bytes) -> bool:
        x = line if case else line.lower()
        probe = x.split()[0] if (prefix and x.split()) else x
        if probe in names:
            return True
        if substring in ("t", "true"):
            return any(n in x or x in n for n in names)
        if substring == "line":
            return any(x in n for n in names)
        return False

    kept = total = 0
    with open_input(in1) as fi, open_output(out1) as fo:
        for raw in fi.read().splitlines():
            total += 1
            if matches(raw) == include:
                fo.write(raw + b"\n")
                kept += 1
    print(f"Kept {kept} of {total} lines.", file=sys.stderr)
    return kept, total


def countsharedlines(argv=None):
    """countsharedlines.sh (driver/CountSharedLines.java): one output
    file per in1= file listing shared-line counts vs each in2= file."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    set1 = (a.get("in", "in1", default="") or "").split(",")
    set2 = (a.get("in2", default="") or "").split(",")
    case = a.get_bool("casesensitive", "case", default=True)
    prefix = a.get_bool("prefix", default=False)
    out = a.get("out")

    def load(path):
        with open_input(path) as fh:
            lines = {
                ln.strip() if case else ln.strip().lower()
                for ln in fh.read().splitlines() if ln.strip()
            }
        if prefix:
            lines = {ln.split()[0] for ln in lines}
        return lines

    s2 = {p: load(p) for p in set2 if p}
    results = {}
    for p1 in set1:
        if not p1:
            continue
        l1 = load(p1)
        rows = [(p2, len(l1 & l2)) for p2, l2 in s2.items()]
        results[p1] = rows
        text = "".join(f"{p2}\t{n}\n" for p2, n in rows)
        dest = out or (p1.rsplit("/", 1)[-1] + ".shared")
        with open_output(dest) as fh:
            fh.write(text.encode())
    return results


def unicode2ascii(argv=None):
    """unicode2ascii.sh: replace non-ascii/control bytes with printable
    ascii (best-effort transliteration, '?' fallback)."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    with open_input(in1) as fh:
        data = fh.read()
    text = data.decode("utf-8", errors="replace")
    import unicodedata

    norm = unicodedata.normalize("NFKD", text)
    cleaned = []
    for ch in norm:
        o = ord(ch)
        if ch in "\n\t" or 32 <= o < 127:
            cleaned.append(ch)
        elif o < 32 or 127 <= o < 160:
            continue  # control characters are dropped
        elif unicodedata.category(ch).startswith("M"):
            continue  # combining marks (from NFKD decomposition)
        else:
            cleaned.append("?")
    blob = "".join(cleaned).encode("ascii", errors="replace")
    with open_output(out1) as fh:
        fh.write(blob)
    return blob


def phylip2fasta(argv=None):
    """phylip2fasta.sh (driver/Phylip2Fasta.java): interleaved phylip ->
    fasta."""
    from ..io.fasta import FastaRecord, write_fasta

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    with open_input(in1) as fh:
        lines = [ln.rstrip(b"\r\n") for ln in fh.read().splitlines()]
    if not lines:
        return []
    ntaxa = int(lines[0].split()[0])
    names: list[bytes] = []
    seqs: list[list[bytes]] = []
    body = [ln for ln in lines[1:]]
    block_i = 0
    for ln in body:
        if not ln.strip():
            continue
        if len(names) < ntaxa:
            parts = ln.split(None, 1)
            names.append(parts[0])
            seqs.append([parts[1].replace(b" ", b"") if len(parts) > 1 else b""])
        else:
            seqs[block_i % ntaxa].append(ln.replace(b" ", b""))
            block_i += 1
    recs = [FastaRecord(n, b"".join(s)) for n, s in zip(names, seqs)]
    if out1:
        write_fasta(out1, recs)
    return recs


def summarizeseal(argv=None):
    """summarizeseal.sh (driver/SummarizeSealStats.java): merge Seal
    stats= files into one table of primary vs nonprimary hits. Primary =
    the ref row whose name shares the stats file's name prefix (or the
    largest row with primary=auto, the default here)."""
    argv = argv if argv is not None else sys.argv[1:]
    a = tokenize([t for t in argv if "=" in t])
    files = [t for t in argv if "=" not in t]
    spec = a.get("in", "in1")
    if spec:
        files = spec.split(",") + files
    out = a.get("out")
    lines = [b"#file\treads\tprimary\tnonprimary\tpctPrimary\n"]
    results = []
    for path in files:
        rows = []
        with open_input(path) as fh:
            for ln in fh.read().splitlines():
                if not ln or ln.startswith(b"#"):
                    continue
                f = ln.split(b"\t")
                if f[0] == b"*unmatched*":
                    continue
                rows.append((f[0], int(f[1])))
        stem = path.rsplit("/", 1)[-1].split(".")[0].encode()
        named = [r for r in rows if stem and stem in r[0]]
        primary = (
            named[0][1] if named
            else max((r[1] for r in rows), default=0)
        )
        total = sum(r[1] for r in rows)
        nonprim = total - primary
        pct = 100.0 * primary / max(total, 1)
        results.append((path, total, primary, nonprim, pct))
        lines.append(
            b"%s\t%d\t%d\t%d\t%.3f\n"
            % (path.encode(), total, primary, nonprim, pct)
        )
    blob = b"".join(lines)
    if out:
        with open_output(out) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return results


def picksubset(argv=None):
    """picksubset.sh (driver/PickSubset.java): from an all-to-all
    (query, ref, ANI%) TSV, keep files=N maximizing pairwise distance
    and/or drop members of pairs above ani= (greedy: repeatedly remove
    the file with the highest summed similarity to the remainder)."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out = a.get("out")
    invalid = a.get("invalid")
    files = a.get_int("files", default=0)
    max_ani = a.get_float("ani", default=0.0)
    if not files and not max_ani:
        raise ValueError("picksubset: files= or ani= must be set")
    sim: dict[tuple[bytes, bytes], float] = {}
    names: list[bytes] = []
    seen = set()
    with open_input(in1) as fh:
        for line in fh.read().splitlines():
            if not line or line.startswith(b"#"):
                continue
            f = line.split(b"\t")
            if len(f) < 3:
                continue
            q, r, ani = f[0], f[1], float(f[2])
            if q == r:
                continue
            sim[(q, r)] = sim[(r, q)] = max(ani, sim.get((q, r), 0.0))
            for x in (q, r):
                if x not in seen:
                    seen.add(x)
                    names.append(x)
    alive = set(names)

    def worst():
        # file with the highest max (then summed) similarity to the rest
        best_name, best_key = None, (-1.0, -1.0)
        for x in alive:
            mx = 0.0
            sm = 0.0
            for y in alive:
                if x != y:
                    s = sim.get((x, y), 0.0)
                    mx = max(mx, s)
                    sm += s
            if (mx, sm) > best_key:
                best_key, best_name = (mx, sm), x
        return best_name, best_key[0]

    removed = []
    while len(alive) > 1:
        name, mx = worst()
        over_ani = max_ani > 0 and mx > max_ani
        over_count = files > 0 and len(alive) > files
        if not over_ani and not over_count:
            break
        alive.discard(name)
        removed.append(name)
    kept = [n for n in names if n in alive]
    if out:
        with open_output(out) as fh:
            fh.write(b"\n".join(kept) + b"\n")
    if invalid:
        with open_output(invalid) as fh:
            fh.write(b"\n".join(removed) + (b"\n" if removed else b""))
    print(f"Kept {len(kept)} of {len(names)} files.", file=sys.stderr)
    return kept, removed


def summarizecoverage(argv=None):
    """summarizecoverage.sh (driver/SummarizeCoverage.java): merge
    pileup basecov files into one table (reads the per-base column,
    reports mean/median/stdev coverage and covered fraction per file)."""
    argv = argv if argv is not None else sys.argv[1:]
    a = tokenize([t for t in argv if "=" in t])
    files = [t for t in argv if "=" not in t]
    spec = a.get("in", "in1")
    if spec:
        files = spec.split(",") + files
    out = a.get("out")
    lines = [b"#file\tmean\tmedian\tstdev\tcoveredPct\tbases\n"]
    results = []
    for path in files:
        cov = []
        with open_input(path) as fh:
            for ln in fh.read().splitlines():
                if not ln or ln.startswith(b"#"):
                    continue
                cov.append(int(ln.rsplit(b"\t", 1)[-1]))
        arr = np.asarray(cov, dtype=np.int64)
        if len(arr) == 0:
            arr = np.zeros(1, dtype=np.int64)
        mean = float(arr.mean())
        med = float(np.median(arr))
        sd = float(arr.std())
        covered = 100.0 * float((arr > 0).mean())
        results.append((path, mean, med, sd, covered, len(cov)))
        lines.append(
            b"%s\t%.3f\t%.1f\t%.3f\t%.2f\t%d\n"
            % (path.encode(), mean, med, sd, covered, len(cov))
        )
    blob = b"".join(lines)
    if out:
        with open_output(out) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return results


def summarizescafstats(argv=None):
    """summarizescafstats.sh (driver/SummarizeSealStats scafstats mode):
    merge BBMap scafstats= files into one primary-vs-nonprimary table
    (primary = the row with the most unambiguous reads)."""
    argv = argv if argv is not None else sys.argv[1:]
    a = tokenize([t for t in argv if "=" in t])
    files = [t for t in argv if "=" not in t]
    spec = a.get("in", "in1")
    if spec:
        files = spec.split(",") + files
    out = a.get("out")
    lines = [b"#file\treads\tprimary\tnonprimary\tpctPrimary\tprimaryScaf\n"]
    results = []
    for path in files:
        rows = []
        with open_input(path) as fh:
            for ln in fh.read().splitlines():
                if not ln or ln.startswith(b"#"):
                    continue
                f = ln.split(b"\t")
                rows.append((f[0], int(f[5]) + int(f[6])))
        total = sum(r[1] for r in rows)
        pname, primary = max(rows, key=lambda r: r[1]) if rows else (b"", 0)
        nonprim = total - primary
        pct = 100.0 * primary / max(total, 1)
        results.append((path, total, primary, nonprim, pct, pname))
        lines.append(
            b"%s\t%d\t%d\t%d\t%.3f\t%s\n"
            % (path.encode(), total, primary, nonprim, pct, pname)
        )
    blob = b"".join(lines)
    if out:
        with open_output(out) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return results


def fastqscan(argv=None):
    """FastqScan (fastqscan.sh) — fast record/base counter with basic
    integrity checks. Mirrors stream/FastqScan.java output (:70-77):
    Records/Bases/Quals/Bytes lines, plus corruption notes (partial
    trailing records, seq/qual length mismatches, Windows \\r\\n).
    FASTA inputs report records and bases only.
    """
    a = tokenize(argv if argv is not None else sys.argv[1:])
    pos = [t for t in (argv if argv is not None else sys.argv[1:])
           if "=" not in t]
    in1 = a.get("in", "in1") or (pos[0] if pos else None)
    with open_input(in1) as fh:
        data = fh.read()
    total_bytes = len(data)
    crlf = b"\r\n" in data
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    if crlf:
        lines = [ln.rstrip(b"\r") for ln in lines]
    records = bases = quals = 0
    corrupt = []
    if lines and lines[0].startswith(b">"):
        for ln in lines:
            if ln.startswith(b">"):
                records += 1
            else:
                bases += len(ln)
    else:
        partial = len(lines) % 4
        if partial:
            corrupt.append(b"At least 1 corrupt records.")
        for i in range(0, len(lines) - partial, 4):
            h, s, p, q = lines[i : i + 4]
            records += 1
            bases += len(s)
            quals += len(q)
            if not h.startswith(b"@") or not p.startswith(b"+"):
                corrupt.append(
                    b"Malformed record at line %d." % (i + 1)
                )
            elif len(s) != len(q):
                corrupt.append(
                    b"Seq/qual length mismatch at line %d." % (i + 1)
                )
    out = [
        b"Records:\t%d" % records,
        b"Bases:  \t%d" % bases,
        b"Quals:  \t%d" % quals,
        b"Bytes:  \t%d" % total_bytes,
    ]
    if crlf:
        out.append(b"Contained Windows-style \\r\\n")
    out += corrupt[:10]
    sys.stdout.buffer.write(b"\n".join(out) + b"\n")
    return records, bases, len(corrupt) == 0 and not crlf


def plotgc(argv=None):
    """plotgc.sh (driver/PlotGC.java) — GC fraction per fixed interval
    of each sequence; columns `name interval start stop runningStart
    runningStop gc` (:142). printshortbins=f drops trailing short bins.
    """
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    interval = a.get_int("interval", default=1000)
    psb = a.get_bool("printshortbins", "psb", default=True)
    lines = [b"name\tinterval\tstart\tstop\trunningStart\trunningStop\tgc"]
    running = 0
    for rec in iter_fasta(in1):
        seq = rec.seq.upper()
        arr = np.frombuffer(seq, np.uint8)
        isgc = (arr == ord("G")) | (arr == ord("C"))
        for s in range(0, len(seq), interval):
            e = min(s + interval, len(seq))
            if e - s < interval and not psb:
                continue
            gc = float(isgc[s:e].mean()) if e > s else 0.0
            lines.append(
                b"%s\t%d\t%d\t%d\t%d\t%d\t%.3f"
                % (
                    rec.name.split()[0], interval, s, e - 1,
                    running + s, running + e - 1, gc,
                )
            )
        running += len(seq)
    blob = b"\n".join(lines) + b"\n"
    if out1:
        with open_output(out1) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return lines


def summarizemerge(argv=None):
    """summarizemerge.sh (driver role) — summarize one or more
    GradeMergedReads output blocks (Correct/Incorrect/Too Short/Too
    Long/SNR lines) into a single TSV for comparing merge runs."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    ins = (a.get("in", "in1") or "").split(",")
    out1 = a.get("out", "out1")
    rows = [b"#file\tcorrect\tincorrect\ttooShort\ttooLong\tsnr"]
    for path in ins:
        vals = {}
        with open_input(path) as fh:
            for line in fh.read().splitlines():
                for key, tag in (
                    (b"Correct:", b"correct"),
                    (b"Incorrect:", b"incorrect"),
                    (b"Too Short:", b"tooShort"),
                    (b"Too Long:", b"tooLong"),
                    (b"SNR:", b"snr"),
                ):
                    if line.startswith(key):
                        f = line.split(b"\t")
                        vals[tag] = f[1].strip().rstrip(b"%")
        rows.append(
            path.encode() + b"\t"
            + b"\t".join(
                vals.get(t, b"?")
                for t in (b"correct", b"incorrect", b"tooShort",
                          b"tooLong", b"snr")
            )
        )
    blob = b"\n".join(rows) + b"\n"
    if out1:
        with open_output(out1) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return rows


def summarizequast(argv=None):
    """summarizequast.sh — combine multiple QUAST report.tsv files
    (2-column `metric<TAB>value` format) into one matrix, metrics as
    rows and one column per report."""
    argv = list(argv if argv is not None else sys.argv[1:])
    a = tokenize([t for t in argv if "=" in t])
    ins = [t for t in argv if "=" not in t]
    spec = a.get("in", "in1")
    if spec:
        ins = spec.split(",") + ins
    out1 = a.get("out", "out1")
    metrics: list[bytes] = []
    table: dict[bytes, list] = {}
    for ci, path in enumerate(ins):
        with open_input(path) as fh:
            for line in fh.read().splitlines():
                f = line.split(b"\t")
                if len(f) < 2:
                    continue
                key = f[0]
                if key not in table:
                    table[key] = [b"?"] * len(ins)
                    metrics.append(key)
                table[key][ci] = f[1]
    rows = [b"#metric\t" + b"\t".join(p.encode() for p in ins)]
    for m in metrics:
        rows.append(m + b"\t" + b"\t".join(table[m]))
    blob = b"\n".join(rows) + b"\n"
    if out1:
        with open_output(out1) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return table


def invertkey(argv=None):
    """invertkey.sh — swap the key and value columns of a TSV."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    n = 0
    with open_input(in1) as src, open_output(out1) as dst:
        for line in src:
            line = line.rstrip(b"\n")
            if not line or line.startswith(b"#"):
                dst.write(line + b"\n")
                continue
            f = line.split(b"\t")
            if len(f) >= 2:
                f[0], f[1] = f[1], f[0]
            dst.write(b"\t".join(f) + b"\n")
            n += 1
    print(f"Inverted {n} lines.", file=sys.stderr)
    return n


def bam2sam(argv=None):
    """bamlinestreamer.sh / streamsam.sh (bam/Bam2Sam role) — decode a
    BAM to SAM text via the native BGZF/BAM reader."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    from ..io.bam import read_bam

    it = read_bam(in1)
    header_text, refs = next(it)
    n = 0
    with open_output(out1) as fh:
        if header_text:
            fh.write(header_text)
        for rec in it:
            fh.write(
                b"%s\t%d\t%s\t%d\t%d\t%s\t*\t0\t0\t%s\t%s\n"
                % (
                    rec.qname, rec.flag, rec.rname, rec.pos, rec.mapq,
                    rec.cigar.encode(), rec.seq, rec.qual,
                )
            )
            n += 1
    print(f"Wrote {n} alignments.", file=sys.stderr)
    return n
