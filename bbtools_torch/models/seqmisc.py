"""Misc sequence/SAM/interval tools (jgi/var2/bin/barcode long tail).

Reference mains:
  - adjusthomopolymers.sh -> jgi.AdjustHomopolymers: expand (rate>0) or
    contract (rate<0) each homopolymer run by int(rate*runlen) bases,
    copying the run's quality (AdjustHomopolymers.java:430-460).
  - restorebases.sh -> var2.RestoreBases: copy SEQ/QUAL from the primary
    alignment onto secondary (0x100)/supplementary (0x800) records of
    the same read name (SEQ=* from minimap2 etc.), reverse-complementing
    when strands differ (RestoreBases.java:1-20).
  - representative.sh -> jgi.RepresentativeSet: from an edge list
    {a, b, dist[, sizeratio]}, greedily retain nodes so every node is
    within `thresh` of a representative (RepresentativeSet.java:1-12).
  - bedset.sh -> var2.BedSet: union/intersection/subtract of BED files
    via one linear depth sweep over merged intervals (BedSet.java:1-20).
  - tagandmerge.sh -> barcode.TagAndMerge: merge demux files, appending
    the barcode parsed from each FILENAME to read headers.
  - processhi-c.sh -> jgi.FindHiCJunctions: junction detection from
    soft-clipped alignments; emits clip-point k-mer profile.
  - synthmda.sh -> synth.SynthMDA: simulate MDA amplification by
    iterative biased random-fragment sampling of a reference.
  - kmercountshort.sh -> jgi.KmerCountShort: dense count array for
    short k (<=12), dumped as kmer\\tcount rows.
  - kmerhashdump.sh -> jgi.KmerHashDump: per-kmer hash64shift codes,
    one per line (anonymized hash stream for cardinality work).
  - estherfilter.sh -> driver.EstherFilter: filter sequences by BLAST
    tabular score cutoff (runs blastall only if present; also accepts a
    pre-computed tabular file).
  - renameref.sh -> jgi.RefRenamer: rename references in FASTA/SAM/VCF/
    GFF via a 2-column map.
  - renamebymapping.sh -> bin.ContigRenamer: append cov_# (and tid_#)
    to contig names from a SAM's coverage.
  - renamecami.sh -> bin.RenameCAMI: append _tid_TAXID to contigs from
    a CAMI binning_gs.tsv key.
  - renameimg.sh -> tax.RenameIMG: prefix headers with tid|<taxid>| from
    an IMG taxonomy dump.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core.parser import parse_boolean, tokenize


# ----------------------------------------------------------------------
# adjusthomopolymers
# ----------------------------------------------------------------------


def _adjust_read(seq: bytes, qual: bytes, rate: float):
    out_b = bytearray()
    out_q = bytearray()
    prev = -1
    prev_q = 20
    streak = 0

    def flush():
        nonlocal out_b, out_q
        adj = int(rate * streak) if prev in b"ACGT" else 0
        if adj < 0:
            del out_b[len(out_b) + adj:]
            del out_q[len(out_q) + adj:]
        else:
            out_b.extend([prev] * adj)
            out_q.extend([prev_q] * adj)

    for i, b in enumerate(seq):
        out_b.append(b)
        out_q.append(qual[i] if i < len(qual) else 20)
        if b == prev:
            streak += 1
        else:
            if prev >= 0:
                flush()
            streak = 1
        prev = b
        prev_q = qual[i] if i < len(qual) else 20
    if prev >= 0:
        flush()
    return bytes(out_b), bytes(out_q)


def adjusthomopolymers_main(args):
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out", "out1")
    rate = float(a.get("rate", default="0"))
    if not inpath or not out or rate == 0:
        print("Usage: adjusthomopolymers in=<reads> out=<reads> rate=0.1"
              " (positive expands, negative contracts)", file=sys.stderr)
        return 1
    from ..io.fastq import FastqReader, FastqWriter
    from ..io.batch import ReadBatch

    w = FastqWriter(out)
    n = 0
    for batch in FastqReader(inpath):
        seqs, quals, ids = [], [], []
        for i in range(batch.n):
            s = batch.sequence(i)
            q = batch.quality_string(i)
            s2, q2 = _adjust_read(s, q, rate)
            seqs.append(s2)
            quals.append(q2)
            ids.append(batch.ids[i])
        nb = ReadBatch.from_sequences(seqs, quals, ids=ids,
                                      ordinal=batch.ordinal)
        w.add(nb)
        n += batch.n
    w.close()
    print(f"Adjusted {n} reads.", file=sys.stderr)
    return 0


# ----------------------------------------------------------------------
# restorebases
# ----------------------------------------------------------------------


def restorebases_main(args):
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out", "out1")
    if not inpath or not out:
        print("Usage: restorebases in=<sam> out=<sam>", file=sys.stderr)
        return 1
    from ..core.dna import reverse_complement
    from ..io.readwrite import open_output, read_bytes

    # pass 1: primary SEQ/QUAL per qname (flag without 0x100/0x800)
    primary: dict[bytes, tuple[bytes, bytes, int]] = {}
    lines = read_bytes(inpath).split(b"\n")
    for ln in lines:
        if not ln or ln.startswith(b"@"):
            continue
        f = ln.split(b"\t")
        flag = int(f[1])
        if flag & 0x900 or f[9] == b"*":
            continue
        primary[f[0] + b"/%d" % (flag & 0xC0)] = (f[9], f[10], flag)
    restored = 0
    with open_output(out) as fh:
        for ln in lines:
            if not ln:
                continue
            if ln.startswith(b"@"):
                fh.write(ln + b"\n")
                continue
            f = ln.split(b"\t")
            flag = int(f[1])
            if flag & 0x900 and f[9] == b"*":
                key = f[0] + b"/%d" % (flag & 0xC0)
                rec = primary.get(key)
                if rec is not None:
                    seq, qual, pflag = rec
                    if (flag ^ pflag) & 0x10:  # strand differs
                        seq = reverse_complement(seq)
                        qual = qual[::-1] if qual != b"*" else qual
                    f[9], f[10] = seq, qual
                    restored += 1
            fh.write(b"\t".join(f) + b"\n")
    print(f"Restored {restored} records.", file=sys.stderr)
    return 0


# ----------------------------------------------------------------------
# representative / bedset
# ----------------------------------------------------------------------


def representative_main(args):
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out", "out1")
    if not inpath:
        print("Usage: representative in=<edges.tsv> out=<list>"
              " [thresh=0.02] (rows: a b dist [sizeratio])",
              file=sys.stderr)
        return 1
    thresh = float(a.get("thresh", "threshold", "minid", "id", "ani",
                         default="0.02"))
    if thresh > 1:
        thresh = 1 - thresh / 100  # minani=98 -> dist 0.02
    from ..io.readwrite import read_bytes

    edges: dict[bytes, list[tuple[bytes, float]]] = {}
    nodes: list[bytes] = []
    seen = set()
    for ln in read_bytes(inpath).split(b"\n"):
        if not ln.strip() or ln.startswith(b"#"):
            continue
        f = ln.split(b"\t")
        u, v, d = f[0], f[1], float(f[2])
        for x in (u, v):
            if x not in seen:
                seen.add(x)
                nodes.append(x)
        edges.setdefault(u, []).append((v, d))
        edges.setdefault(v, []).append((u, d))
    # greedy: highest-degree-under-threshold first
    degree = {u: sum(1 for _, d in vs if d <= thresh)
              for u, vs in edges.items()}
    order = sorted(nodes, key=lambda u: -degree.get(u, 0))
    covered: set[bytes] = set()
    reps = []
    for u in order:
        if u in covered:
            continue
        reps.append(u)
        covered.add(u)
        for v, d in edges.get(u, ()):
            if d <= thresh:
                covered.add(v)
    text = b"\n".join(reps) + b"\n"
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text)
    else:
        sys.stdout.buffer.write(text)
    print(f"{len(reps)} representatives cover {len(covered)}/{len(nodes)}"
          f" nodes at dist<={thresh}.", file=sys.stderr)
    return 0


def _load_bed(path):
    from ..io.readwrite import read_bytes

    iv: dict[bytes, list[tuple[int, int]]] = {}
    for ln in read_bytes(path).split(b"\n"):
        if not ln.strip() or ln.startswith((b"#", b"track", b"browser")):
            continue
        f = ln.split(b"\t")
        iv.setdefault(f[0], []).append((int(f[1]), int(f[2])))
    # sort+merge per scaffold
    for k, lst in iv.items():
        lst.sort()
        merged = []
        for s, e in lst:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        iv[k] = merged
    return iv


def bedset_main(args):
    a = tokenize(args)
    ins = [p for p in (a.get("in", "in1") or "").split(",") if p]
    if len(ins) < 2:
        print("Usage: bedset in=a.bed,b.bed,... out=<bed>"
              " [mode=union|intersection|subtract]", file=sys.stderr)
        return 1
    mode = a.get("mode", default="union").lower()
    beds = [_load_bed(p) for p in ins]
    scafs = sorted({k for b in beds for k in b})
    out_rows = []
    stats = [0] * len(beds)
    for scaf in scafs:
        events = []  # (pos, +1/-1, input_idx)
        for bi, b in enumerate(beds):
            for s, e in b.get(scaf, ()):
                stats[bi] += e - s
                events.append((s, 1, bi))
                events.append((e, -1, bi))
        events.sort()
        depth = 0
        first_depth = 0
        start = None
        for pos, delta, bi in events:
            nd = depth + delta
            nfd = first_depth + (delta if bi == 0 else 0)
            if mode == "union":
                want_old, want_new = depth >= 1, nd >= 1
            elif mode in ("intersection", "intersect"):
                want_old, want_new = depth == len(beds), nd == len(beds)
            else:  # subtract: file0 minus the rest
                want_old = first_depth >= 1 and depth == first_depth
                want_new = nfd >= 1 and nd == nfd
            if not want_old and want_new:
                start = pos
            elif want_old and not want_new and start is not None:
                if pos > start:
                    out_rows.append(b"%s\t%d\t%d" % (scaf, start, pos))
                start = None
            depth, first_depth = nd, nfd
    out = a.get("out", "out1")
    covered = sum(int(r.split(b"\t")[2]) - int(r.split(b"\t")[1])
                  for r in out_rows)
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(b"\n".join(out_rows) + b"\n" if out_rows else b"")
    for bi, p in enumerate(ins):
        print(f"{p}: {stats[bi]} bp", file=sys.stderr)
    print(f"{mode}: {covered} bp in {len(out_rows)} intervals.",
          file=sys.stderr)
    return 0


# ----------------------------------------------------------------------
# tagandmerge / processhi-c / synthmda
# ----------------------------------------------------------------------


def tagandmerge_main(args):
    a = tokenize(args)
    ins = [p for p in (a.get("in", "in1") or "").split(",") if p]
    out = a.get("out", "out1")
    if not ins or not out:
        print("Usage: tagandmerge in=<demux files,comma> out=<merged.fq>"
              " (barcode parsed from each filename)", file=sys.stderr)
        return 1
    import re

    from ..io.fastq import FastqReader, FastqWriter

    w = FastqWriter(out)
    n = 0
    ordinal = 0
    for path in ins:
        base = os.path.basename(path)
        m = re.search(r"([ACGTN]{4,})(?:[-+]([ACGTN]{4,}))?", base)
        tag = b""
        if m:
            tag = m.group(1).encode()
            if m.group(2):
                tag += b"+" + m.group(2).encode()
        for batch in FastqReader(path):
            if tag:
                batch.ids = [i + b"\t" + tag for i in batch.ids]
            batch.ordinal = ordinal
            ordinal += 1
            w.add(batch)
            n += batch.n
    w.close()
    print(f"Merged {n} reads from {len(ins)} files.", file=sys.stderr)
    return 0


def hic_junctions_main(args):
    """processhi-c.sh: extract clip-junction kmers from soft-clipped
    alignments (FindHiCJunctions role)."""
    a = tokenize(args)
    inpath = a.get("in", "in1")
    if not inpath:
        print("Usage: processhi-c in=<sam> [out=<junction kmers tsv>]"
              " [k=8] [minclip=20]", file=sys.stderr)
        return 1
    k = int(a.get("k", default="8"))
    minclip = int(a.get("minclip", default="20"))
    from ..io.sam_read import iter_sam

    counts: dict[bytes, int] = {}
    njunc = 0
    for rec in iter_sam(inpath):
        if rec.seq == b"*" or rec.flag & 0x4:
            continue
        cig = rec.cigar
        # leading/trailing soft clips
        import re

        m = re.match(r"^(\d+)S", cig)
        clips = []
        if m and int(m.group(1)) >= minclip:
            clips.append(int(m.group(1)))  # junction at clip boundary
        m = re.search(r"(\d+)S$", cig)
        if m and int(m.group(1)) >= minclip:
            clips.append(len(rec.seq) - int(m.group(1)))
        for cpos in clips:
            njunc += 1
            lo = max(0, cpos - k // 2)
            kmer = rec.seq[lo: lo + k]
            if len(kmer) == k:
                counts[kmer] = counts.get(kmer, 0) + 1
    rows = sorted(counts.items(), key=lambda t: -t[1])
    out = a.get("out", "out1")
    text = b"".join(b"%s\t%d\n" % (km, c) for km, c in rows)
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text)
    else:
        sys.stdout.buffer.write(text[:2000])
    print(f"{njunc} junctions, {len(rows)} distinct {k}-mers.",
          file=sys.stderr)
    return 0


def synthmda_main(args):
    """synthmda.sh: MDA amplification bias simulator — iterative biased
    fragment resampling of a reference (SynthMDA role)."""
    a = tokenize(args)
    ref, out = a.get("ref", "in"), a.get("out", "out1")
    if not ref or not out:
        print("Usage: synthmda ref=<fa> out=<amplified.fa> [cycles=9]"
              " [minfrag=10000] [depth=10] [seed=1]", file=sys.stderr)
        return 1
    cycles = int(a.get("cycles", default="9"))
    minfrag = int(a.get("minlen", "minfrag", default="10000"))
    target = float(a.get("depth", "fold", default="10"))
    rng = np.random.default_rng(int(a.get("seed", default="1")))
    from ..io.fasta import load_reference
    from ..io.readwrite import open_output
    from ..core.dna import decode

    r = load_reference(ref)
    pool = [r.codes[: max(1, len(r.codes) - 1)]]  # strip scaffold sentinel
    total = len(pool[0])
    goal = total * target
    frags = []
    amplified = 0
    while amplified < goal:
        # MDA bias: newer fragments are more likely to be re-amplified
        weights = np.arange(1, len(pool) + 1, dtype=np.float64)
        weights /= weights.sum()
        src = pool[int(rng.choice(len(pool), p=weights))]
        if len(src) <= minfrag:
            frag = src
        else:
            flen = int(rng.integers(minfrag, min(len(src), minfrag * 10) + 1))
            start = int(rng.integers(0, len(src) - flen + 1))
            frag = src[start: start + flen]
        pool.append(frag)
        if len(pool) > cycles * 8:
            pool = pool[-cycles * 8:]
        frags.append(frag)
        amplified += len(frag)
    with open_output(out) as fh:
        for i, f in enumerate(frags):
            fh.write(b">mda_%d len=%d\n%s\n" % (i, len(f), decode(f)))
    print(f"Amplified {total} bp -> {amplified} bp in {len(frags)}"
          f" fragments.", file=sys.stderr)
    return 0


# ----------------------------------------------------------------------
# kmercountshort / kmerhashdump
# ----------------------------------------------------------------------


def kmercountshort_main(args):
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get(
        "out", "out1", "outkmers", "outk", "dump")
    k = int(a.get("k", default="8"))
    if not inpath or k > 12:
        print("Usage: kmercountshort in=<reads> out=<tsv> k=<1..12>"
              " [skip=1]", file=sys.stderr)
        return 1
    skip = int(a.get("skip", default="1"))
    from ..io.fastq import FastqReader
    from ..ops.kmers import rolling_kmers_np
    from ..core.dna import kmer_to_text

    counts = np.zeros(1 << (2 * k), np.int64)
    for batch in FastqReader(inpath):
        fwd, _, runlen = rolling_kmers_np(batch.bases, k)
        valid = (runlen >= k) & (
            np.arange(batch.bases.shape[1])[None, :] < batch.lengths[:, None])
        if skip > 1:
            stride = np.zeros_like(valid)
            stride[:, ::skip] = True
            valid &= stride
        counts += np.bincount(fwd[valid], minlength=1 << (2 * k))
    rows = np.nonzero(counts)[0]
    text = "".join(f"{kmer_to_text(int(km), k)}\t{int(counts[km])}\n"
                   for km in rows)
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text.encode())
    else:
        sys.stdout.write(text)
    print(f"{len(rows)} distinct {k}-mers, {int(counts.sum())} total.",
          file=sys.stderr)
    return 0


def _hash64shift(x: np.ndarray) -> np.ndarray:
    """Tools.hash64shift (Thomas Wang's 64-bit mix), vectorized."""
    x = x.astype(np.uint64)
    x = (~x) + (x << np.uint64(21))
    x ^= x >> np.uint64(24)
    x = x + (x << np.uint64(3)) + (x << np.uint64(8))
    x ^= x >> np.uint64(14)
    x = x + (x << np.uint64(2)) + (x << np.uint64(4))
    x ^= x >> np.uint64(28)
    x = x + (x << np.uint64(31))
    return x


def kmerhashdump_main(args):
    a = tokenize(args)
    inpath, out = a.get("in", "in1"), a.get("out", "out1")
    k = int(a.get("k", default="31"))
    if not inpath:
        print("Usage: kmerhashdump in=<reads> out=<hashes.txt> [k=31]",
              file=sys.stderr)
        return 1
    from ..io.fastq import FastqReader
    from ..ops.kmers import rolling_kmers_np

    chunks = []
    for batch in FastqReader(inpath):
        fwd, _, runlen = rolling_kmers_np(batch.bases, k)
        valid = (runlen >= k) & (
            np.arange(batch.bases.shape[1])[None, :] < batch.lengths[:, None])
        chunks.append(_hash64shift(fwd[valid]))
    hashes = (np.concatenate(chunks) if chunks
              else np.zeros(0, np.uint64))
    text = "\n".join(str(int(h)) for h in hashes) + ("\n" if len(hashes)
                                                     else "")
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text.encode())
    else:
        sys.stdout.write(text[:2000])
    print(f"Dumped {len(hashes)} kmer hashes (content unrecoverable).",
          file=sys.stderr)
    return 0


# ----------------------------------------------------------------------
# estherfilter
# ----------------------------------------------------------------------


def estherfilter_main(args):
    """estherfilter.sh: filter query sequences by BLAST tabular score.
    Accepts blast=<precomputed -m8/-outfmt6 file>; running blastall
    itself requires BLAST on the PATH (same as the reference)."""
    a = tokenize(args)
    query = a.get("query", "in")
    table = a.get("blast", "table")
    cutoff = float(a.get("cutoff", "minscore", default="100"))
    fasta_out = parse_boolean(a.get("fasta", default="t"))
    if not table:
        import shutil

        if shutil.which("blastall") is None and shutil.which(
                "blastn") is None:
            print("estherfilter needs either blast=<tabular results> or a"
                  " BLAST binary on the PATH (not bundled).",
                  file=sys.stderr)
            return 1
    from ..io.readwrite import read_bytes

    keep = set()
    for ln in read_bytes(table).split(b"\n"):
        if not ln.strip():
            continue
        f = ln.split(b"\t")
        if len(f) >= 12 and float(f[11]) >= cutoff:
            keep.add(f[0])
    out = a.get("out", "out1")
    lines = []
    if query and fasta_out:
        from ..io.fasta import iter_fasta

        for rec in iter_fasta(query):
            if rec.name.split()[0] in keep:
                lines.append(b">" + rec.name + b"\n" + rec.seq)
    else:
        lines = sorted(keep)
    text = b"\n".join(lines) + (b"\n" if lines else b"")
    if out:
        from ..io.readwrite import open_output

        with open_output(out) as fh:
            fh.write(text)
    else:
        sys.stdout.buffer.write(text)
    print(f"Kept {len(keep)} queries at score>={cutoff}.", file=sys.stderr)
    return 0


# ----------------------------------------------------------------------
# renamers
# ----------------------------------------------------------------------


def _load_map(path, sep=b"\t"):
    from ..io.readwrite import read_bytes

    out = {}
    for ln in read_bytes(path).split(b"\n"):
        if not ln.strip() or ln.startswith(b"#"):
            continue
        f = ln.split(sep)
        if len(f) >= 2:
            out[f[0]] = f[1]
    return out


def renameref_main(args):
    a = tokenize(args)
    inpath, out, mp = a.get("in", "in1"), a.get("out", "out1"), a.get(
        "map", "names", "table")
    if not inpath or not out or not mp:
        print("Usage: renameref in=<fa|sam|vcf|gff> out=<same> map=<tsv>",
              file=sys.stderr)
        return 1
    table = _load_map(mp)
    from ..io.readwrite import open_output, read_bytes

    renamed = 0
    with open_output(out) as fh:
        for ln in read_bytes(inpath).split(b"\n"):
            if not ln:
                continue
            if ln.startswith(b">"):
                key = ln[1:].split()[0]
                new = table.get(key)
                if new is not None:
                    ln = b">" + new + ln[1 + len(key):]
                    renamed += 1
            elif ln.startswith(b"@SQ"):
                f = ln.split(b"\t")
                for i, t in enumerate(f):
                    if t.startswith(b"SN:") and t[3:] in table:
                        f[i] = b"SN:" + table[t[3:]]
                        renamed += 1
                ln = b"\t".join(f)
            elif not ln.startswith((b"@", b"#")):
                f = ln.split(b"\t")
                # SAM col 2 (RNAME) / VCF+GFF col 0
                if len(f) > 2 and f[2] in table:
                    f[2] = table[f[2]]
                    renamed += 1
                elif f[0] in table:
                    f[0] = table[f[0]]
                    renamed += 1
                ln = b"\t".join(f)
            fh.write(ln + b"\n")
    print(f"Renamed {renamed} records/fields.", file=sys.stderr)
    return 0


def renamebymapping_main(args):
    """renamebymapping.sh -> bin.ContigRenamer: append cov_<depth> (and
    tid_<taxid> from read headers) to contig names."""
    a = tokenize(args)
    contigs, sam, out = a.get("in", "ref"), a.get("sam"), a.get("out")
    if not contigs or not sam or not out:
        print("Usage: renamebymapping in=<contigs.fa> sam=<mapped.sam>"
              " out=<renamed.fa>", file=sys.stderr)
        return 1
    from ..io.sam_read import iter_sam
    from ..models.ssutools import _tid_of

    cov: dict[bytes, int] = {}
    tids: dict[bytes, dict[int, int]] = {}
    for rec in iter_sam(sam):
        if rec.flag & 0x4 or rec.rname == b"*":
            continue
        cov[rec.rname] = cov.get(rec.rname, 0) + (
            len(rec.seq) if rec.seq != b"*" else 0)
        t = _tid_of(rec.qname)
        if t > 0:
            tids.setdefault(rec.rname, {})
            tids[rec.rname][t] = tids[rec.rname].get(t, 0) + 1
    from ..io.fasta import iter_fasta
    from ..io.readwrite import open_output

    n = 0
    with open_output(out) as fh:
        for rec in iter_fasta(contigs):
            key = rec.name.split()[0]
            depth = cov.get(key, 0) / max(len(rec.seq), 1)
            name = rec.name + b",cov_%.3f" % depth
            best = tids.get(key)
            if best and b"tid_" not in rec.name:
                top = max(best.items(), key=lambda t: t[1])[0]
                name += b",tid_%d" % top
            fh.write(b">" + name + b"\n" + rec.seq + b"\n")
            n += 1
    print(f"Renamed {n} contigs.", file=sys.stderr)
    return 0


def renamecami_main(args):
    a = tokenize(args)
    inpath, key, out = a.get("in", "in1"), a.get("key"), a.get("out")
    if not inpath or not key or not out:
        print("Usage: renamecami in=<contigs.fa> key=<binning_gs.tsv>"
              " out=<renamed.fa>", file=sys.stderr)
        return 1
    table = _load_map(key)
    from ..io.fasta import iter_fasta
    from ..io.readwrite import open_output

    n = 0
    with open_output(out) as fh:
        for rec in iter_fasta(inpath):
            k = rec.name.split()[0]
            tid = table.get(k)
            name = rec.name + (b"_tid_" + tid if tid else b"")
            n += tid is not None
            fh.write(b">" + name + b"\n" + rec.seq + b"\n")
    print(f"Tagged {n} contigs with taxIDs.", file=sys.stderr)
    return 0


def renameimg_main(args):
    a = tokenize(args)
    inpath, img, out = a.get("in", "in1"), a.get("img", "map", "table"), \
        a.get("out")
    if not inpath or not img or not out:
        print("Usage: renameimg in=<fa> img=<imgmap tsv: imgID taxID>"
              " out=<fa>", file=sys.stderr)
        return 1
    table = _load_map(img)
    from ..io.fasta import iter_fasta
    from ..io.readwrite import open_output

    n = 0
    with open_output(out) as fh:
        for rec in iter_fasta(inpath):
            k = rec.name.split()[0]
            tid = table.get(k)
            name = (b"tid|" + tid + b"|" + rec.name) if tid else rec.name
            n += tid is not None
            fh.write(b">" + name + b"\n" + rec.seq + b"\n")
    print(f"Tagged {n} records.", file=sys.stderr)
    return 0


def renamebysketch_main(args):
    """renamebysketch.sh -> bin.FileRenamer: propose new filenames from
    each file's top sketch hit against ref= genomes; renames with
    rename=t, else prints the mapping."""
    a = tokenize(args)
    ins = [p for p in (a.get("in", "in1") or "").split(",") if p]
    refs = [p for p in (a.get("ref") or "").split(",") if p]
    if not ins or not refs:
        print("Usage: renamebysketch in=<fa,...> ref=<fa,...> [rename=f]",
              file=sys.stderr)
        return 1
    do_rename = parse_boolean(a.get("rename", default="f"))
    from .sketch import compare_sketches, sketch_file

    ref_sk = [(os.path.basename(p), sketch_file(p)) for p in refs]
    for p in ins:
        q = sketch_file(p)
        best_name, best_score = None, -1.0
        for name, s in ref_sk:
            wkid, ani, _, _ = compare_sketches(q, s)
            if ani > best_score:
                best_name, best_score = name, ani
        stem = best_name.rsplit(".", 1)[0]
        new = os.path.join(os.path.dirname(p) or ".",
                           stem + "_" + os.path.basename(p))
        print(f"{p}\t{new}\tani~{best_score:.4f}")
        if do_rename:
            os.rename(p, new)
    return 0
