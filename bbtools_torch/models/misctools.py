"""Miscellaneous stream tools: countduplicates, commonkmers,
kmerposition, mergebarcodes, removesmartbell, filtersubs, kmercoverage,
consect, mergeotus, mergefastacontigs, partitionfastafile.

The port of bbtools_tpu/models/misctools.py. Every tool but kmercoverage
is the JAX package's host code, copied. kmercoverage (jgi/KmerCoverage.java,
kmercoverage.sh) annotates each read header with its k-mer depth
(min/avg) from a count-min sketch built over the input (+extra=), and
writes a depth histogram. The sketch lives on the run's device
(`device=`, cuda by default; ops/cms.py, 2 hashes), as are the k-mers
(`ops/kmer_count.read_keys_t`; the JAX package rolls them in host
numpy). The JAX package queries the sketch once a read; the port queries
a batch's valid k-mers in one call and splits the estimates by read, so
each read's min and mean come from its own int64 slice in the same
order.

References (semantics source, no code reuse):
  - jgi/CountDuplicates.java (countduplicates.sh) — probabilistic
    duplicate counting: each read (pair) is reduced to a 64-bit
    hashcode over bases (+names/quals optionally); only hashcodes are
    stored. maxfraction=/maxrate= fail gates with failcode=.
  - jgi/CommonKmers.java (commonkmers.sh) — per-sequence most common
    k<=12 kmers, `name\tkmer=count,...` rows (count=t), top display=.
  - jgi/KmerPosition.java (kmerposition.sh) — positional histogram of
    reference-kmer hits in reads.
  - jgi/MergeBarcodes.java (mergebarcodes.sh) — append the barcode
    read's bases (+ qualities) onto each read's name.
  - pacbio/RemoveAdapters2.java (removesmartbell.sh) — locate SMRTbell
    adapters by alignment and split (split=t) or X-mask them.
  - driver/FilterReadsWithSubs.java (filtersubs.sh) — keep aligned
    reads carrying substitutions whose base quality lies in
    [minq, maxq]; countindels= includes indels as qualifying events.
"""

from __future__ import annotations

import sys
import zlib

import numpy as np

from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fastq import FastqReader, FastqWriter, paired_reader
from ..io.readwrite import open_input, open_output

SMRTBELL = b"ATCTCTCTCTTTTCCTCCTCCTCCGTTGTTGTTGTTGAGAGAGAT"


def countduplicates(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1, in2 = a.get("in", "in1"), a.get("in2")
    out1 = a.get("out", "out1")
    outd = a.get("outd")
    use_bases = a.get_bool("bases", default=True)
    use_names = a.get_bool("names", default=False)
    use_quals = a.get_bool("qualities", default=False)
    maxfraction = a.get_float("maxfraction", default=-1.0)
    maxrate = a.get_float("maxrate", default=-1.0)
    failcode = a.get_int("failcode", default=0)
    samplerate = a.get_float("samplerate", default=1.0)

    counts: dict[int, int] = {}
    kept_recs = 0

    w1 = FastqWriter(out1) if out1 else None
    wd = open_output(outd) if outd else None
    d_headers_only = bool(outd) and outd.endswith((".txt", ".txt.gz"))

    def hashcode(recs) -> int:
        h = 0
        for name, seq, qual in recs:
            parts = []
            if use_bases:
                parts.append(seq)
            if use_names:
                parts.append(name)
            if use_quals:
                parts.append(qual)
            blob = b"\0".join(parts)
            h = (h * 1000003) ^ zlib.crc32(blob) ^ (
                zlib.adler32(blob) << 32
            )
        return h & (2**64 - 1)

    total = dup_reads = 0
    for b1, b2 in paired_reader(in1, in2):
        keep_mask = np.ones(b1.n, dtype=bool)
        dup_mask = np.zeros(b1.n, dtype=bool)
        for i in range(b1.n):
            recs = [(b1.ids[i], b1.sequence(i), b1.quality_string(i))]
            if b2 is not None and i < b2.n:
                recs.append((b2.ids[i], b2.sequence(i), b2.quality_string(i)))
            h = hashcode(recs)
            if samplerate < 1.0:
                # deterministic sampling: same hash -> same decision
                if (h % 10_000) >= samplerate * 10_000:
                    keep_mask[i] = False
                    continue
            total += 1
            c = counts.get(h, 0)
            counts[h] = c + 1
            if c:
                dup_reads += 1
                dup_mask[i] = True
                keep_mask[i] = False
                if wd:
                    for name, seq, qual in recs:
                        if d_headers_only:
                            wd.write(name + b"\n")
                        else:
                            wd.write(b"@%s\n%s\n+\n%s\n" % (name, seq, qual))
        if w1:
            w1.add(b1, keep_mask)
            kept_recs += int(keep_mask.sum())
    if w1:
        w1.close()
    if wd:
        wd.close()
    uniques = len(counts)
    fraction = dup_reads / max(total, 1)
    rate = total / max(uniques, 1)
    print(
        f"Reads (pairs counted once): {total}\nUnique: {uniques}\n"
        f"Duplicates: {dup_reads}\nDuplicate fraction: {fraction:.5f}\n"
        f"Average copies: {rate:.5f}",
        file=sys.stderr,
    )
    failed = (0 <= maxfraction < fraction) or (1 <= maxrate < rate)
    if failed:
        print("Input FAILED duplicate gate.", file=sys.stderr)
        if failcode:
            sys.exit(failcode)
    return total, uniques, dup_reads


def commonkmers(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    k = a.get_int("k", default=2)
    if k > 12:
        raise ValueError("commonkmers: k must be 0-12")
    display = a.get_int("display", default=3)
    print_count = a.get_bool("count", default=True)
    lines = []
    for b in FastqReader(in1):
        for i in range(b.n):
            L = int(b.lengths[i])
            codes = b.bases[i, :L].astype(np.int64)
            if L < k:
                lines.append(b.ids[i] + b"\n")
                continue
            wins = np.lib.stride_tricks.sliding_window_view(codes, k)
            ok = (wins < 4).all(1)
            vals = (wins * (4 ** np.arange(k - 1, -1, -1))).sum(1)[ok]
            cnt = np.bincount(vals, minlength=4**k)
            order = np.argsort(-cnt, kind="stable")[:display]
            parts = []
            for v in order:
                if cnt[v] == 0:
                    break
                km = bytes(
                    b"ACGT"[(int(v) >> (2 * (k - 1 - j))) & 3]
                    for j in range(k)
                )
                parts.append(
                    b"%s=%d" % (km, cnt[v]) if print_count else km
                )
            lines.append(b.ids[i] + b"\t" + b",".join(parts) + b"\n")
    if out1:
        with open_output(out1) as fh:
            fh.writelines(lines)
    return lines


def _seq_batches(path: str):
    """Batches from fasta or fastq input."""
    from ..io.fasta import fasta_to_batch
    from ..io.fileformat import Format, test_input

    if test_input(path).format == Format.FASTA:
        yield fasta_to_batch(path)
        return
    yield from FastqReader(path)


def kmerposition(argv=None):
    from ..ops.kmers import canonical_keys_np, rolling_kmers_np

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    ref = a.get("ref")
    k = a.get_int("k", default=20)

    refkeys: set[int] = set()
    for b in _seq_batches(ref):
        fwd, rkm, runlen = rolling_kmers_np(b.bases, k)
        keys = canonical_keys_np(fwd, rkm, k)
        valid = (runlen >= k) & (
            np.arange(b.padded_len)[None, :] < b.lengths[:, None]
        )
        refkeys.update(int(x) for x in keys[valid])

    maxlen = 0
    hist = np.zeros(1024, dtype=np.int64)
    reads_hist = np.zeros(1024, dtype=np.int64)
    for b in FastqReader(in1):
        fwd, rkm, runlen = rolling_kmers_np(b.bases, k)
        keys = canonical_keys_np(fwd, rkm, k)
        valid = (runlen >= k) & (
            np.arange(b.padded_len)[None, :] < b.lengths[:, None]
        )
        for i in range(b.n):
            L = int(b.lengths[i])
            maxlen = max(maxlen, L)
            if L >= hist.shape[0]:
                grow = np.zeros(L + 1024, dtype=np.int64)
                grow[: hist.shape[0]] = hist
                hist = grow
                grow2 = np.zeros(L + 1024, dtype=np.int64)
                grow2[: reads_hist.shape[0]] = reads_hist
                reads_hist = grow2
            reads_hist[:L] += 1
            for j in np.nonzero(valid[i])[0]:
                if int(keys[i, j]) in refkeys:
                    # position of the kmer START (j is its last base)
                    hist[j - k + 1] += 1
    lines = [b"#pos\tcount\tfraction\n"]
    for p in range(max(maxlen - k + 1, 0)):
        denom = max(int(reads_hist[p]), 1)
        lines.append(
            b"%d\t%d\t%.5f\n" % (p, int(hist[p]), hist[p] / denom)
        )
    if out1:
        with open_output(out1) as fh:
            fh.writelines(lines)
    return hist[: max(maxlen - k + 1, 0)]


def mergebarcodes(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    bar = a.get("barcode", "bar")
    out1 = a.get("out", "out1")

    def recs(path):
        for b in FastqReader(path):
            for i in range(b.n):
                yield b.ids[i], b.sequence(i), b.quality_string(i)

    n = 0
    with open_output(out1) as fh:
        for (name, seq, qual), (_bn, bseq, bqual) in zip(
            recs(in1), recs(bar)
        ):
            newname = name + b"_" + bseq + b"_" + bqual
            fh.write(b"@%s\n%s\n+\n%s\n" % (newname, seq, qual))
            n += 1
    print(f"Merged barcodes onto {n} reads.", file=sys.stderr)
    return n


def _find_adapter(seq: bytes, adapter: bytes, max_sub_frac: float = 0.25):
    """Best sliding-window placements of the adapter with at most
    max_sub_frac mismatches; returns sorted non-overlapping hit starts."""
    L, A = len(seq), len(adapter)
    if L < A:
        return []
    s = np.frombuffer(seq, dtype=np.uint8)
    ad = np.frombuffer(adapter, dtype=np.uint8)
    wins = np.lib.stride_tricks.sliding_window_view(s, A)
    mm = (wins != ad[None, :]).sum(1)
    limit = int(A * max_sub_frac)
    hits = np.nonzero(mm <= limit)[0]
    out = []
    last = -A
    for h in hits:
        if h >= last + A:
            out.append(int(h))
            last = int(h)
    return out


def removesmartbell(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    adapter = (a.get("adapter") or SMRTBELL.decode()).upper().encode()
    split = a.get_bool("split", default=True)
    found = reads = 0
    with open_output(out1) as fh:
        for b in FastqReader(in1):
            for i in range(b.n):
                reads += 1
                seq = b.sequence(i)
                qual = b.quality_string(i) or b"I" * len(seq)
                hits = _find_adapter(seq, adapter)
                if not hits:
                    fh.write(b"@%s\n%s\n+\n%s\n" % (b.ids[i], seq, qual))
                    continue
                found += len(hits)
                if split:
                    cur = 0
                    part = 1
                    for h in hits + [None]:
                        end = h if h is not None else len(seq)
                        if end - cur > 0:
                            fh.write(
                                b"@%s_part%d\n%s\n+\n%s\n"
                                % (
                                    b.ids[i], part, seq[cur:end],
                                    qual[cur:end],
                                )
                            )
                            part += 1
                        if h is not None:
                            cur = h + len(adapter)
                else:
                    sq = bytearray(seq)
                    for h in hits:
                        sq[h : h + len(adapter)] = b"X" * len(adapter)
                    fh.write(b"@%s\n%s\n+\n%s\n" % (b.ids[i], bytes(sq), qual))
    print(
        f"Reads: {reads}  Adapters found: {found}", file=sys.stderr
    )
    return found


def filtersubs(argv=None):
    from ..io.sam_read import parse_cigar

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    minq = a.get_int("minq", default=0)
    maxq = a.get_int("maxq", default=99)
    count_indels = a.get_bool("countindels", default=True)
    kept = total = 0
    with open_input(in1) as fi, open_output(out1) as fo:
        for line in fi:
            if line.startswith(b"@"):
                fo.write(line)
                continue
            total += 1
            f = line.rstrip(b"\n").split(b"\t")
            if int(f[1]) & 0x4:
                continue
            cigar, qual = f[5].decode(), f[10]
            qualifying = False
            rpos = 0
            for n, op in parse_cigar(cigar):
                if op == "X":
                    for j in range(rpos, rpos + n):
                        if j < len(qual) and minq <= qual[j] - 33 <= maxq:
                            qualifying = True
                    rpos += n
                elif op in "=MSI":
                    if op == "I" and count_indels:
                        qualifying = True
                    rpos += n
                elif op in "DN":
                    if op == "D" and count_indels:
                        qualifying = True
            if qualifying:
                fo.write(line)
                kept += 1
    print(f"Kept {kept} of {total} alignments.", file=sys.stderr)
    return kept, total


def kmercoverage(argv=None):
    from ..ops.cms import CountMinSketch
    from ..ops.kmer_count import read_keys_t

    a = tokenize(argv if argv is not None else sys.argv[1:])
    device = resolve_device(a.get("device", default="cuda"))
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    hist_out = a.get("hist")
    extra = a.get("extra")
    k = a.get_int("k", default=31)

    cms = CountMinSketch(hashes=a.get_int("hashes", default=2), device=device)
    sources = [in1] + (extra.split(",") if extra else [])
    for path in sources:
        for b in FastqReader(path):
            flat, _ = read_keys_t(b.bases, b.lengths, k, device)
            if len(flat):
                cms.add(flat)

    hist = np.zeros(1 << 16, dtype=np.int64)
    n = 0
    with open_output(out1) as fh:
        for b in FastqReader(in1):
            flat, counts = read_keys_t(b.bases, b.lengths, k, device)
            depths_all = cms.query(flat) if len(flat) else np.zeros(0, np.int64)
            ends = np.cumsum(counts)
            for i in range(b.n):
                depths = depths_all[ends[i] - counts[i]: ends[i]]
                if len(depths):
                    mind, avgd = int(depths.min()), float(depths.mean())
                else:
                    mind, avgd = 0, 0.0
                hist[min(int(avgd), hist.shape[0] - 1)] += 1
                fh.write(
                    b"@%s min=%d avg=%.2f\n%s\n+\n%s\n"
                    % (
                        b.ids[i], mind, avgd, b.sequence(i),
                        b.quality_string(i) or b"I" * int(b.lengths[i]),
                    )
                )
                n += 1
    if hist_out:
        top = int(np.nonzero(hist)[0].max()) if hist.any() else 0
        with open_output(hist_out) as fh:
            fh.write(b"#depth\treads\n")
            for d in range(top + 1):
                fh.write(b"%d\t%d\n" % (d, int(hist[d])))
    print(f"Annotated {n} reads.", file=sys.stderr)
    return n


if __name__ == "__main__":
    countduplicates()


def consect(argv=None):
    """Consect (consect.sh, jgi/Consect.java) — conservative consensus
    of multiple error-correction tools: the FIRST input is the
    uncorrected stream, the rest are corrected versions in the same
    order; a substitution is accepted only when EVERY corrected stream
    agrees on the same changed base (indel-changed reads pass through
    uncorrected). Needs >= 3 inputs (raw + 2 correctors)."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    ins = (a.get("in", "in1") or "").split(",")
    out1 = a.get("out", "out1")
    if len(ins) < 3:
        raise ValueError("consect needs in=raw,corrected1,corrected2[,...]")
    readers = [iter(FastqReader(p, batch_reads=4096)) for p in ins]
    n = accepted = rejected = 0
    with open_output(out1) as fh:
        while True:
            batches = []
            done = False
            for r in readers:
                b = next(r, None)
                if b is None:
                    done = True
                batches.append(b)
            if done:
                break
            raw = batches[0]
            La = raw.bases.shape[1]
            # per-read consensus: all correctors agree -> accept subs
            agree = None
            usable = np.ones(raw.n, bool)
            for b in batches[1:]:
                if b.n != raw.n:
                    raise ValueError("inputs out of sync (read counts)")
                same_len = b.lengths == raw.lengths
                usable &= same_len  # indel corrections pass through
                Lb = b.bases.shape[1]
                L = max(La, Lb)
                bb = np.full((raw.n, L), 255, np.uint8)
                bb[:, :Lb] = b.bases
                if agree is None:
                    agree = bb
                else:
                    mism = agree[:, :L] != bb
                    agree = np.where(mism, 254, agree[:, :L])
            cons = raw.bases.copy()
            rows = np.flatnonzero(usable)
            sub = agree[rows, :La]
            ok = sub < 4  # all correctors agree on a real base
            cons[rows] = np.where(ok, sub, cons[rows])
            changed = (cons != raw.bases).any(axis=1)
            accepted += int(changed.sum())
            rejected += int((~usable).sum())
            n += raw.n
            from ..io.fastq import encode_fastq

            out_b = raw
            out_b.bases = cons
            out_b.ascii_bases = None
            fh.write(encode_fastq(out_b))
    print(
        f"Reads: {n}  corrected: {accepted}  "
        f"indel-skipped: {rejected}", file=sys.stderr,
    )
    return n, accepted


def mergeotus(argv=None):
    """MergeOTUs (mergeOTUs.sh, driver/MergeCoverageOTU.java) — merge
    pileup covstats rows whose ID shares the same OTU tag (the token
    after the first space of the ID column, :44-52), summing
    length/coverage/read counts and recomputing Avg_fold as the
    length-weighted mean."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    header = None
    merged: dict[bytes, list] = {}
    order: list[bytes] = []
    with open_input(in1) as fh:
        for line in fh.read().splitlines():
            if not line:
                continue
            if line.startswith(b"#"):
                if header is None:
                    header = line
                continue
            f = line.split(b"\t")
            id_field = f[0]
            otu = (
                id_field.split(b" ", 1)[1].split(b"\t")[0]
                if b" " in id_field else id_field
            )
            row = merged.get(otu)
            length = int(f[2])
            covsum = float(f[1]) * length
            cb, pr, mr = int(f[5]), int(f[6]), int(f[7])
            if row is None:
                merged[otu] = [covsum, length, float(f[3]) * length, cb,
                               pr, mr]
                order.append(otu)
            else:
                row[0] += covsum
                row[1] += length
                row[2] += float(f[3]) * length
                row[3] += cb
                row[4] += pr
                row[5] += mr
    with open_output(out1) as fh:
        fh.write((header or b"#ID\tAvg_fold\tLength\tRef_GC\t"
                  b"Covered_percent\tCovered_bases\tPlus_reads\t"
                  b"Minus_reads") + b"\n")
        for otu in order:
            covsum, length, gcsum, cb, pr, mr = merged[otu]
            fh.write(
                b"%s\t%.4f\t%d\t%.4f\t%.4f\t%d\t%d\t%d\n"
                % (
                    otu, covsum / max(length, 1), length,
                    gcsum / max(length, 1), 100.0 * cb / max(length, 1),
                    cb, pr, mr,
                )
            )
    print(f"Merged to {len(merged)} OTUs.", file=sys.stderr)
    return merged


def mergefastacontigs(argv=None):
    """Merge contigs into synthetic N-padded chromosomes
    (pacbio/MergeFastaContigs.java): contigs shorter than minlen are
    dropped, survivors concatenate with npad Ns between them, a new
    chromosome starts when the running length would exceed maxlen, and
    a .info index records each contig's (chrom, start, stop) so
    coordinates can be mapped back."""
    import sys

    from ..core.parser import tokenize
    from ..io.fasta import iter_fasta
    from ..io.readwrite import open_output

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    info = a.get("info", default=(out1 or "merged") + ".info")
    npad = a.get_int("npad", default=300)
    maxlen = a.get_int("maxlen", "maxchrom", default=200_000_000)
    minlen = a.get_int("minlen", "mincontig", default=1)
    pad = b"N" * npad
    chrom = 1
    loc = 0
    nc = 0
    with open_output(out1) as fo, open_output(info) as fi:
        fi.write(b"#contig\tchrom\tstart\tstop\n")
        fo.write(b">chr%d\n" % chrom)
        for rec in iter_fasta(in1):
            if len(rec.seq) < minlen:
                continue
            if loc and loc + npad + len(rec.seq) > maxlen:
                fo.write(b"\n>chr%d\n" % (chrom + 1))
                chrom += 1
                loc = 0
            if loc:
                fo.write(pad)
                loc += npad
            fo.write(rec.seq)
            fi.write(b"%s\t%d\t%d\t%d\n" % (
                rec.name.split()[0], chrom, loc, loc + len(rec.seq)))
            loc += len(rec.seq)
            nc += 1
        fo.write(b"\n")
    print(f"Contigs merged:      \t{nc}", file=sys.stderr)
    print(f"Chromosomes:         \t{chrom}", file=sys.stderr)
    return nc, chrom


def partitionfastafile(argv=None):
    """Split a FASTA into `ways` parts of roughly equal bases at contig
    boundaries (pacbio/PartitionFastaFile.java role; out pattern uses
    '%' or '#' for the part number)."""
    import sys

    from ..core.parser import tokenize
    from ..io.fasta import iter_fasta
    from ..io.readwrite import open_output

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out_pat = a.get("out", default="part_%.fa")
    ways = a.get_int("ways", "parts", default=2)
    recs = list(iter_fasta(in1))
    total = sum(len(r.seq) for r in recs)
    part = 0
    written = 0
    fh = None
    counts = []

    def openpart(p):
        name = out_pat.replace("%", str(p)).replace("#", str(p))
        return open_output(name)

    for rec in recs:
        # midpoint rule: a contig goes to the next part when more than
        # half of it lies past this part's equal-bases boundary
        while (
            part < ways - 1
            and written + len(rec.seq) / 2 > total * (part + 1) / ways
        ):
            if fh is not None:
                fh.close()
                fh = None
            part += 1
        if fh is None:
            fh = openpart(part)
            counts.append(0)
        fh.write(b">%s\n%s\n" % (rec.name, rec.seq))
        written += len(rec.seq)
        counts[-1] += len(rec.seq)
    if fh is not None:
        fh.close()
    print(f"Parts written:       \t{len(counts)}", file=sys.stderr)
    return counts
