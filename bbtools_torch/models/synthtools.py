"""Genome/read synthesis and k-mer utility tools: mutate, bbfakereads,
kcompress, kmerlimit, findrepeats, checkstrand.

References (semantics source, no code reuse):
  - synth/MutateGenome.java — mutate a genome at subrate=/indelrate=
    (maxindel= lengths), emitting the mutated FASTA plus a VCF of the
    applied variants in ORIGINAL coordinates.
  - synth/FakeReads.java — fake read pairs from the two ENDS of each
    input sequence (length=, minlength=, identifier= prefix; r2 is the
    reverse-complemented right end, like an outward sequencing pair).
  - assemble/KmerCompressor.java — emit every distinct canonical k-mer
    exactly once, greedily chained into maximal unitig-like contigs
    (used to build compact masking/filter references); min=/max= bound
    the k-mer count band kept.
  - sketch/KmerLimit.java — pass reads through until the stream has
    yielded ~limit= unique k-mers (cardinality-tracked), then stop. The
    LogLog tracker hashes each batch on the run's device (`device=`,
    cuda by default; models/loglog.py).
  - repeat/RepeatFinder.java — report genomic intervals covered by
    k-mers occurring >= mincount times (gap= tolerated non-repeat run
    inside an interval), TSV out= plus optional outs= FASTA.
  - jgi/CheckStrand2.java — strandedness: the fraction of read k-mer
    hits that agree with the reference's forward orientation
    (plus/(plus+minus)); reports the P-strand fraction.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.parser import tokenize
from ..core.dna import CODE_TO_BASE, encode
from ..io.fasta import iter_fasta, write_fasta
from ..io.fastq import FastqReader, FastqWriter
from ..io.readwrite import open_output
from ..ops.kmers import rolling_kmers_np

RC = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def _revcomp(seq: bytes) -> bytes:
    return seq.translate(RC)[::-1]


# ---------------------------------------------------------------- mutate
def mutate(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    vcf = a.get("vcf")
    sub_rate = a.get_float("subrate", default=0.0)
    indel_rate = a.get_float("indelrate", default=0.0)
    max_indel = a.get_int("maxindel", default=1)
    seed = a.get_int("seed", default=-1)
    rng = np.random.default_rng(None if seed < 0 else seed)
    ACGT = b"ACGT"
    records = []
    vlines = []
    n_subs = n_ins = n_dels = 0
    for rec in iter_fasta(in1):
        seq = bytearray()
        src = rec.seq.upper()
        i = 0
        while i < len(src):
            r = rng.random()
            base = src[i]
            if base in b"ACGT" and r < sub_rate:
                alt = ACGT[(ACGT.index(base) + int(rng.integers(1, 4))) % 4]
                seq.append(alt)
                vlines.append(
                    (rec.name.split()[0], i + 1, bytes([base]), bytes([alt]))
                )
                n_subs += 1
                i += 1
            elif base in b"ACGT" and r < sub_rate + indel_rate:
                ln = int(rng.integers(1, max_indel + 1))
                if rng.random() < 0.5 and i + ln < len(src):  # deletion
                    vlines.append(
                        (rec.name.split()[0], i, src[i - 1 : i + ln],
                         src[i - 1 : i])
                    )
                    n_dels += 1
                    i += ln
                else:  # insertion
                    ins = bytes(ACGT[int(x)] for x in rng.integers(0, 4, ln))
                    seq.append(base)
                    seq.extend(ins)
                    vlines.append(
                        (rec.name.split()[0], i + 1, bytes([base]),
                         bytes([base]) + ins)
                    )
                    n_ins += 1
                    i += 1
            else:
                seq.append(base)
                i += 1
        records.append((rec.name, bytes(seq)))
    if out1:
        write_fasta(out1, records)
    if vcf:
        with open_output(vcf) as fh:
            fh.write(b"##fileformat=VCFv4.2\n")
            fh.write(b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
            for chrom, pos, ref, alt in vlines:
                fh.write(
                    b"%s\t%d\t.\t%s\t%s\t60\tPASS\t.\n"
                    % (chrom, max(pos, 1), ref, alt)
                )
    print(f"Substitutions:      \t{n_subs}", file=sys.stderr)
    print(f"Insertions:         \t{n_ins}", file=sys.stderr)
    print(f"Deletions:          \t{n_dels}", file=sys.stderr)
    return records, vlines


# ----------------------------------------------------------- bbfakereads
def fakereads(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    out2 = a.get("out2")
    length = a.get_int("length", "maxlen", default=250)
    minlen = a.get_int("minlength", "minlen", "ml", default=1)
    ident = a.get("identifier", "id")
    q = a.get_int("q", "quality", default=35)
    n_pairs = 0
    qual = bytes([33 + q])
    w1 = FastqWriter(out1) if out1 else None
    w2 = FastqWriter(out2) if out2 else (w1 if out1 else None)
    from ..io.batch import ReadBatch

    s1, q1, i1 = [], [], []
    s2, q2, i2 = [], [], []
    for rec in iter_fasta(in1):
        seq = rec.seq.upper()
        if len(seq) < max(minlen, 1):
            continue
        ln = min(length, len(seq))
        left = seq[:ln]
        right = _revcomp(seq[-ln:])
        prefix = (ident.encode() + b"_") if ident else b""
        name = prefix + rec.name.split()[0]
        s1.append(left)
        q1.append(qual * len(left))
        i1.append(name + b" /1")
        s2.append(right)
        q2.append(qual * len(right))
        i2.append(name + b" /2")
        n_pairs += 1
    if s1 and w1:
        w1.add(ReadBatch.from_sequences(s1, quals=q1, ids=i1, ordinal=0))
        if w2 is w1:
            w1.add(ReadBatch.from_sequences(s2, quals=q2, ids=i2, ordinal=1))
        elif w2:
            w2.add(ReadBatch.from_sequences(s2, quals=q2, ids=i2, ordinal=0))
    for w in {id(w1): w1, id(w2): w2}.values():
        if w is not None:
            w.close()
    print(f"Pairs Written:      \t{n_pairs}", file=sys.stderr)
    return n_pairs


# ------------------------------------------------------------- kcompress
def kcompress(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    k = a.get_int("k", default=31)
    cmin = a.get_int("min", default=1)
    cmax = a.get_int("max", default=(1 << 31) - 1)
    fuse = a.get_int("fuse", default=0)
    from ..ops.kmer_count import KmerSpectrum, count_batch_np

    spec = KmerSpectrum(k)
    from ..io.fileformat import Format, test_input

    if test_input(in1).format == Format.FASTA:
        for rec in iter_fasta(in1):
            codes = encode(rec.seq)[None, :]
            v, c = count_batch_np(codes, np.array([codes.shape[1]]), k)
            spec.add_batch(v, c)
    else:
        for b in FastqReader(in1):
            v, c = count_batch_np(b.bases, b.lengths, k)
            spec.add_batch(v, c)
    spec.flush()
    keep = (spec.counts >= cmin) & (spec.counts <= cmax)
    keys = spec.keys[keep]
    mask = (1 << (2 * k)) - 1
    kmers = keys & mask  # strip length tag if present
    kset = set(kmers.tolist())
    contigs = []
    # greedy unitig chaining: each kmer emitted exactly once
    def canon(km):
        r = 0
        x = km
        for _ in range(k):
            r = (r << 2) | (3 - (x & 3))
            x >>= 2
        return max(km, r)

    emitted = set()
    for start in kmers.tolist():
        if start in emitted:
            continue
        emitted.add(start)
        # decode and extend right while a unique successor exists
        chain = [start]
        cur = start
        while True:
            suf = (cur << 2) & mask
            nxt = [suf | b for b in range(4)]
            nxt = [x for x in nxt if canon(x) in kset or x in kset]
            nxt = [x for x in nxt if (canon(x) if canon(x) in kset else x)
                   not in emitted]
            cand = []
            for x in nxt:
                key = canon(x) if canon(x) in kset else x
                if key in kset and key not in emitted:
                    cand.append((x, key))
            if len(cand) != 1:
                break
            x, key = cand[0]
            emitted.add(key)
            chain.append(x)
            cur = x
        # render: first kmer + last base of each extension
        seq = bytearray()
        km = chain[0]
        for i in range(k - 1, -1, -1):
            seq.append(b"ACGT"[(km >> (2 * i)) & 3])
        for x in chain[1:]:
            seq.append(b"ACGT"[x & 3])
        contigs.append(bytes(seq))
    if fuse > 0:
        fused, cur = [], b""
        for cseq in contigs:
            cur = cur + (b"N" if cur else b"") + cseq
            if len(cur) >= fuse:
                fused.append(cur)
                cur = b""
        if cur:
            fused.append(cur)
        contigs = fused
    if out1:
        write_fasta(
            out1,
            [(b"contig_%d" % i, s) for i, s in enumerate(contigs)],
        )
    print(f"Kmers In:           \t{len(kmers)}", file=sys.stderr)
    print(f"Contigs Out:        \t{len(contigs)}", file=sys.stderr)
    return contigs


# -------------------------------------------------------------- kmerlimit
def kmerlimit(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    k = a.get_int("k", default=31)
    limit = a.get_int("limit", default=None)
    if limit is None:
        raise SystemExit("kmerlimit: limit= is required")
    from ..device import resolve_device
    from ..models.loglog import LogLog

    # the k-mers are hashed on the run's device (cuda unless device=cpu)
    ll = LogLog(k=k, device=resolve_device(a.get("device", default="cuda")))
    n_out = 0
    batch = a.get_int("batchreads", default=4096)
    with FastqWriter(out1) if out1 else _NullW() as w:
        for b in FastqReader(in1, batch_reads=batch):
            ll.add_batch(b.bases, b.lengths)
            w.add(b)
            n_out += b.n
            if ll.cardinality() >= limit:
                break
    print(f"Reads Out:          \t{n_out}", file=sys.stderr)
    print(f"Unique Kmers:       \t{int(ll.cardinality())}", file=sys.stderr)
    return n_out


class _NullW:
    def __enter__(self):
        return self

    def __exit__(self, *e):
        pass

    def add(self, *a, **k):
        pass


# ------------------------------------------------------------ findrepeats
def findrepeats(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    outs = a.get("outs", "outsequence")
    k = a.get_int("k", default=31)
    gap = a.get_int("gap", default=0)
    mincount = a.get_int("mincount", default=2)
    minlen = a.get_int("minrepeat", "minlength", default=0)
    scafs = [(rec.name.split()[0], encode(rec.seq)) for rec in iter_fasta(in1)]
    # global canonical spectrum
    from ..ops.kmer_count import KmerSpectrum, count_batch_np

    spec = KmerSpectrum(k)
    for _, codes in scafs:
        v, c = count_batch_np(codes[None, :], np.array([len(codes)]), k)
        spec.add_batch(v, c)
    spec.flush()
    counts = dict(zip(spec.keys.tolist(), spec.counts.tolist()))
    rows = []
    seqs = []
    for name, codes in scafs:
        if len(codes) < k:
            continue
        fwd, rkm, runlen = rolling_kmers_np(codes[None, :], k)
        keys = np.maximum(fwd[0], rkm[0])  # canonical, count_batch_np keying
        valid = runlen[0] >= k
        isrep = np.zeros(len(codes), dtype=bool)
        for i in np.flatnonzero(valid):
            if counts.get(int(keys[i]), 0) >= mincount:
                isrep[i - k + 1 : i + 1] = True
        # merge with gap tolerance (gap is in kmers)
        idx = np.flatnonzero(isrep)
        if not len(idx):
            continue
        splits = np.flatnonzero(np.diff(idx) > gap + 1)
        starts = np.concatenate([[idx[0]], idx[splits + 1]])
        ends = np.concatenate([idx[splits], [idx[-1]]])
        for s, e in zip(starts, ends):
            if e - s + 1 < max(minlen, k):
                continue
            rows.append((name, int(s), int(e) + 1))
            seqs.append(
                (b"%s_%d_%d" % (name, s, e + 1),
                 CODE_TO_BASE[np.minimum(codes[s : e + 1], 4)].tobytes())
            )
    if out1:
        with open_output(out1) as fh:
            fh.write(b"#scaffold\tstart\tstop\tlength\n")
            for name, s, e in rows:
                fh.write(b"%s\t%d\t%d\t%d\n" % (name, s, e, e - s))
    if outs and seqs:
        write_fasta(outs, seqs)
    print(f"Repeats Found:      \t{len(rows)}", file=sys.stderr)
    return rows


# ------------------------------------------------------------ checkstrand
def checkstrand(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    ref = a.get("ref")
    k = a.get_int("k", default=31)
    # forward-strand kmer set of the reference (orientation-carrying)
    fwd_set = set()
    for rec in iter_fasta(ref):
        codes = encode(rec.seq)[None, :]
        f, r, runlen = rolling_kmers_np(codes, k)
        ok = runlen[0] >= k
        fwd_set.update(f[0][ok].tolist())
    plus = minus = 0
    reads_p = reads_m = 0
    for b in FastqReader(in1):
        f, r, runlen = rolling_kmers_np(b.bases, k)
        i_idx = np.arange(b.bases.shape[1])[None, :]
        ok = (runlen >= k) & (i_idx < b.lengths[:, None])
        for i in range(b.n):
            sel = ok[i]
            pf = sum(1 for x in f[i][sel].tolist() if x in fwd_set)
            pr = sum(1 for x in r[i][sel].tolist() if x in fwd_set)
            plus += pf
            minus += pr
            if pf > pr:
                reads_p += 1
            elif pr > pf:
                reads_m += 1
    tot = plus + minus
    frac = plus / tot if tot else 0.5
    print(f"P-Strand Kmers:     \t{frac*100:.2f}%", file=sys.stderr)
    print(f"Plus Reads:         \t{reads_p}", file=sys.stderr)
    print(f"Minus Reads:        \t{reads_m}", file=sys.stderr)
    maj = max(reads_p, reads_m) / max(reads_p + reads_m, 1)
    print(f"Strandedness:       \t{maj*100:.2f}%", file=sys.stderr)
    return frac


# ------------------------------------------------------------ addadapters
def addadapters(argv=None):
    """jgi/AddAdapters.java: write adapters into reads at random
    positions, encoding the truth position in the header
    (`name insert=<pos>`); `grade` mode re-reads a TRIMMED file and
    scores how many reads were trimmed to exactly the right length."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    grade = a.get_bool("grade", default=False)
    if grade:
        total = correct = over = under = 0
        for b in FastqReader(in1):
            for i in range(b.n):
                rid = b.ids[i]
                if b" insert=" not in rid:
                    continue
                want = int(rid.rsplit(b" insert=", 1)[1].split()[0])
                got = int(b.lengths[i])
                total += 1
                if got == want:
                    correct += 1
                elif got < want:
                    over += 1
                else:
                    under += 1
        print(f"Total:               \t{total}", file=sys.stderr)
        print(f"Correct:             \t{correct}\t"
              f"{100*correct/max(total,1):.2f}%", file=sys.stderr)
        print(f"Overtrimmed:         \t{over}", file=sys.stderr)
        print(f"Undertrimmed:        \t{under}", file=sys.stderr)
        return total, correct, over, under
    adapters = []
    if a.get("adapters"):
        adapters += [rec.seq for rec in iter_fasta(a.get("adapters"))]
    adapters += [x.encode() for x in (a.get("literal") or "").split(",") if x]
    if not adapters:
        raise SystemExit("addadapters: adapters= or literal= required")
    rate = a.get_float("rate", default=0.5)
    seed = a.get_int("seed", default=-1)
    rng = np.random.default_rng(None if seed < 0 else seed)
    right = (a.get("right") or "t").lower() in ("t", "true", "1")
    n_added = 0
    from ..io.batch import ReadBatch

    with FastqWriter(out1) as w:
        for b in FastqReader(in1):
            seqs, quals, ids = [], [], []
            for i in range(b.n):
                seq = bytearray(b.sequence(i))
                q = bytearray(b.quality_string(i) or b"I" * len(seq))
                L = len(seq)
                if rng.random() < rate and L > 20 and right:
                    pos = int(rng.integers(10, L - 5))
                    ad = adapters[int(rng.integers(0, len(adapters)))]
                    m = min(len(ad), L - pos)
                    seq[pos : pos + m] = ad[:m]
                    # fill any tail after the adapter with random bases
                    for t in range(pos + m, L):
                        seq[t] = b"ACGT"[int(rng.integers(0, 4))]
                    ids.append(b.ids[i] + b" insert=%d" % pos)
                    n_added += 1
                else:
                    ids.append(b.ids[i] + b" insert=%d" % L)
                seqs.append(bytes(seq))
                quals.append(bytes(q))
            w.add(ReadBatch.from_sequences(
                seqs, quals=quals, ids=ids, ordinal=b.ordinal))
    print(f"Adapters Added:      \t{n_added}", file=sys.stderr)
    return n_added


# ----------------------------------------------------------- makechimeras
def makechimeras(argv=None):
    """jgi/MakeChimeras.java: join random pairs of input sequences into
    `chimeras=` chimeric records (benchmarking data for chimera
    detectors)."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    n_chim = a.get_int("chimeras", default=-1)
    seed = a.get_int("seed", default=-1)
    if n_chim < 0:
        raise SystemExit("makechimeras: chimeras= is required")
    rng = np.random.default_rng(None if seed < 0 else seed)
    seqs = [(rec.name.split()[0], rec.seq) for rec in iter_fasta(in1)]
    if len(seqs) < 2:
        raise SystemExit("makechimeras: need >= 2 input sequences")
    recs = []
    for i in range(n_chim):
        ai, bi = rng.choice(len(seqs), 2, replace=False)
        na, sa = seqs[ai]
        nb, sb = seqs[bi]
        ca = int(rng.integers(1, len(sa)))
        cb = int(rng.integers(1, len(sb)))
        recs.append(
            (b"chimera_%d_%s_%d_%s_%d" % (i, na, ca, nb, cb),
             sa[:ca] + sb[cb:])
        )
    write_fasta(out1, recs)
    print(f"Chimeras Made:       \t{len(recs)}", file=sys.stderr)
    return recs


def kmutate(argv=None):
    """kmutate.sh (jgi/KmerFilterSet / SpecialKmers role): emit the kmer
    spectrum of a reference expanded by hdist= substitutions or edist=
    edits (sub+ins+del), as fasta — for BBDuk/Seal filter sets. Reuses
    the BBDuk load-side expansion (ops/kmer_index.expand_kmers[_edist],
    BBDukIndexMod.mutate semantics)."""
    from ..ops.kmer_index import expand_kmers, expand_kmers_edist
    from ..ops.kmers import canonical_keys_np

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    k = a.get_int("k", default=31)
    hdist = a.get_int("hdist", default=0)
    edist = a.get_int("edist", default=0)
    if k > 31:
        raise ValueError("kmutate: k<=31")

    kmers = []
    extras = []
    for rec in iter_fasta(in1) if in1.endswith(
        (".fa", ".fasta", ".fa.gz", ".fasta.gz", ".fna", ".fna.gz")
    ) else ():
        codes = encode(rec.seq)
        fwd, rkm, runlen = rolling_kmers_np(codes[None, :], k)
        ok = runlen[0] >= k
        idx = np.nonzero(ok)[0]
        kmers.append(fwd[0][idx])
        ext = np.full(len(idx), -1, dtype=np.int64)
        nxt = idx + 1
        inb = nxt < len(codes)
        ext[inb] = np.where(codes[nxt[inb]] < 4, codes[nxt[inb]], -1)
        extras.append(ext)
    if not kmers:
        # fastq input
        from ..io.fastq import FastqReader

        for b in FastqReader(in1):
            fwd, rkm, runlen = rolling_kmers_np(b.bases, k)
            ok = (runlen >= k) & (
                np.arange(b.padded_len)[None, :] < b.lengths[:, None]
            )
            kmers.append(fwd[ok])
            extras.append(np.full(int(ok.sum()), -1, dtype=np.int64))
    raw = np.concatenate(kmers) if kmers else np.zeros(0, np.int64)
    ext = np.concatenate(extras) if extras else np.zeros(0, np.int64)
    if edist > 0:
        keys, _ = expand_kmers_edist(raw, ext, k, edist)
    else:
        keys, _ = expand_kmers(raw, k, hdist)
    keys = np.unique(keys)
    # strip the length mask to recover literal kmers
    from ..ops.kmers import length_mask

    vals = keys & ~np.int64(length_mask(k))
    with open_output(out1) as fh:
        for i, v in enumerate(vals):
            km = bytes(
                b"ACGT"[(int(v) >> (2 * (k - 1 - j))) & 3] for j in range(k)
            )
            fh.write(b">%d\n%s\n" % (i, km))
    print(f"Wrote {len(vals)} kmers.", file=sys.stderr)
    return len(vals)


def randomreadsmg(argv=None):
    """RandomReadsMG (randomreadsmg.sh, synth/RandomReadsMG.java role) —
    synthetic metagenome reads from a set of assemblies, each at a
    random (or custom) coverage level. Headers follow the documented
    style `f_N c_N s_N p_N i_N r_N d_N[ tid_N]` (file, contig, strand,
    position, insert, reflen, pcr-duplicate flag, taxid parsed from a
    `tid_x_` filename prefix). Supports depth modes uniform/exp/root/
    min4, `file=depth` custom coverage, reads=/readspercontig= targets,
    paired reads with avginsert, pcr= duplicate injection, and a
    substitution error model via adderrors=t snprate=.
    """
    import os
    import re

    argv = list(argv if argv is not None else sys.argv[1:])
    kv = [t for t in argv if "=" in t]
    pos = [t for t in argv if "=" not in t]
    a = tokenize(kv)
    ins = []
    custom: dict[str, float] = {}
    for t in pos:
        ins.append(t)
    for spec in (a.get("in", "in1") or "").split(","):
        if spec:
            ins.append(spec)
    # file=depth and cov_x= custom coverage forms
    for t in kv:
        key, val = t.split("=", 1)
        if os.path.exists(key) and key not in ins:
            ins.append(key)
            custom[os.path.basename(key)] = float(val)
        elif key.startswith("cov_"):
            custom[key[4:]] = float(val)
    # expand directories
    expanded = []
    for p in ins:
        if os.path.isdir(p):
            expanded += sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.endswith((".fa", ".fasta", ".fna", ".fa.gz"))
            )
        else:
            expanded.append(p)
    ins = expanded
    out1 = a.get("out", "out1")
    out2 = a.get("out2")
    mindepth = a.get_float("mindepth", default=1.0)
    maxdepth = a.get_float("maxdepth", default=256.0)
    depth = a.get_float("depth", default=0.0)
    if depth > 0:
        mindepth = maxdepth = depth
    reads_target = a.get_int("reads", default=-1)
    per_contig = a.get_int("readspercontig", default=-1)
    mode = a.get("mode", default="min4") or "min4"
    paired = a.get_bool("paired", default=True)
    length = a.get_int("length", "len", default=150)
    avginsert = a.get_int("avginsert", default=300)
    pcr = a.get_float("pcr", default=0.0)
    adderrors = a.get_bool("adderrors", default=False)
    snprate = a.get_float("snprate", default=0.01 if adderrors else 0.0)
    seed = a.get_int("seed", default=-1)
    rng = np.random.default_rng(seed if seed > 0 else None)

    def draw_depth():
        u = rng.random()
        lo, hi = mindepth, maxdepth
        if mode == "uniform":
            return lo + u * (hi - lo)
        if mode == "exp":
            return lo * (hi / lo) ** u
        if mode == "root":
            return lo + (u ** 0.5) * (hi - lo)
        # min4: min of 4 uniform draws (skews low, metagenome-like)
        return lo + float(np.min(rng.random(4))) * (hi - lo)

    comp = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")
    n_out = 0
    w1 = open_output(out1)
    w2 = open_output(out2) if out2 else None
    try:
        for fi, path in enumerate(ins):
            base = os.path.basename(path)
            m = re.match(r"tid_(\d+)_", base)
            tid = int(m.group(1)) if m else -1
            cov = custom.get(base, custom.get(str(tid) if tid > 0 else ""))
            if cov is None:
                cov = draw_depth()
            contigs = [
                (rec.name, rec.seq) for rec in iter_fasta(path)
            ]
            total_len = sum(len(s) for _, s in contigs)
            if reads_target > 0:
                span = length * (2 if paired else 1)
                cov = reads_target * span / max(total_len, 1)
            for ci, (cname, seq) in enumerate(contigs):
                span = avginsert if paired else length
                if len(seq) < span + 2:
                    continue
                if per_contig > 0:
                    n = per_contig
                else:
                    n = max(
                        1,
                        int(cov * len(seq) / (length * (2 if paired else 1))),
                    )
                i = 0
                while i < n:
                    dup = 0
                    p0 = int(rng.integers(0, len(seq) - span + 1))
                    while True:
                        insert = span
                        strand = int(rng.integers(0, 2))
                        frag = seq[p0 : p0 + insert]
                        if strand:
                            frag = frag.translate(comp)[::-1]
                        def _err(s):
                            if snprate <= 0:
                                return s
                            arr = np.frombuffer(s, np.uint8).copy()
                            mask = rng.random(len(arr)) < snprate
                            subs = rng.integers(0, 4, int(mask.sum()))
                            arr[mask] = np.frombuffer(b"ACGT", np.uint8)[subs]
                            return arr.tobytes()
                        hdr = b"f_%d c_%d s_%d p_%d i_%d r_%d d_%d" % (
                            fi, ci, strand, p0, insert, insert, dup,
                        )
                        if tid > 0:
                            hdr += b" tid_%d" % tid
                        q = b"I" * length
                        if paired:
                            r1 = _err(frag[:length])
                            r2 = _err(
                                frag[-length:].translate(comp)[::-1]
                            )
                            if w2 is not None:
                                w1.write(b"@" + hdr + b" /1\n" + r1
                                         + b"\n+\n" + q + b"\n")
                                w2.write(b"@" + hdr + b" /2\n" + r2
                                         + b"\n+\n" + q + b"\n")
                            else:
                                w1.write(b"@" + hdr + b" /1\n" + r1
                                         + b"\n+\n" + q + b"\n")
                                w1.write(b"@" + hdr + b" /2\n" + r2
                                         + b"\n+\n" + q + b"\n")
                            n_out += 2
                        else:
                            r = _err(frag[:length])
                            w1.write(b"@" + hdr + b"\n" + r + b"\n+\n"
                                     + q + b"\n")
                            n_out += 1
                        i += 1
                        if pcr > 0 and rng.random() < pcr and i < n:
                            dup = 1
                            continue
                        break
            print(
                f"{base}: depth {cov:.2f}", file=sys.stderr,
            )
    finally:
        w1.close()
        if w2 is not None:
            w2.close()
    print(f"Wrote {n_out} reads.", file=sys.stderr)
    return n_out


def kmerfilterset(argv=None):
    """KmerFilterSetMaker (kmerfilterset.sh, jgi/KmerFilterSetMaker.java)
    — greedy minimal kmer set covering every input sequence: each pass
    counts canonical kmers over the still-uncovered sequences, keeps the
    top maxkpp (>= minkpp) most common, removes sequences containing
    them, and repeats until all sequences are covered. Output is one
    kmer per fasta record.
    """
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    k = a.get_int("k", default=31)
    rcomp = a.get_bool("rcomp", default=True)
    minkpp = a.get_int("minkpp", "minkmersperpass", default=1)
    maxkpp = a.get_int("maxkpp", "maxkmersperpass", default=2)
    mincount = a.get_int("mincount", default=1)
    maxpasses = a.get_int("maxpasses", default=3000)

    def canon_kmers(seq: bytes):
        codes = encode(seq).astype(np.int64)
        if len(codes) < k:
            return np.zeros(0, dtype=np.uint64)
        win = np.lib.stride_tricks.sliding_window_view(codes, k)
        ok = (win < 4).all(axis=1)
        win = win[ok]
        weights = (np.int64(1) << (2 * np.arange(k - 1, -1, -1))).astype(
            np.int64
        )
        kmers = (win * weights).sum(axis=1).astype(np.uint64)
        if rcomp:
            rc = _revcomp_kmers(kmers, k)
            kmers = np.minimum(kmers, rc)
        return np.unique(kmers)

    seqs = [canon_kmers(rec.seq) for rec in iter_fasta(in1)]
    seqs = [s for s in seqs if len(s)]
    chosen: list[int] = []
    passes = 0
    while seqs and passes < maxpasses:
        passes += 1
        allk = np.concatenate(seqs)
        vals, counts = np.unique(allk, return_counts=True)
        order = np.argsort(-counts)
        take = [
            int(vals[i]) for i in order[:maxkpp]
            if counts[i] >= mincount
        ]
        if len(take) < minkpp:
            take = [int(vals[i]) for i in order[:minkpp]]
        if not take:
            break
        chosen += take
        tset = np.array(take, dtype=np.uint64)
        seqs = [s for s in seqs if not np.isin(s, tset).any()]
    with open_output(out1) as fh:
        for i, v in enumerate(chosen):
            km = bytes(
                b"ACGT"[(v >> (2 * (k - 1 - j))) & 3] for j in range(k)
            )
            fh.write(b">%d\n%s\n" % (i, km))
    print(
        f"Chose {len(chosen)} kmers in {passes} passes.", file=sys.stderr,
    )
    return chosen


def _revcomp_kmers(kmers: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement of packed 2-bit kmers."""
    out = np.zeros_like(kmers)
    v = kmers.copy()
    for _ in range(k):
        out = (out << np.uint64(2)) | (
            np.uint64(3) - (v & np.uint64(3))
        )
        v >>= np.uint64(2)
    return out


def icecreammaker(argv=None):
    """IceCreamMaker (icecreammaker.sh, icecream/IceCreamMaker.java
    role) — synthesize PacBio movies with 'ice cream cone' triangle
    reads. Each ZMW takes a genomic molecule (length in
    [minlen,maxlen]), builds a movie of alternating-strand passes, and
    emits one subread per adapter-delimited pass with headers
    `movie/zmw/start_end`. missingrate= makes a ZMW's FIRST adapter
    missing, fusing a forward pass to its reverse complement (the
    triangle read icecream.py detects); hiddenrate= leaves an adapter
    in-sequence but undetected (same chimeric effect per flanked pair).
    Substitution errors are drawn per-ZMW from [miner,maxer].
    """
    import os

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1", "ref")
    out1 = a.get("out", "out1")
    n_zmws = a.get_int("zmws", "reads", default=1000)
    minlen = a.get_int("minlen", "minlength", default=500)
    maxlen = a.get_int("maxlen", "maxlength", default=5000)
    if a.get("len", "length"):
        minlen = maxlen = a.get_int("len", "length")
    minmov = a.get_int("minmovie", "minmov", default=500)
    maxmov = a.get_int("maxmovie", "maxmov", default=40000)
    missingrate = a.get_float("missingrate", "missing", default=0.0)
    hiddenrate = a.get_float("hiddenrate", "hidden", default=0.0)
    miner = a.get_float("miner", "minerrorrate", default=0.05)
    maxer = a.get_float("maxer", "maxerrorrate", default=0.28)
    gc = a.get_float("gc", default=0.6)
    genomesize = a.get_int("genomesize", default=10_000_000)
    ccs = a.get_bool("ccs", default=False)
    seed = a.get_int("seed", default=-1)
    rng = np.random.default_rng(seed if seed > 0 else None)

    if in1 and os.path.exists(in1):
        genome = b"".join(rec.seq for rec in iter_fasta(in1))
    else:
        p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
        genome = np.frombuffer(b"ACGT", np.uint8)[
            rng.choice(4, size=min(genomesize, 10_000_000), p=p)
        ].tobytes()
    comp = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")

    def add_errors(s: bytes, rate: float) -> bytes:
        arr = np.frombuffer(s, np.uint8).copy()
        mask = rng.random(len(arr)) < rate
        subs = rng.integers(0, 4, int(mask.sum()))
        arr[mask] = np.frombuffer(b"ACGT", np.uint8)[subs]
        return arr.tobytes()

    n_out = n_triangle = 0
    movie_name = b"m64012_000000_000000"
    with open_output(out1) as fh:
        for z in range(n_zmws):
            mol_len = int(rng.integers(minlen, maxlen + 1))
            if mol_len >= len(genome):
                mol_len = len(genome) - 1
            p0 = int(rng.integers(0, len(genome) - mol_len))
            mol = genome[p0 : p0 + mol_len]
            movie_len = int(rng.integers(minmov, maxmov + 1))
            err = float(rng.uniform(miner, maxer))
            # passes alternate strand; adapters delimit subreads
            passes = []
            total = 0
            strand = int(rng.integers(0, 2))
            while total < movie_len:
                s = mol if strand == 0 else mol.translate(comp)[::-1]
                passes.append(s)
                total += len(s)
                strand ^= 1
            if ccs:
                passes = passes[:1]
            # decide adapter visibility between passes
            missing = rng.random() < missingrate
            subreads = []  # (bases, n_fused_passes)
            cur, cur_n = passes[0], 1
            n_missing = 0
            for i, nxt in enumerate(passes[1:]):
                hidden = rng.random() < hiddenrate
                if (missing and i == 0) or hidden:
                    cur = cur + nxt  # fused chimera (triangle read)
                    cur_n += 1
                    n_missing += 1
                    n_triangle += 1
                else:
                    subreads.append((cur, cur_n))
                    cur, cur_n = nxt, 1
            subreads.append((cur, cur_n))
            start = 0
            n_adapters = len(passes) - 1 - n_missing
            for s, sn in subreads:
                s = add_errors(s, err)
                # reference metadata header (icecream/ReadBuilder.java
                # toHeader :105-112; isIceCream reads subreads= at
                # tab-term index 3)
                name = (
                    b"%s/%d/%d_%d\tpasses=%.2f\tfullPasses=%d\t"
                    b"subreads=%d\tmissing=%d\tadapters=%d\t"
                    b"errorRate=%.3f"
                    % (
                        movie_name, z, start, start + len(s),
                        len(s) / max(mol_len, 1), max(sn - 1, 0), sn,
                        n_missing, n_adapters, err,
                    )
                )
                fh.write(b"@" + name + b"\n" + s + b"\n+\n"
                         + b"I" * len(s) + b"\n")
                start += len(s) + 50  # adapter gap
                n_out += 1
    print(
        f"Wrote {n_out} subreads from {n_zmws} ZMWs "
        f"({n_triangle} fused/triangle).", file=sys.stderr,
    )
    return n_out, n_triangle


def icecreamgrader(argv=None):
    """IceCreamGrader (icecreamgrader.sh, icecream/IceCreamGrader.java)
    — grade an icecream-filtered stream of icecreammaker reads: a read
    whose `subreads=` header term exceeds 1 is a fused triangle read
    ('bad'); reports good/bad reads and bases (:193-219)."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    good = bad = goodb = badb = 0
    for b in FastqReader(in1):
        for i in range(b.n):
            name = b.ids[i]
            sub = 1
            for term in bytes(name).split(b"\t"):
                if term.startswith(b"subreads="):
                    sub = int(term[9:])
                    break
            L = int(b.lengths[i])
            if sub > 1:
                bad += 1
                badb += L
            else:
                good += 1
                goodb += L
    print(f"Good reads:\t{good}\t{goodb} bases", file=sys.stderr)
    print(f"Bad reads: \t{bad}\t{badb} bases", file=sys.stderr)
    return good, bad
