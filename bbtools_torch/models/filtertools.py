"""Read/record filtering tools: filterbyname, filterbysequence,
filtersam, countbarcodes, cutprimers.

References (semantics source, no code reuse):
  - driver/FilterReadsByName.java — keep/toss reads whose names appear in
    `names=` (comma list and/or files; leading >/@ stripped;
    substring/prefix matching modes; include=f excludes).
  - jgi/FilterBySequence.java — keep/toss reads whose full sequence
    matches a reference sequence (ref= files / literal=; rcomp=t matches
    reverse complements; case=f folds case).
  - var2/FilterSam.java — remove aligned reads carrying "bad"
    substitution variants: a read's sub is bad when its VCF allele depth
    (AD) is at most `mbad` or its allele fraction at most `mbaf`; reads
    with more than `mbv` bad vars go to outb.
  - barcode/CountBarcodes.java — count header barcodes (text after the
    last ':'), optionally validated against expected=; counts table.
  - jgi/CutPrimers.java — cut the region between two mapped primers per
    read (sam1/sam2 give per-read primer sites; include=t keeps the
    primers; fake=t emits a 1 bp N read when a primer is missing).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core.parser import tokenize
from ..io.fastq import FastqReader, FastqWriter
from ..io.readwrite import open_input, open_output

RC = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def _revcomp(seq: bytes) -> bytes:
    return seq.translate(RC)[::-1]


def _load_names(spec: str) -> list[bytes]:
    out: list[bytes] = []
    for tok in spec.split(","):
        if os.path.exists(tok):
            with open_input(tok) as fh:
                for line in fh.read().splitlines():
                    line = line.strip()
                    if line:
                        out.append(line.lstrip(b">@"))
        else:
            out.append(tok.encode().lstrip(b">@"))
    return out


def filterbyname(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1, in2 = a.get("in", "in1"), a.get("in2")
    out1, out2 = a.get("out", "out1"), a.get("out2")
    include = a.get_bool("include", default=False)
    substring = (a.get("substring") or "f").lower()
    prefix = a.get_bool("prefix", default=False)
    case = a.get_bool("casesensitive", "case", default=True)
    names = _load_names(a.get("names", default="") or "")
    if not case:
        names = [n.lower() for n in names]
    nameset = set(names)

    def matches(rid: bytes) -> bool:
        if not case:
            rid = rid.lower()
        if rid in nameset:
            return True
        # reference also matches the name up to the first whitespace
        short = rid.split()[0]
        if short in nameset:
            return True
        if prefix and any(rid.startswith(n) or n.startswith(rid)
                          for n in nameset):
            return True
        if substring in ("t", "true", "header", "name"):
            return any(n in rid or rid in n for n in nameset)
        return False

    kept = total = 0
    readers = [FastqReader(in1)] + ([FastqReader(in2)] if in2 else [])
    writers = [FastqWriter(out1) if out1 else None]
    if in2:
        writers.append(FastqWriter(out2) if out2 else writers[0])
    its = [iter(r) for r in readers]
    while True:
        try:
            batches = [next(it) for it in its]
        except StopIteration:
            break
        hit = np.array([matches(i) for i in batches[0].ids], dtype=bool)
        if len(batches) > 1:
            hit |= np.array([matches(i) for i in batches[1].ids], dtype=bool)
        keep = hit if include else ~hit
        total += batches[0].n
        kept += int(keep.sum())
        for b, w in zip(batches, writers):
            if w is not None:
                w.add(b, keep)
    for w in writers:
        if w is not None:
            w.close()
    print(f"Reads Processed:    \t{total}", file=sys.stderr)
    print(f"Reads Out:          \t{kept}", file=sys.stderr)
    return kept


def filterbysequence(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    outm = a.get("outm")
    include = a.get_bool("include", default=False)
    rcomp = a.get_bool("rcomp", default=True)
    case = a.get_bool("case", "casesensitive", default=False)
    seqs: set[bytes] = set()

    def add(s: bytes):
        s = s if case else s.upper()
        seqs.add(s)
        if rcomp:
            seqs.add(_revcomp(s))

    for path in (a.get("ref") or "").split(","):
        if path:
            from ..io.fasta import iter_fasta

            for rec in iter_fasta(path):
                add(rec.seq)
    for lit in (a.get("literal") or "").split(","):
        if lit:
            add(lit.encode())
    kept = total = 0
    with FastqWriter(out1) if out1 else _null() as w, (
        FastqWriter(outm) if outm else _null()
    ) as wm:
        for b in FastqReader(in1):
            hit = np.array(
                [
                    (b.sequence(i) if case else b.sequence(i).upper()) in seqs
                    for i in range(b.n)
                ],
                dtype=bool,
            )
            keep = hit if include else ~hit
            total += b.n
            kept += int(keep.sum())
            if out1:
                w.add(b, keep)
            if outm:
                wm.add(b, ~keep)
    print(f"Reads Processed:    \t{total}", file=sys.stderr)
    print(f"Reads Out:          \t{kept}", file=sys.stderr)
    return kept


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *e):
        pass

    def add(self, *a, **k):
        pass

    def close(self):
        pass


def _read_vcf_subs(path: str):
    """{(chrom, pos1, alt): (allele_depth, allele_fraction)} for SNPs."""
    out = {}
    with open_input(path) as fh:
        for line in fh.read().splitlines():
            if not line or line.startswith(b"#"):
                continue
            f = line.split(b"\t")
            if len(f) < 8 or len(f[3]) != 1 or len(f[4]) != 1:
                continue
            info = dict(
                kv.split(b"=", 1) for kv in f[7].split(b";") if b"=" in kv
            )
            ad = int(info.get(b"AD", b"0"))
            af = float(info.get(b"AF", b"0"))
            out[(f[0], int(f[1]), f[4])] = (ad, af)
    return out


def filtersam(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    inp = a.get("in", "in1")
    out = a.get("out")
    outb = a.get("outb")
    vcf = a.get("vcf", "vars")
    mbv = a.get_int("mbv", "maxbadvars", default=2)
    mbad = a.get_int("mbad", "maxbadalleledepth", default=2)
    mbaf = a.get_float("mbaf", "maxbadallelefraction", default=0.01)
    border = a.get_int("border", "minenddist", default=5)
    subs = _read_vcf_subs(vcf) if vcf else {}
    n_good = n_bad = 0
    wg = open_output(out) if out else None
    wb = open_output(outb) if outb else None
    with open_input(inp) as fh:
        for line in fh.read().splitlines():
            if line.startswith(b"@"):
                for w in (wg, wb):
                    if w:
                        w.write(line + b"\n")
                continue
            f = line.split(b"\t")
            bad = 0
            if len(f) > 9 and f[5] not in (b"*",) and subs:
                # walk the CIGAR to locate X/M positions; count read subs
                # that correspond to "bad" (low-support) VCF alleles
                pos = int(f[3])
                seq = f[9]
                ri = 0  # read index
                gp = pos  # genome position (1-based)
                num = 0
                for ch in f[5]:
                    c = chr(ch)
                    if c.isdigit():
                        num = num * 10 + int(c)
                        continue
                    if c in "M=X":
                        for t in range(num):
                            key = (f[2], gp + t, seq[ri + t : ri + t + 1])
                            if key in subs and border <= ri + t < len(seq) - border:
                                ad, af = subs[key]
                                if ad <= mbad or af <= mbaf:
                                    bad += 1
                        ri += num
                        gp += num
                    elif c in "IS":
                        ri += num
                    elif c in "DN":
                        gp += num
                    num = 0
            if bad > mbv:
                n_bad += 1
                if wb:
                    wb.write(line + b"\n")
            else:
                n_good += 1
                if wg:
                    wg.write(line + b"\n")
    for w in (wg, wb):
        if w:
            w.close()
    print(f"Good Reads:         \t{n_good}", file=sys.stderr)
    print(f"Bad Reads:          \t{n_bad}", file=sys.stderr)
    return n_good, n_bad


def countbarcodes(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    counts_out = a.get("counts", "out")
    expected = set(
        x.encode() for x in (a.get("expected") or "").split(",") if x
    )
    count_undef = a.get_bool("countundefined", default=True)
    printheader = a.get_bool("printheader", default=True)
    counts: dict[bytes, int] = {}
    total = 0
    for b in FastqReader(in1):
        for i in range(b.n):
            rid = b.ids[i]
            bc = rid.rsplit(b":", 1)[-1].split(b"/")[0].strip()
            if not bc:
                continue
            if not count_undef and any(c not in b"ACGT+" for c in bc):
                continue
            total += 1
            counts[bc] = counts.get(bc, 0) + 1
    rows = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    if counts_out:
        with open_output(counts_out) as fh:
            if printheader:
                fh.write(b"#barcode\tcount\texpected\n")
            for bc, c in rows:
                exp = b"1" if (not expected or bc in expected) else b"0"
                fh.write(b"%s\t%d\t%s\n" % (bc, c, exp))
    print(f"Barcodes Counted:   \t{total}", file=sys.stderr)
    print(f"Unique Barcodes:    \t{len(counts)}", file=sys.stderr)
    return counts


def _sam_sites(path: str):
    """READ name -> (pos1, end1) primer site. The primers are mapped
    AGAINST the reads, so the site's key is the SAM RNAME (the read) and
    the interval is the primer's aligned span on it."""
    sites = {}
    with open_input(path) as fh:
        for line in fh.read().splitlines():
            if line.startswith(b"@"):
                continue
            f = line.split(b"\t")
            if len(f) < 10 or int(f[1]) & 0x4:
                continue
            pos = int(f[3])
            reflen = 0
            num = 0
            for ch in f[5]:
                c = chr(ch)
                if c.isdigit():
                    num = num * 10 + int(c)
                    continue
                if c in "M=XDN":
                    reflen += num
                num = 0
            sites[f[2]] = (pos, pos + reflen - 1)
    return sites


def cutprimers(argv=None):
    """CutPrimers.java: sam1/sam2 map the two primers against the READS
    (each read is a reference sequence there); output the region between
    them."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    include = a.get_bool("include", default=False)
    fake = a.get_bool("fake", default=True)
    s1 = _sam_sites(a.get("sam1"))
    s2 = _sam_sites(a.get("sam2"))
    n_out = 0
    with FastqWriter(out1) as w:
        for b in FastqReader(in1):
            keep_seqs = []
            for i in range(b.n):
                rid = b.ids[i].split()[0]
                p1 = s1.get(rid)
                p2 = s2.get(rid)
                if p1 is None or p2 is None:
                    if fake:
                        keep_seqs.append((rid, b"N", b"!"))
                    continue
                if include:
                    lo, hi = p1[0], p2[1]
                else:
                    lo, hi = p1[1] + 1, p2[0] - 1
                seq = b.sequence(i)[lo - 1 : hi]
                q = b.quality_string(i)
                qual = q[lo - 1 : hi] if q else b"I" * max(hi - lo + 1, 0)
                if not seq:
                    if fake:
                        keep_seqs.append((rid, b"N", b"!"))
                    continue
                keep_seqs.append((rid, seq, qual))
                n_out += 1
            from ..io.batch import ReadBatch

            if keep_seqs:
                nb = ReadBatch.from_sequences(
                    [s for _, s, _ in keep_seqs],
                    quals=[q for _, _, q in keep_seqs],
                    ids=[n for n, _, _ in keep_seqs],
                    ordinal=b.ordinal,
                )
                w.add(nb)
    print(f"Reads Out:          \t{n_out}", file=sys.stderr)
    return n_out
