"""SAM stream utilities: splitsam (3/4/6-way), mergesam, samtoroc.

References (semantics source, no code reuse):
  - driver/SplitSamFile.java (splitsam.sh) — split a SAM into
    plus-mapped / minus-mapped / unmapped streams; positional usage
    `splitsam <in> <plus> <minus> <unmapped> [header]`; the 4way variant
    adds a chimeric stream (mapped pair on different contigs), the 6way
    variant splits by read-1/read-2 as well.
  - driver/MergeSamFiles.java (mergesam.sh) — concatenate SAM files,
    keeping only the first file's header.
  - samtoroc.sh (align2/SamToRoc role) — from a SAM of synthetic reads
    with RandomReads truth headers, emit a ROC table of cumulative
    true/false mappings by descending MAPQ threshold (thresh=20 bp
    positional tolerance, utils/synth.parse_truth header format).
"""

from __future__ import annotations

import sys

from ..core.parser import tokenize
from ..io.readwrite import open_input, open_output
from ..io.sam_read import parse_cigar
from ..utils.synth import parse_truth


def _iter_lines(path: str):
    with open_input(path) as fh:
        for line in fh:
            if line.strip():
                yield line if line.endswith(b"\n") else line + b"\n"


def splitsam(argv=None, way: int = 3):
    argv = argv if argv is not None else sys.argv[1:]
    pos = [t for t in argv if "=" not in t]
    a = tokenize([t for t in argv if "=" in t])
    keep_header = "header" in pos
    pos = [p for p in pos if p != "header"]
    inp = a.get("in", "in1") or (pos[0] if pos else None)
    outs = pos[1:] if pos else []
    if way == 3:
        names = ["plus", "minus", "unmapped"]
    elif way == 4:
        names = ["plus", "minus", "chimeric", "unmapped"]
    else:
        names = ["r1plus", "r1minus", "r1unmapped",
                 "r2plus", "r2minus", "r2unmapped"]
    paths = {n: (outs[i] if i < len(outs) else a.get(n)) for i, n in enumerate(names)}
    handles = {n: open_output(p) for n, p in paths.items() if p}
    counts = dict.fromkeys(names, 0)
    for line in _iter_lines(inp):
        if line.startswith(b"@"):
            if keep_header:
                for fh in handles.values():
                    fh.write(line)
            continue
        f = line.split(b"\t", 8)
        flag = int(f[1])
        unmapped = bool(flag & 0x4)
        minus = bool(flag & 0x10)
        if way == 6:
            pre = "r2" if flag & 0x80 else "r1"
            key = pre + ("unmapped" if unmapped else "minus" if minus else "plus")
        elif way == 4:
            rnext = f[6]
            chimeric = (not unmapped) and rnext not in (b"=", b"*") and rnext != f[2]
            key = (
                "unmapped" if unmapped
                else "chimeric" if chimeric
                else "minus" if minus else "plus"
            )
        else:
            key = "unmapped" if unmapped else "minus" if minus else "plus"
        counts[key] += 1
        if key in handles:
            handles[key].write(line)
    for fh in handles.values():
        fh.close()
    print(
        "  ".join(f"{n}: {counts[n]}" for n in names), file=sys.stderr
    )
    return counts


def mergesam(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    a = tokenize([t for t in argv if "=" in t])
    files = [t for t in argv if "=" not in t]
    spec = a.get("in", "in1")
    if spec:
        files = spec.split(",") + files
    out1 = a.get("out", "out1")
    n = 0
    with open_output(out1) as fh:
        for fi, path in enumerate(files):
            for line in _iter_lines(path):
                if line.startswith(b"@"):
                    if fi == 0:
                        fh.write(line)
                    continue
                fh.write(line)
                n += 1
    print(f"Merged {n} alignments from {len(files)} files.", file=sys.stderr)
    return n


def _clip_adjusted_start(pos: int, cigar: str) -> int:
    """0-based leftmost read-base position (undo leading soft clip)."""
    start = pos - 1
    for n, op in parse_cigar(cigar):
        if op in "SH":
            start -= n
        else:
            break
    return start


def samtoroc(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    thresh = a.get_int("thresh", default=20)
    total = a.get_int("reads", default=0)
    use_bitset = a.get_bool("bitset", default=True)

    # per-mapq buckets of (true, loose, false) primary alignments
    buckets: dict[int, list[int]] = {}
    seen: set[bytes] = set()
    sq_index: dict[bytes, int] = {}  # RNAME -> scaffold index (@SQ order)
    n_lines = unmapped = 0
    for line in _iter_lines(in1):
        if line.startswith(b"@"):
            if line.startswith(b"@SQ"):
                for col in line.split(b"\t"):
                    if col.startswith(b"SN:"):
                        sq_index[col[3:].strip()] = len(sq_index)
            continue
        f = line.split(b"\t")
        flag = int(f[1])
        if flag & 0x100 or flag & 0x800:
            continue
        qname = f[0]
        if use_bitset:
            key = qname + (b"/2" if flag & 0x80 else b"/1")
            if key in seen:
                continue
            seen.add(key)
        n_lines += 1
        if flag & 0x4:
            unmapped += 1
            continue
        mapq = int(f[4])
        try:
            scaf_t, pos_t, strand_t = parse_truth(qname)
        except Exception:
            continue
        start = _clip_adjusted_start(int(f[3]), f[5].decode())
        strand = 1 if flag & 0x10 else 0
        same_scaf = sq_index.get(f[2].split()[0], -1) == scaf_t
        strict = same_scaf and strand == strand_t and abs(start - pos_t) <= 1
        loose = same_scaf and strand == strand_t and abs(start - pos_t) <= thresh
        b = buckets.setdefault(mapq, [0, 0, 0])
        if strict:
            b[0] += 1
        elif loose:
            b[1] += 1
        else:
            b[2] += 1
    total = total or (n_lines)
    lines = [b"#mapq\tmapped\ttrueStrict\ttrueLoose\tfalse\ttruePct\tfalsePct\n"]
    ct = cl = cf = 0
    for q in sorted(buckets, reverse=True):
        t, l, fcnt = buckets[q]
        ct += t
        cl += l
        cf += fcnt
        mapped = ct + cl + cf
        lines.append(
            b"%d\t%d\t%d\t%d\t%d\t%.4f\t%.4f\n"
            % (
                q, mapped, ct, ct + cl, cf,
                100.0 * (ct + cl) / max(total, 1),
                100.0 * cf / max(total, 1),
            )
        )
    text = b"".join(lines)
    if out1:
        with open_output(out1) as fh:
            fh.write(text)
    else:
        sys.stdout.buffer.write(text)
    return buckets


def dedupebymapping(argv=None):
    """DedupeByMapping (dedupebymapping.sh) — remove duplicate reads by
    pair mapping coordinates. Mirrors jgi/DedupeByMapping.java: pairs
    are keyed by the 5'-end position+contig of each mate (toQuad :444 —
    strand 0 uses start, strand 1 uses stop; ignorepairorder sorts the
    two halves), and the pair with the lowest expected-error rate per
    base wins (:260). Unmapped pairs and half-mapped singletons are kept
    by default (keepunmapped/keepsingletons).
    """
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    keep_unmapped = a.get_bool("keepunmapped", "ku", default=True)
    keep_singletons = a.get_bool("keepsingletons", "ks", default=True)
    use_pair_order = not a.get_bool("ignorepairorder", "ipo", default=False)

    from ..io.sam_read import iter_sam, parse_cigar

    def coords(rec):
        """(chrom, unclipped_start, unclipped_stop, strand); chrom=-1
        for unmapped."""
        if not rec.mapped:
            return (-1, -1, -1, 0)
        ops = parse_cigar(rec.cigar)
        lead = ops[0][0] if ops and ops[0][1] in "SH" else 0
        tail = ops[-1][0] if ops and ops[-1][1] in "SH" else 0
        span = sum(n for n, op in ops if op in "M=XDN")
        start = rec.pos - 1 - lead
        return (rec.rname, start, start + lead + span + tail - 1, rec.strand)

    def exp_errors(qual):
        return sum(10.0 ** (-(q - 33) / 10.0) for q in qual)

    # pair up primary records by name
    by_name: dict[bytes, list] = {}
    for rec in iter_sam(in1):
        if rec.secondary:
            continue
        by_name.setdefault(rec.qname, []).append(rec)

    kept, dups, unmapped_n = [], 0, 0
    quad_best: dict[tuple, tuple] = {}
    for name, recs in by_name.items():
        recs = recs[:2]
        c = [coords(r) for r in recs]
        n_mapped = sum(1 for x in c if x[0] != -1)
        if n_mapped == 0:
            unmapped_n += len(recs)
            if keep_unmapped:
                kept.extend(recs)
            continue
        if len(recs) == 2 and n_mapped == 1 and keep_singletons:
            kept.extend(recs)
            continue
        halves = []
        for (chrom, start, stop, strand) in c:
            halves.append((chrom, start if strand == 0 else stop))
        while len(halves) < 2:
            halves.append((0, 0))
        if not use_pair_order:
            halves.sort()
        quad = (halves[0], halves[1])
        rate = sum(exp_errors(r.qual) for r in recs) / max(
            1, sum(len(r.seq) for r in recs)
        )
        old = quad_best.get(quad)
        if old is None or rate < old[0]:
            if old is not None:
                dups += len(old[1])
            quad_best[quad] = (rate, recs)
        else:
            dups += len(recs)
    for rate, recs in quad_best.values():
        kept.extend(recs)

    comp = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")
    if out1:
        as_sam = out1.endswith(".sam")
        with open_output(out1) as fh:
            if as_sam:
                with open_input(in1) as src:
                    for line in src:
                        if line.startswith(b"@"):
                            fh.write(line)
                        else:
                            break
            for rec in kept:
                if as_sam:
                    fh.write(
                        b"%s\t%d\t%s\t%d\t%d\t%s\t*\t0\t0\t%s\t%s\n"
                        % (
                            rec.qname, rec.flag, rec.rname, rec.pos,
                            rec.mapq, rec.cigar.encode(), rec.seq, rec.qual,
                        )
                    )
                else:
                    seq, qual = rec.seq, rec.qual
                    if rec.mapped and rec.strand:
                        seq = seq.translate(comp)[::-1]
                        qual = qual[::-1]
                    fh.write(
                        b"@" + rec.qname + b"\n" + seq + b"\n+\n" + qual
                        + b"\n"
                    )
    print(
        f"Reads kept: {len(kept)}  duplicates: {dups}  "
        f"unmapped: {unmapped_n}", file=sys.stderr,
    )
    return kept, dups


if __name__ == "__main__":
    splitsam()


def samtoest(argv=None):
    """SamToEst / bbest.sh (jgi/SamToEst.java) — EST capture statistics
    from a SAM of ESTs mapped to an assembly. Per EST (query) the
    matched-base count drives the capture class (:403-419): `all` when
    match >= fraction*length (fraction=0.98), `most` >= length/2,
    `some` > 0, else `none`; multi-scaffold ESTs (primary alignments on
    >1 scaffold) are counted separately. Output mirrors the new-style
    key=value block + the type/n_est/pct table (:300-312)."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1", "sam")
    out1 = a.get("out", "stats")
    ref = a.get("ref", default="") or ""
    est_file = a.get("est", default="") or ""
    fraction = a.get_float("fraction", default=0.98)

    from ..io.sam_read import iter_sam, parse_cigar

    match: dict[bytes, int] = {}
    length: dict[bytes, int] = {}
    scafs: dict[bytes, set] = {}
    for rec in iter_sam(in1):
        L = len(rec.seq) if rec.seq != b"*" else 0
        if rec.qname not in length or L > length[rec.qname]:
            length[rec.qname] = L
        if not rec.mapped:
            match.setdefault(rec.qname, 0)
            continue
        m = sum(n for n, op in parse_cigar(rec.cigar) if op in "M=")
        match[rec.qname] = match.get(rec.qname, 0) + m
        scafs.setdefault(rec.qname, set()).add(rec.rname)
    est_count = len(match)
    est_bases = sum(length.values())
    cls = {b"all": [0, 0], b"most": [0, 0], b"some": [0, 0],
           b"none": [0, 0]}
    multi = [0, 0]
    for q, m in match.items():
        L = length.get(q, 0)
        if len(scafs.get(q, ())) > 1:
            multi[0] += 1
            multi[1] += L
        if L and m >= L * fraction:
            key = b"all"
        elif L and m >= L / 2:
            key = b"most"
        elif m > 0:
            key = b"some"
        else:
            key = b"none"
        cls[key][0] += 1
        cls[key][1] += L
    me = 100.0 / max(est_count, 1)
    mb = 100.0 / max(est_bases, 1)
    lines = [
        b"ref_file=%s" % ref.encode(),
        b"est_file=%s" % est_file.encode(),
        b"sam_file=%s" % in1.encode(),
        b"n_est=%d" % est_count,
        b"n_est_bases=%d" % est_bases,
        b"type\tn_est\tpct_est\tn_bases\tpct_bases",
    ]
    for key in (b"all", b"most", b"some", b"none"):
        n, bs = cls[key]
        lines.append(
            b"%s\t%d\t%.2f\t%d\t%.2f" % (key, n, n * me, bs, bs * mb)
        )
    lines.append(
        b"multi_scaffold\t%d\t%.2f\t%d\t%.2f"
        % (multi[0], multi[0] * me, multi[1], multi[1] * mb)
    )
    blob = b"\n".join(lines) + b"\n"
    if out1:
        with open_output(out1) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return cls
