"""GFF utilities: cutgff, comparegff.

References (semantics source, no code reuse):
  - gff/CutGff.java (cutgff.sh) — cut features of types= (default CDS)
    out of a fasta and emit them sense-strand, gated by minlen/maxlen
    and attributes= substring match; invert=t masks the features with Ns
    in the original sequences instead.
  - gff/CompareGff.java (comparegff.sh) — compare a query gff against a
    reference gff: per feature type, how many query lines match a
    reference line exactly (start+stop+strand), stop-only (same
    stop+strand — correct ORF, different start call), or not at all.
"""

from __future__ import annotations

import sys

from ..core.parser import tokenize
from ..io.fasta import FastaRecord, read_fasta, write_fasta
from ..io.readwrite import open_input, open_output

RC = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def _read_gff(path: str):
    rows = []
    with open_input(path) as fh:
        for line in fh.read().splitlines():
            if not line or line.startswith(b"#"):
                continue
            f = line.split(b"\t")
            if len(f) < 8:
                continue
            rows.append(
                {
                    "seqid": f[0], "type": f[2], "start": int(f[3]),
                    "stop": int(f[4]), "strand": f[6],
                    "attrs": f[8] if len(f) > 8 else b"",
                }
            )
    return rows


def cutgff(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    a = tokenize([t for t in argv if "=" in t])
    pos = [t for t in argv if "=" not in t]
    in1 = a.get("in", "in1") or (pos[0] if pos else None)
    gff = a.get("gff")
    if not gff and in1:
        # reference convention: assume the gff next to the fasta
        stem = in1
        for ext in (".fna.gz", ".fna", ".fa.gz", ".fa", ".fasta"):
            if stem.endswith(ext):
                stem = stem[: -len(ext)]
                break
        gff = stem + ".gff"
    out1 = a.get("out", "out1")
    types = {
        t.strip().encode()
        for t in (a.get("types", default="CDS") or "CDS").split(",")
    }
    minlen = a.get_int("minlen", default=1)
    maxlen = a.get_int("maxlen", default=1 << 60)
    invert = a.get_bool("invert", default=False)
    attrs = [
        s.encode() for s in (a.get("attributes") or "").split(",") if s
    ]

    seqs = {r.name.split()[0]: r for r in read_fasta(in1)}
    rows = _read_gff(gff)
    out_recs = []
    masked = {k: bytearray(v.seq) for k, v in seqs.items()} if invert else None
    n = 0
    for r in rows:
        if r["type"] not in types:
            continue
        length = r["stop"] - r["start"] + 1
        if not (minlen <= length <= maxlen):
            continue
        if attrs and not any(s in r["attrs"] for s in attrs):
            continue
        rec = seqs.get(r["seqid"])
        if rec is None:
            continue
        n += 1
        if invert:
            masked[r["seqid"]][r["start"] - 1 : r["stop"]] = (
                b"N" * length
            )
            continue
        piece = rec.seq[r["start"] - 1 : r["stop"]]
        if r["strand"] == b"-":
            piece = piece.translate(RC)[::-1]
        out_recs.append(
            FastaRecord(
                b"%s_%d_%d_%s" % (
                    r["seqid"], r["start"], r["stop"], r["type"]
                ),
                piece,
            )
        )
    if invert:
        out_recs = [
            FastaRecord(seqs[k].name, bytes(v)) for k, v in masked.items()
        ]
    if out1:
        write_fasta(out1, out_recs)
    print(f"Features: {n}", file=sys.stderr)
    return out_recs


def comparegff(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    refp = a.get("ref")
    out1 = a.get("out")
    types = {b"CDS", b"rRNA", b"tRNA"}
    q = [r for r in _read_gff(in1) if r["type"] in types]
    ref = [r for r in _read_gff(refp) if r["type"] in types]

    def key_exact(r):
        return (r["seqid"], r["type"], r["start"], r["stop"], r["strand"])

    def key_stop(r):
        # the strand-aware "stop" is the 3' end: stop on +, start on -
        end3 = r["stop"] if r["strand"] != b"-" else r["start"]
        return (r["seqid"], r["type"], end3, r["strand"])

    ref_exact = {key_exact(r) for r in ref}
    ref_stop = {key_stop(r) for r in ref}
    lines = [b"#type\tquery\tref\texact\tstopOnly\tfalsePositive\trefRecall\n"]
    results = {}
    for t in sorted(types):
        qt = [r for r in q if r["type"] == t]
        rt = [r for r in ref if r["type"] == t]
        exact = sum(1 for r in qt if key_exact(r) in ref_exact)
        stop_only = sum(
            1
            for r in qt
            if key_exact(r) not in ref_exact and key_stop(r) in ref_stop
        )
        fp = len(qt) - exact - stop_only
        recall = (exact + stop_only) / max(len(rt), 1)
        results[t] = (len(qt), len(rt), exact, stop_only, fp, recall)
        lines.append(
            b"%s\t%d\t%d\t%d\t%d\t%d\t%.4f\n"
            % (t, len(qt), len(rt), exact, stop_only, fp, recall)
        )
    blob = b"".join(lines)
    if out1:
        with open_output(out1) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return results


if __name__ == "__main__":
    cutgff()


def gbff2gff(argv=None):
    """gbff2gff.sh (gff/GbffFile.java toGff :62) — convert a GenBank
    flat file to GFF3. Emits the gff-version/column header, a
    `##sequence-region <accession> 1 <length>` line per locus, and one
    9-column row per CDS/tRNA/rRNA feature (GbffLocus.toGff :374 prints
    only those types, skipping pseudo), with seqid=accession, source '.',
    strand from complement(...) joins, and product=/locus_tag=
    attributes (GbffFeature.appendGff :189).
    """
    import re

    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    lines_out = [
        b"##gff-version 3",
        b"#seqid\tsource\ttype\tstart\tend\tscore\tstrand\tphase\tattributes",
    ]
    wanted = {b"CDS", b"tRNA", b"rRNA"}
    accession = None
    length = 0
    feats: list = []
    cur = None  # [type, location_str, {quals}]
    in_features = in_origin = False

    def flush_locus():
        nonlocal feats, accession
        if accession is None:
            return
        lines_out.append(
            b"##sequence-region %s 1 %d" % (accession, length)
            if length
            else b"##sequence-region " + accession
        )
        for ftype, loc, quals in feats:
            if ftype not in wanted or b"pseudo" in quals:
                continue
            strand = b"-" if b"complement" in loc else b"+"
            coords = [int(x) for x in re.findall(rb"\d+", loc)]
            if not coords:
                continue
            attrs = []
            if b"product" in quals:
                attrs.append(b"product=" + quals[b"product"])
            if b"locus_tag" in quals:
                attrs.append(b"locus_tag=" + quals[b"locus_tag"])
            lines_out.append(
                b"%s\t.\t%s\t%d\t%d\t.\t%s\t.\t%s"
                % (
                    accession, ftype, min(coords), max(coords), strand,
                    b";".join(attrs) or b".",
                )
            )
        feats = []
        accession = None

    with open_input(in1) as fh:
        for raw in fh.read().splitlines():
            if raw.startswith(b"LOCUS"):
                flush_locus()
                f = raw.split()
                length = int(f[2]) if len(f) > 2 and f[2].isdigit() else 0
                accession = f[1] if len(f) > 1 else b"?"
                in_features = in_origin = False
                cur = None
            elif raw.startswith(b"ACCESSION"):
                f = raw.split()
                if len(f) > 1:
                    accession = f[1]
            elif raw.startswith(b"FEATURES"):
                in_features, in_origin = True, False
            elif raw.startswith(b"ORIGIN") or raw.startswith(b"//"):
                in_features, in_origin = False, True
                if cur:
                    feats.append(cur)
                    cur = None
            elif in_features and raw[:1].isspace():
                stripped = raw.strip()
                if not stripped:
                    continue
                indent = len(raw) - len(raw.lstrip())
                if indent < 10 and not stripped.startswith(b"/"):
                    # new feature: "  CDS   complement(a..b)"
                    if cur:
                        feats.append(cur)
                    f = stripped.split(None, 1)
                    cur = [f[0], f[1] if len(f) > 1 else b"", {}]
                elif cur is not None:
                    if stripped.startswith(b"/"):
                        kv = stripped[1:].split(b"=", 1)
                        key = kv[0]
                        val = (
                            kv[1].strip(b'"') if len(kv) > 1 else b""
                        )
                        cur[2][key] = val
                    elif b".." in stripped and not cur[2]:
                        cur[1] += stripped  # continuation of location
    flush_locus()
    blob = b"\n".join(lines_out) + b"\n"
    if out1:
        with open_output(out1) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    print(f"Wrote {len(lines_out) - 2} gff lines.", file=sys.stderr)
    return lines_out
