"""VCF utilities: filtervcf, applyvariants, vcf2gff.

References (semantics source, no code reuse):
  - var2/FilterVCF.java (filtervcf.sh) — filter VCF lines by position
    range / contig list (invertible), variant type (sub/ins/del), first
    sample genotype, and quality attributes; splitalleles= splits
    multi-allelic lines into one line per ALT.
  - var2/ApplyVariants.java (applyvariants.sh) — mutate a reference by
    applying a set of variants; "When 2 variants overlap, the one with
    the higher allele count is used" (AD info field, falling back to
    file order).
  - driver/Vcf2Gff.java (vcf2gff.sh) — convert VCF to GFF3.

Works on any VCF; the quality filters read the INFO keys our
CallVariants emits (TYP/AD/AF — models/callvariants.py write_vcf).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

from ..core.parser import parse_boolean, tokenize
from ..io.fasta import read_fasta, write_fasta, FastaRecord
from ..io.readwrite import open_input, open_output


@dataclass
class VcfRecord:
    chrom: bytes
    pos: int  # 1-based
    vid: bytes
    ref: bytes
    alt: bytes
    qual: bytes
    filt: bytes
    info: bytes
    rest: list[bytes] = field(default_factory=list)

    def line(self) -> bytes:
        cols = [
            self.chrom, b"%d" % self.pos, self.vid, self.ref, self.alt,
            self.qual, self.filt, self.info,
        ] + self.rest
        return b"\t".join(cols) + b"\n"

    def info_get(self, key: bytes) -> bytes | None:
        for part in self.info.split(b";"):
            if part.startswith(key + b"="):
                return part[len(key) + 1 :]
        return None

    def vtype(self) -> str:
        """sub/ins/del by REF/ALT lengths (TYP info used if present)."""
        t = self.info_get(b"TYP")
        if t:
            return t.decode().lower()
        if len(self.ref) == len(self.alt):
            return "sub"
        return "ins" if len(self.alt) > len(self.ref) else "del"


def read_vcf(path: str) -> tuple[list[bytes], list[VcfRecord]]:
    header: list[bytes] = []
    recs: list[VcfRecord] = []
    with open_input(path) as fh:
        for line in fh.read().splitlines():
            if not line:
                continue
            if line.startswith(b"#"):
                header.append(line)
                continue
            f = line.split(b"\t")
            recs.append(
                VcfRecord(
                    f[0], int(f[1]), f[2], f[3], f[4], f[5], f[6],
                    f[7] if len(f) > 7 else b".", list(f[8:]),
                )
            )
    return header, recs


def _read_bed(path: str) -> dict[bytes, list[tuple[int, int]]]:
    """BED intervals (0-based half-open) keyed by contig."""
    iv: dict[bytes, list[tuple[int, int]]] = {}
    with open_input(path) as fh:
        for line in fh.read().splitlines():
            if not line or line.startswith((b"#", b"track", b"browser")):
                continue
            f = line.split(b"\t")
            if len(f) < 3:
                continue
            iv.setdefault(f[0], []).append((int(f[1]), int(f[2])))
    for v in iv.values():
        v.sort()
    return iv


def filtervcf(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    minpos = a.get_int("minpos", default=-1)
    maxpos = a.get_int("maxpos", default=-1)
    contigs = a.get("contigs")
    invert = a.get_bool("invert", default=False)
    bed = a.get("bed")
    invertbed = a.get_bool("invertbed", default=False)
    keep_sub = a.get_bool("sub", default=True)
    keep_del = a.get_bool("del", default=True)
    keep_ins = a.get_bool("ins", default=True)
    gt = a.get("gt")
    hom = a.get("homozygous", "hom")
    splitalleles = a.get_bool("splitalleles", default=False)
    minreads = a.get_int("minreads", default=0)
    minqual = a.get_float("minqual", "minscore", default=0.0)
    minaf = a.get_float("minaf", default=0.0)
    maxaf = a.get_float("maxaf", default=1.0)

    contig_set = (
        {c.strip().encode() for c in contigs.split(",")} if contigs else None
    )
    bediv = _read_bed(bed) if bed else None
    gts = {g.strip().encode() for g in gt.split(",")} if gt else None

    header, recs = read_vcf(in1)
    kept: list[VcfRecord] = []
    for r in recs:
        if splitalleles and b"," in r.alt:
            parts = r.alt.split(b",")
            subs = [
                VcfRecord(
                    r.chrom, r.pos, r.vid, r.ref, p, r.qual, r.filt,
                    r.info, list(r.rest),
                )
                for p in parts
            ]
        else:
            subs = [r]
        for s in subs:
            # position filters (invertible as a group, FilterVCF semantics)
            pos_ok = True
            if minpos >= 0 and s.pos + max(len(s.ref) - 1, 0) < minpos:
                pos_ok = False
            if maxpos >= 0 and s.pos > maxpos:
                pos_ok = False
            if contig_set is not None and s.chrom not in contig_set:
                pos_ok = False
            if invert:
                pos_ok = not pos_ok
            if not pos_ok:
                continue
            if bediv is not None:
                inside = any(
                    a0 < s.pos <= b0 for a0, b0 in bediv.get(s.chrom, [])
                )
                if inside == invertbed:
                    continue
            t = s.vtype()
            if t.startswith("sub") and not keep_sub:
                continue
            if t.startswith("ins") and not keep_ins:
                continue
            if t.startswith("del") and not keep_del:
                continue
            if (gts is not None or hom is not None) and len(s.rest) >= 2:
                sample_gt = s.rest[1].split(b":")[0]
                if gts is not None and sample_gt not in gts:
                    continue
                if hom is not None:
                    alleles = set(sample_gt.replace(b"|", b"/").split(b"/"))
                    is_hom = len(alleles) == 1
                    if parse_boolean(hom) != is_hom:
                        continue
            if minreads > 0:
                ad = s.info_get(b"AD")
                if ad is not None and int(ad) < minreads:
                    continue
            if minqual > 0:
                try:
                    if float(s.qual) < minqual:
                        continue
                except ValueError:
                    pass
            af_s = s.info_get(b"AF")
            if af_s is not None:
                af = float(af_s)
                if af < minaf or af > maxaf:
                    continue
            kept.append(s)
    if out1:
        with open_output(out1) as fh:
            for line in header:
                fh.write(line + b"\n")
            for s in kept:
                fh.write(s.line())
    print(f"Kept {len(kept)} of {len(recs)} variants.", file=sys.stderr)
    return kept


def _allele_count(r: VcfRecord, order: int) -> tuple[int, int]:
    ad = r.info_get(b"AD")
    return (int(ad) if ad is not None else 0, -order)


def applyvariants(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    vcf = a.get("vcf")
    out1 = a.get("out", "out1")
    recs = read_fasta(in1)
    _, vars_ = read_vcf(vcf)

    by_chrom: dict[bytes, list[tuple[int, VcfRecord]]] = {}
    for i, v in enumerate(vars_):
        by_chrom.setdefault(v.chrom.split()[0], []).append((i, v))

    out_recs = []
    applied = skipped = 0
    for rec in recs:
        name = rec.name.split()[0]
        seq = rec.seq
        chosen: list[tuple[int, VcfRecord]] = []
        pending = sorted(by_chrom.get(name, []), key=lambda iv: iv[1].pos)
        for i, v in pending:
            start0 = v.pos - 1
            if chosen:
                pi, pv = chosen[-1]
                prev_end = (pv.pos - 1) + len(pv.ref)
                if start0 < prev_end:
                    # overlap: keep the variant with the higher allele count
                    if _allele_count(v, i) > _allele_count(pv, pi):
                        chosen[-1] = (i, v)
                    skipped += 1
                    continue
            chosen.append((i, v))
        pieces = []
        cur = 0
        for _, v in chosen:
            start0 = v.pos - 1
            pieces.append(seq[cur:start0])
            alt = v.alt.split(b",")[0]
            pieces.append(b"" if alt == b"." else alt)
            cur = start0 + len(v.ref)
            applied += 1
        pieces.append(seq[cur:])
        out_recs.append(FastaRecord(rec.name, b"".join(pieces)))
    if out1:
        write_fasta(out1, out_recs)
    print(
        f"Applied {applied} variants ({skipped} overlapping skipped).",
        file=sys.stderr,
    )
    return out_recs


_GFF_TYPES = {"sub": b"SNV", "ins": b"insertion", "del": b"deletion"}


def vcf2gff(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    _, recs = read_vcf(in1)
    lines = [b"##gff-version 3\n"]
    for r in recs:
        t = r.vtype()[:3]
        gt = _GFF_TYPES.get(t, b"sequence_variant")
        # GFF is 1-based inclusive; deletions span the removed ref bases
        start = r.pos
        end = r.pos + max(len(r.ref) - 1, 0)
        attrs = b"ID=%s;REF=%s;ALT=%s" % (
            r.vid if r.vid != b"." else b"%s_%d" % (r.chrom, r.pos),
            r.ref, r.alt,
        )
        lines.append(
            b"%s\tbbtools_torch\t%s\t%d\t%d\t%s\t.\t.\t%s\n"
            % (r.chrom, gt, start, end, r.qual, attrs)
        )
    if out1:
        with open_output(out1) as fh:
            fh.writelines(lines)
    return lines


def invertvcf(argv=None):
    """InvertVCF (invertvcf.sh) — invert a mutate.sh VCF: swap REF/ALT,
    flip INS<->DEL in the INFO TYP= field, and shift POS (and STA=/STO=)
    by the cumulative indel length delta so coordinates move from
    original-genome space to mutated-genome space. Mirrors
    var2/InvertVCF.java process() :91-214 (per-chrom cumulative shift,
    ##contig length adjustment by the chrom's net shift).
    """
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    out1 = a.get("out", "out1")
    with open_input(in1) as fh:
        lines = [l for l in fh.read().splitlines() if l]
    header = [l for l in lines if l.startswith(b"#")]
    data = [l for l in lines if not l.startswith(b"#")]

    net_shift: dict[bytes, int] = {}
    for line in data:
        f = line.split(b"\t")
        net_shift[f[0]] = net_shift.get(f[0], 0) + len(f[4]) - len(f[3])

    out_lines = []
    for h in header:
        if h.startswith(b"##contig=<ID="):
            body = h[len(b"##contig=<ID="):]
            cid = body.split(b",")[0].split(b">")[0]
            shift = net_shift.get(cid, 0)
            import re as _re

            def _adj(m, shift=shift):
                return b"length=%d" % (int(m.group(1)) + shift)

            h = _re.sub(rb"length=(\d+)", _adj, h)
            out_lines.append(h)
        elif h.startswith(b"##Program="):
            out_lines.append(h)
            out_lines.append(b"##InvertedBy=InvertVCF")
        else:
            out_lines.append(h)

    prev_chrom, cum = None, 0
    for line in data:
        f = line.split(b"\t")
        if f[0] != prev_chrom:
            cum, prev_chrom = 0, f[0]
        ref, alt = f[3], f[4]
        new_info_parts = []
        for part in f[7].split(b";"):
            if part.startswith(b"STA="):
                new_info_parts.append(b"STA=%d" % (int(part[4:]) + cum))
            elif part.startswith(b"STO="):
                new_info_parts.append(b"STO=%d" % (int(part[4:]) + cum))
            elif part == b"TYP=INS":
                new_info_parts.append(b"TYP=DEL")
            elif part == b"TYP=DEL":
                new_info_parts.append(b"TYP=INS")
            else:
                new_info_parts.append(part)
        f[1] = b"%d" % (int(f[1]) + cum)
        f[3], f[4] = alt, ref
        f[7] = b";".join(new_info_parts)
        cum += len(alt) - len(ref)
        out_lines.append(b"\t".join(f))

    blob = b"\n".join(out_lines) + b"\n"
    if out1:
        with open_output(out1) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    print(
        f"Header Lines Out:  \t{len(header) + sum(1 for l in out_lines if l.startswith(b'##InvertedBy'))}",
        file=sys.stderr,
    )
    print(f"Variant Lines Out: \t{len(data)}", file=sys.stderr)
    return out_lines


if __name__ == "__main__":
    filtervcf()
