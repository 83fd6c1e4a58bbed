"""File format + compression detection from extension and content.

Capability parity with fileIO/FileFormat.java:139 (testInput: extension
first, then content sniffing for extensionless/misnamed files). Formats we
recognize: FASTQ, FASTA, SAM, BAM, VCF, GFF, plus raw text; compression:
gzip (.gz), bgzf (detected inside gzip header), bzip2 (.bz2), zstd (.zst,
host-gated), none. stdin/stdout markers supported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from enum import Enum


class Format(Enum):
    FASTQ = "fastq"
    FASTA = "fasta"
    SAM = "sam"
    BAM = "bam"
    VCF = "vcf"
    GFF = "gff"
    TEXT = "text"
    UNKNOWN = "unknown"


class Compression(Enum):
    NONE = "none"
    GZIP = "gz"
    BGZF = "bgzf"
    BZIP2 = "bz2"
    ZSTD = "zst"


_EXT_FORMAT = {
    "fq": Format.FASTQ, "fastq": Format.FASTQ,
    "fa": Format.FASTA, "fasta": Format.FASTA, "fna": Format.FASTA,
    "ffn": Format.FASTA, "frn": Format.FASTA, "faa": Format.FASTA,
    "fas": Format.FASTA, "ref": Format.FASTA,
    "sam": Format.SAM, "bam": Format.BAM,
    "vcf": Format.VCF, "gff": Format.GFF, "gff3": Format.GFF,
    "txt": Format.TEXT,
}

_EXT_COMPRESSION = {
    "gz": Compression.GZIP, "gzip": Compression.GZIP,
    "bz2": Compression.BZIP2, "zst": Compression.ZSTD,
    "bgz": Compression.BGZF, "bgzf": Compression.BGZF,
}


@dataclass(frozen=True)
class FileFormat:
    path: str
    format: Format
    compression: Compression
    interleaved: bool = False
    stdio: bool = False

    @property
    def is_fastx(self) -> bool:
        return self.format in (Format.FASTQ, Format.FASTA)


def _split_ext(path: str) -> tuple[str | None, str | None]:
    """Return (compression_ext, format_ext), both lowercase or None."""
    name = os.path.basename(path).lower()
    parts = name.split(".")
    comp = fmt = None
    if len(parts) > 1 and parts[-1] in _EXT_COMPRESSION:
        comp = parts[-1]
        parts = parts[:-1]
    if len(parts) > 1 and parts[-1] in _EXT_FORMAT:
        fmt = parts[-1]
    return comp, fmt


def sniff_content(head: bytes) -> tuple[Format, Compression]:
    """Detect format/compression from the first bytes of a file."""
    comp = Compression.NONE
    if head[:2] == b"\x1f\x8b":
        comp = Compression.GZIP
        # BGZF: gzip with FEXTRA and a 'BC' subfield (SAM spec §4.1)
        if len(head) >= 18 and head[3] == 4 and head[12:14] == b"BC":
            comp = Compression.BGZF
        return Format.UNKNOWN, comp  # caller must decompress to sniff format
    if head[:3] == b"BZh":
        return Format.UNKNOWN, Compression.BZIP2
    if head[:4] == b"\x28\xb5\x2f\xfd":
        return Format.UNKNOWN, Compression.ZSTD
    if head[:4] == b"BAM\x01":
        return Format.BAM, comp
    text = head
    if text[:1] == b"@":
        # SAM header lines start with @HD/@SQ/@RG/@PG/@CO; FASTQ with @name
        if text[1:3] in (b"HD", b"SQ", b"RG", b"PG", b"CO") and b"\t" in text[:64]:
            return Format.SAM, comp
        return Format.FASTQ, comp
    if text[:1] == b">":
        return Format.FASTA, comp
    if text[:2] == b"##":
        if b"fileformat=VCF" in text[:128]:
            return Format.VCF, comp
        if b"gff" in text[:64]:
            return Format.GFF, comp
    return Format.TEXT if text else Format.UNKNOWN, comp


def test_input(path: str, allow_content: bool = True) -> FileFormat:
    """Detect an input file's format, like FileFormat.testInput."""
    if path in ("stdin", "-", "/dev/stdin"):
        return FileFormat(path, Format.FASTQ, Compression.NONE, stdio=True)
    comp_ext, fmt_ext = _split_ext(path)
    comp = _EXT_COMPRESSION.get(comp_ext) if comp_ext else None
    fmt = _EXT_FORMAT.get(fmt_ext) if fmt_ext else None
    if (fmt is None or comp is None) and allow_content and os.path.exists(path):
        with open(path, "rb") as fh:
            head = fh.read(256)
        sfmt, scomp = sniff_content(head)
        if comp is None:
            comp = scomp
        if fmt is None:
            if scomp is not Compression.NONE:
                # decompress a little to sniff the inner format
                try:
                    import gzip

                    with gzip.open(path, "rb") as gz:
                        sfmt, _ = sniff_content(gz.read(256))
                except OSError:
                    sfmt = Format.UNKNOWN
            fmt = sfmt
    return FileFormat(path, fmt or Format.UNKNOWN, comp or Compression.NONE)


def test_output(path: str) -> FileFormat:
    """Detect an output file's intended format from its name only."""
    if path in ("stdout", "-", "/dev/stdout"):
        return FileFormat(path, Format.FASTQ, Compression.NONE, stdio=True)
    comp_ext, fmt_ext = _split_ext(path)
    return FileFormat(
        path,
        _EXT_FORMAT.get(fmt_ext, Format.UNKNOWN) if fmt_ext else Format.UNKNOWN,
        _EXT_COMPRESSION.get(comp_ext, Compression.NONE) if comp_ext else Compression.NONE,
    )
