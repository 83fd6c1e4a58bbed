"""Illumina CBCL plumbing — cbcl2text.sh (illumina/ package).

Reference: illumina/Cbcl2Text.java + CbclHeader/CbclDecoder/FilterReader/
LocsReader. Formats (all little-endian):
  - CBCL header (CbclHeader.java:31-95): version u16, headerSize u32,
    bitsPerBasecall u8, bitsPerQscore u8, numQscoreBins u32, then
    numQscoreBins bin boundaries (u32 each), numQscoreBins remap values
    (u32 each), numTiles u32, then per tile (tileNumber u32,
    clusterCount u32). Compressed data starts at headerSize.
  - CBCL data: one gzip stream; each byte packs two clusters, LSB first:
    bits0-1 base A (00=A 01=C 10=G 11=T), bits2-3 qual-bin A, bits4-5
    base B, bits6-7 qual-bin B; byte 0x00 = no-call (CbclDecoder:9-19).
    (Like the reference decoder, one tile per cbcl file is assumed.)
  - s.locs (LocsReader.java:10): 12-byte header with cluster count as
    u32 at offset 8, then 2 float32 (x, y) per cluster.
  - .filter (FilterReader.java:32-45): 12-byte header ending in cluster
    count u32, then one byte per cluster (LSB = pass).
  - Layout: <run>/Data/Intensities/BaseCalls/L00<lane>/C<cycle>.1/
    L00<lane>_<surface>.cbcl, filters s_<lane>_<tile>.filter, positions
    <run>/Data/Intensities/s.locs.
"""

from __future__ import annotations

import glob
import gzip
import os
import struct
import sys

import numpy as np

from ..core.parser import tokenize


def read_cbcl_header(path: str):
    with open(path, "rb") as fh:
        version, header_size, bits_base, bits_q = struct.unpack(
            "<HiBB", fh.read(8))
        (nbins,) = struct.unpack("<i", fh.read(4))
        rest = fh.read(header_size - 12)
    off = 0
    bins = struct.unpack_from(f"<{nbins}i", rest, off)
    off += 4 * nbins
    remap = struct.unpack_from(f"<{nbins}i", rest, off)
    off += 4 * nbins
    (ntiles,) = struct.unpack_from("<i", rest, off)
    off += 4
    tiles = {}
    for _ in range(ntiles):
        tnum, nclust = struct.unpack_from("<ii", rest, off)
        off += 8
        tiles[tnum] = nclust
    return {
        "version": version, "headerSize": header_size,
        "bitsPerBase": bits_base, "bitsPerQ": bits_q,
        "bins": list(bins), "remap": list(remap), "tiles": tiles,
    }


def read_cbcl_tile(path: str, tile: int):
    """-> (bases ascii uint8 [n], quals phred int [n])."""
    hdr = read_cbcl_header(path)
    if tile not in hdr["tiles"]:
        raise ValueError(f"Tile {tile} not in {path}")
    n = hdr["tiles"][tile]
    with open(path, "rb") as fh:
        fh.seek(hdr["headerSize"])
        raw = gzip.decompress(fh.read())
    data = np.frombuffer(raw, np.uint8)
    # two clusters per byte, LSB first
    lo = data & 0x0F
    hi = data >> 4
    packed = np.empty(len(data) * 2, np.uint8)
    packed[0::2] = lo
    packed[1::2] = hi
    packed = packed[:n]
    base_codes = packed & 0b11
    qbins = (packed >> 2) & 0b11
    remap = np.array(hdr["remap"] or [0], np.int64)
    quals = remap[np.minimum(qbins, len(remap) - 1)]
    bases = np.frombuffer(b"ACGT", np.uint8)[base_codes].copy()
    # 0x00 byte = no-call; base A with qual bin 0 is indistinguishable
    # in-packed, so the reference treats raw byte 0 as N
    nocall = packed == 0
    bases[nocall] = ord("N")
    quals = np.where(nocall, 0, quals)
    return bases, quals


def read_locs(path: str):
    with open(path, "rb") as fh:
        head = fh.read(12)
        (n,) = struct.unpack_from("<i", head, 8)
        data = np.frombuffer(fh.read(8 * n), "<f4").reshape(n, 2)
    return data


def read_filter(path: str):
    with open(path, "rb") as fh:
        head = fh.read(12)
        (n,) = struct.unpack_from("<i", head, 8)
        flags = np.frombuffer(fh.read(n), np.uint8)
    return (flags & 1) == 1


def cbcl2text_main(args):
    a = tokenize(args)
    run = a.get("runfolder", "run", "in")
    out = a.get("out", "out1")
    lane = int(a.get("lane", default="1"))
    if not run or not out:
        print("Usage: cbcl2text runfolder=<path> out=<txt|fq> lane=<int>"
              " [tiles=<list>]", file=sys.stderr)
        return 1
    basecalls = os.path.join(run, "Data", "Intensities", "BaseCalls",
                             f"L{lane:03d}")
    locs_path = os.path.join(run, "Data", "Intensities", "s.locs")
    positions = read_locs(locs_path) if os.path.exists(locs_path) else None
    if a.get("tiles"):
        tiles = [int(t) for t in a.get("tiles").split(",")]
    else:
        tiles = sorted(
            int(os.path.basename(p)[len(f"s_{lane}_"):-7])
            for p in glob.glob(os.path.join(basecalls, f"s_{lane}_*.filter"))
        )
    cycles = sorted(
        int(os.path.basename(p)[1:-2])
        for p in glob.glob(os.path.join(basecalls, "C*.1"))
    )
    if not cycles:
        print(f"No cycle directories under {basecalls}", file=sys.stderr)
        return 1
    fastq = out.endswith((".fq", ".fastq", ".fq.gz", ".fastq.gz"))
    from ..io.readwrite import open_output

    written = 0
    with open_output(out) as fh:
        if not fastq:
            fh.write(b"#lane\ttile\tcluster\tx\ty\tpassFilter\tbases"
                     b"\tquals\n")
        for tile in tiles:
            fpath = os.path.join(basecalls, f"s_{lane}_{tile}.filter")
            pf = read_filter(fpath) if os.path.exists(fpath) else None
            seq = qual = None
            for cyc in cycles:
                path = None
                for surface in (1, 2):
                    cand = os.path.join(basecalls, f"C{cyc}.1",
                                        f"L{lane:03d}_{surface}.cbcl")
                    if os.path.exists(cand):
                        try:
                            if tile in read_cbcl_header(cand)["tiles"]:
                                path = cand
                                break
                        except Exception:
                            continue
                if path is None:
                    continue
                b, q = read_cbcl_tile(path, tile)
                if seq is None:
                    seq = np.zeros((len(b), len(cycles)), np.uint8)
                    qual = np.zeros((len(b), len(cycles)), np.int64)
                ci = cycles.index(cyc)
                seq[:, ci] = b
                qual[:, ci] = q
            if seq is None:
                continue
            n = len(seq)
            for i in range(n):
                p = pf[i] if pf is not None and i < len(pf) else True
                x, y = ((positions[i][0], positions[i][1])
                        if positions is not None and i < len(positions)
                        else (0.0, 0.0))
                bases = seq[i].tobytes()
                quals = bytes((np.clip(qual[i], 0, 60) + 33
                               ).astype(np.uint8))
                if fastq:
                    name = (f"@M:1:C:{lane}:{tile}:{int(x)}:{int(y)} 1:"
                            f"{'N' if p else 'Y'}:0:").encode()
                    fh.write(name + b"\n" + bases + b"\n+\n" + quals
                             + b"\n")
                else:
                    fh.write(f"{lane}\t{tile}\t{i}\t{x:.1f}\t{y:.1f}"
                             f"\t{int(p)}\t".encode() + bases + b"\t"
                             + quals + b"\n")
                written += 1
    print(f"Wrote {written} clusters from {len(tiles)} tiles x"
          f" {len(cycles)} cycles.", file=sys.stderr)
    return 0


# --- test/synthesis helper (writer used by the round-trip test) -------


def write_cbcl(path: str, tile: int, bases: bytes, qbins: np.ndarray,
               remap=(2, 12, 23, 37)):
    codes = np.frombuffer(b"ACGT", np.uint8)
    base_codes = np.zeros(len(bases), np.uint8)
    for i, b in enumerate(bases):
        base_codes[i] = b"ACGT".index(bytes([b])) if bytes(
            [b]) in b"ACGT" else 0
    packed = (base_codes & 0b11) | ((qbins.astype(np.uint8) & 0b11) << 2)
    if len(packed) % 2:
        packed = np.concatenate([packed, np.zeros(1, np.uint8)])
    bytes_ = (packed[0::2] | (packed[1::2] << 4)).astype(np.uint8)
    comp = gzip.compress(bytes_.tobytes())
    nbins = len(remap)
    header_size = 12 + 4 * nbins * 2 + 4 + 8
    with open(path, "wb") as fh:
        fh.write(struct.pack("<HiBB", 1, header_size, 2, 2))
        fh.write(struct.pack("<i", nbins))
        for i in range(nbins):
            fh.write(struct.pack("<i", i))
        for r in remap:
            fh.write(struct.pack("<i", r))
        fh.write(struct.pack("<i", 1))
        fh.write(struct.pack("<ii", tile, len(bases)))
        fh.write(comp)
