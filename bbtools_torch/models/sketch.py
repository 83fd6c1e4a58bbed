"""BBSketch — MinHash genome identity (sketch/Sketch.java:27, SketchObject).

Bottom-k MinHash over hashed canonical k-mers: a sketch is the `size`
smallest 64-bit hashes of a sequence set's k-mers. Jaccard/ANI estimation
between sketches follows the Mash/BBSketch relation
  ANI ~ 1 + ln(2J/(1+J))/k.
Sketching is a batched hash + global partial sort (device-friendly);
comparison is a sorted-merge intersection count.

Modes: sketch (write .sketch TSV), compare (all-vs-all of inputs).

The blacklist= keywords resolve to the JAX package's bundled sketches,
read by path; every other function is the JAX package's.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from ..core.parser import tokenize
from ..io.fasta import iter_fasta
from ..io.fastq import FastqReader
from ..io.fileformat import Format, test_input
from ..io.readwrite import open_input, open_output
from ..ops.kmer_index import _mix64
from ..core.dna import encode
from ..ops.kmers import rolling_kmers_np


def sketch_sequences(seq_iter, k: int = 31, size: int = 10000,
                     blacklist: np.ndarray | None = None) -> np.ndarray:
    """Bottom-k sketch; `blacklist` (sorted uint64 hashes) excludes
    over-represented keys before selection (SketchObject blacklist
    semantics, sketch/Blacklist.java)."""
    best = np.zeros(0, dtype=np.uint64)
    for codes in seq_iter:
        if len(codes) < k:
            continue
        fwd, rkm, runlen = rolling_kmers_np(codes[None, :], k)
        valid = runlen[0] >= k
        keys = np.maximum(fwd[0][valid], rkm[0][valid])
        h = _mix64(keys.astype(np.uint64))
        if blacklist is not None and len(blacklist):
            pos = np.searchsorted(blacklist, h)
            pos = np.minimum(pos, len(blacklist) - 1)
            h = h[blacklist[pos] != h]
        merged = np.concatenate([best, h])
        merged = np.unique(merged)
        best = merged[:size]
    return best


def sketch_file(path: str, k: int = 31, size: int = 10000,
                blacklist: np.ndarray | None = None) -> np.ndarray:
    ff = test_input(path)
    if ff.format is Format.FASTA:
        return sketch_sequences(
            (encode(rec.seq) for rec in iter_fasta(path)), k, size, blacklist
        )
    def reads():
        for b in FastqReader(path):
            for i in range(b.n):
                yield b.bases[i, : b.lengths[i]]
    return sketch_sequences(reads(), k, size, blacklist)


def _a48_value(tok: bytes) -> int:
    v = 0
    for ch in tok:
        v = (v << 6) | (ch - 48)
    return v


def read_reference_sketch(path: str):
    """Parse the reference's .sketch coding (sketch/SketchObject: header
    line `#SZ:n CD:AD ...` then one A48-coded DELTA per line of the
    ascending hash list). Returns (sorted uint64 hashes, header dict).
    Used for the bundled blacklist_* files and for comparing against
    reference-built sketch DBs."""
    from ..io.readwrite import open_input

    hashes = []
    header = {}
    cur = 0
    with open_input(path) as fh:
        for line in fh.read().splitlines():
            if not line:
                continue
            if line.startswith(b"#"):
                if hashes:
                    break  # next sketch record: blacklists hold one
                for kv in line[1:].split(b"	"):
                    if b":" in kv:
                        key, val = kv.split(b":", 1)
                        header[key.decode()] = val.decode()
                continue
            tok = line.strip().split(b"\t")[0]  # optional count column
            cur += _a48_value(tok)
            hashes.append(cur)
    return np.sort(np.array(hashes, dtype=np.uint64)), header


def parse_sketch_records(blob: bytes):
    """Parse a (possibly multi-record) reference sketch stream — the body
    SendSketch POSTs to /sketch (sketch/SketchSearcher.
    loadSketchesFromString; same coding as .sketch files). Returns
    [(header dict, sorted uint64 hashes), ...]."""
    records = []
    header: dict = {}
    hashes: list = []
    cur = 0
    for line in blob.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(b"#"):
            if hashes or header:
                records.append(
                    (header, np.sort(np.array(hashes, dtype=np.uint64)))
                )
            header, hashes, cur = {}, [], 0
            for kv in line[1:].split(b"\t"):
                if b":" in kv:
                    key, val = kv.split(b":", 1)
                    header[key.decode()] = val.decode()
            continue
        tok = line.split(b"\t")[0]
        try:
            cur += _a48_value(tok)
        except (KeyError, IndexError):
            continue
        hashes.append(cur)
    if hashes or header:
        records.append(
            (header, np.sort(np.array(hashes, dtype=np.uint64)))
        )
    return records


def load_blacklist(spec: str) -> np.ndarray:
    """blacklist= keyword (nt/refseq/silva/prokprot) or file path; both
    the reference A48 coding and this repo's TSV sketches parse."""
    import os

    keywords = {
        "nt": "blacklist_nt_merged.sketch",
        "refseq": "blacklist_refseq_merged.sketch",
        "silva": "blacklist_silva_merged.sketch",
        "prokprot": "blacklist_prokprot_merged.sketch",
    }
    if spec.lower() in keywords:
        # the bundled blacklists are the JAX package's, read by path
        here = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "bbtools_tpu")
        path = os.path.join(here, "resources", keywords[spec.lower()])
    else:
        path = spec
    with open(path, "rb") as fh:
        head = fh.readline()
    if b"CD:A" in head or b"CD:AD" in head:
        hashes, _ = read_reference_sketch(path)
        return hashes
    hashes, _k = read_sketch(path)
    return np.sort(hashes)


def sketch_sequences_v2(seq_iter, size: int = 10000, k: int = 32,
                        k2: int = 24,
                        blacklist: np.ndarray | None = None):
    """Reference-compatible sketching (SketchObject hashToValue2 + the
    seeded XOR code tables, ops/sketch_hash.py): returns (keys uint64
    ascending = Long.MAX_VALUE - hashcode, stats dict). Sketches built
    here carry the same keys as Java-built ones, so .sketch files and
    servers interoperate."""
    from ..ops.sketch_hash import (
        LONG_MAX,
        hashes_for_codes,
        sketch_keys_from_hashes,
    )

    parts = []
    gs = 0
    gk = 0
    gq = 0
    bc = np.zeros(4, np.int64)
    for codes in seq_iter:
        gq += 1
        gs += len(codes)
        bc += np.bincount(np.minimum(codes, 4), minlength=5)[:4]
        h = hashes_for_codes(codes, k, k2)
        gk += len(h)
        if len(h):
            parts.append(h)
    hashes = (
        np.concatenate(parts) if parts else np.zeros(0, np.int64)
    )
    keys = sketch_keys_from_hashes(hashes, size)
    if blacklist is not None and len(blacklist) and len(keys):
        pos = np.minimum(
            np.searchsorted(blacklist, keys), len(blacklist) - 1
        )
        keys = keys[blacklist[pos] != keys]
    stats = {
        "GS": gs, "GK": gk, "GQ": gq,
        "BC": bc.tolist(),
        "GE": (
            int(np.ceil(float(LONG_MAX) * 2 * len(keys)
                        / max(int(keys[-1]), 1)))
            if len(keys) else 0
        ),
    }
    return keys, stats


def sketch_file_v2(path: str, size: int = 10000, k: int = 32, k2: int = 24,
                   blacklist: np.ndarray | None = None):
    ff = test_input(path)
    if ff.format is Format.FASTA:
        return sketch_sequences_v2(
            (encode(rec.seq) for rec in iter_fasta(path)), size, k, k2,
            blacklist,
        )

    def reads():
        for b in FastqReader(path):
            for i in range(b.n):
                yield b.bases[i, : b.lengths[i]]

    return sketch_sequences_v2(reads(), size, k, k2, blacklist)


def _append_a48(value: int, out: bytearray):
    """Sketch.appendA48 (sketch/Sketch.java:982-999)."""
    if value == 0:
        out.append(ord("0"))
        return
    tmp = []
    while value != 0:
        tmp.append(value & 0x3F)
        value >>= 6
    for b in reversed(tmp):
        out.append(b + 48)


def write_sketch_v2(path: str, keys: np.ndarray, stats: dict,
                    name: str | None = None, fname: str | None = None,
                    k: int = 32, k2: int = 24, taxid: int = -1):
    """Reference .sketch format: `#SZ:` header + A48-coded deltas of the
    ascending key list (Sketch.toHeader/toBytes, sketch/Sketch.java:
    835-928; CODING=A48, deltaOut=true, HASH_VERSION=2)."""
    out = bytearray()
    out += b"#SZ:%d\tCD:AD\tK:%d" % (len(keys), k)
    if k2:
        out += b",%d" % k2
    out += b"\tH:2"
    if stats.get("GS"):
        out += b"\tGS:%d" % stats["GS"]
    if stats.get("GK"):
        out += b"\tGK:%d" % stats["GK"]
    if stats.get("GE"):
        out += b"\tGE:%d" % stats["GE"]
    if stats.get("GQ"):
        out += b"\tGQ:%d" % stats["GQ"]
    if stats.get("BC") is not None:
        out += b"\tBC:%d,%d,%d,%d" % tuple(stats["BC"])
    if taxid >= 0:
        out += b"\tID:%d" % taxid
    if fname:
        out += b"\tFN:%s" % fname.encode()
    if name:
        out += b"\tNM:%s" % name.encode()
    out += b"\n"
    prev = 0
    for key in keys.tolist():
        _append_a48(key - prev, out)
        out += b"\n"
        prev = key
    with open_output(path) as fh:
        fh.write(bytes(out))


def compare_sketches(a: np.ndarray, b: np.ndarray, k: int = 31):
    """Returns (jaccard-ish wkid, ani_estimate, matches, size)."""
    n = min(len(a), len(b))
    if n == 0:
        return 0.0, 0.0, 0, 0
    au, bu = a[:n], b[:n]
    inter = np.intersect1d(au, bu, assume_unique=True)
    matches = len(inter)
    j = matches / n
    if j <= 0:
        return 0.0, 0.0, 0, n
    ani = 1 + math.log(2 * j / (1 + j)) / k
    return j, max(ani, 0.0), matches, n


def write_sketch(path: str, hashes: np.ndarray, name: str, k: int):
    with open_output(path) as fh:
        fh.write(b"#SZ:%d\tK:%d\tNM:%s\n" % (len(hashes), k, name.encode()))
        for h in hashes:
            fh.write(b"%d\n" % int(h))


def read_sketch(path: str):
    with open(path, "rb") as fh:
        header = fh.readline()
        hashes = np.array([int(x) for x in fh.read().split()], dtype=np.uint64)
    k = int(header.split(b"K:")[1].split(b"\t")[0])
    return hashes, k


def _load_or_sketch(path: str, k: int, k2: int, size: int, blacklist,
                    hv: int):
    """Sequence file -> fresh sketch; .sketch file -> parsed keys (both
    reference A48 and legacy TSV codings)."""
    if path.endswith(".sketch"):
        with open_input(path) as fh:
            head = fh.readline()
        if b"CD:A" in head:
            keys, _hdr = read_reference_sketch(path)
            return keys
        h, _k = read_sketch(path)
        return np.sort(h)
    if hv >= 2:
        keys, _stats = sketch_file_v2(path, size, k, k2, blacklist)
        return keys
    return sketch_file(path, k, size, blacklist)


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    ins = a.get_list("in") or ([a.get("in1")] if a.get("in1") else [])
    ref = a.get("ref")
    out = a.get("out")
    hv = a.get_int("hashversion", "hv", default=2)
    k_raw = a.get("k", default="32,24" if hv >= 2 else "31")
    parts = [int(x) for x in str(k_raw).split(",")]
    k = max(parts)
    k2 = min(parts) if len(parts) > 1 and min(parts) != k else (
        24 if hv >= 2 and k == 32 else 0
    )
    size = a.get_int("size", default=10000)
    bl_spec = a.get("blacklist", "bl")
    blacklist = load_blacklist(bl_spec) if bl_spec else None
    sketches = [
        (p, _load_or_sketch(p, k, k2, size, blacklist, hv)) for p in ins
    ]
    if ref:
        rs = _load_or_sketch(ref, k, k2, size, blacklist, hv)
        print("Query\tRef\tWKID\tANI\tMatches\tSize")
        for p, s in sketches:
            j, ani, m, n = compare_sketches(s, rs, k)
            print(f"{p}\t{ref}\t{j*100:.2f}%\t{ani*100:.2f}%\t{m}\t{n}")
    elif len(sketches) > 1:
        print("A\tB\tWKID\tANI\tMatches\tSize")
        for i in range(len(sketches)):
            for j2 in range(i + 1, len(sketches)):
                j, ani, m, n = compare_sketches(sketches[i][1], sketches[j2][1], k)
                print(f"{sketches[i][0]}\t{sketches[j2][0]}\t{j*100:.2f}%\t{ani*100:.2f}%\t{m}\t{n}")
    if out and sketches:
        if hv >= 2 and not ins[0].endswith(".sketch"):
            keys, stats = sketch_file_v2(ins[0], size, k, k2, blacklist)
            write_sketch_v2(out, keys, stats, name=ins[0], fname=ins[0],
                            k=k, k2=k2)
        else:
            write_sketch(out, sketches[0][1], sketches[0][0], k)
    return sketches


if __name__ == "__main__":
    main()


def mergesketch(argv=None):
    """mergesketch.sh (sketch/MergeSketch.java role): merge multiple
    sketches into one. Bottom-k union: concatenate hash sets, dedupe,
    keep the smallest `size=` values (so the merged sketch is what
    sketching the concatenated input would produce)."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    ins = a.get_list("in") or []
    out = a.get("out", "out1")
    size = a.get_int("size", default=0)
    name = a.get("name", default=out or "merged")
    hashes, k = [], None
    for p in ins:
        h, kk = read_sketch(p)
        if k is None:
            k = kk
        elif k != kk:
            raise ValueError(f"mismatched k: {k} vs {kk} in {p}")
        hashes.append(h)
    merged = np.unique(np.concatenate(hashes))
    merged.sort()
    if size > 0:
        merged = merged[:size]
    elif ins:
        merged = merged[: max(len(h) for h in hashes)]
    write_sketch(out, merged, name, k or 31)
    print(
        f"Merged {len(ins)} sketches -> {len(merged)} hashes.",
        file=sys.stderr,
    )
    return merged


def subsketch(argv=None):
    """subsketch.sh (sketch/SubSketch.java role): shrink sketches to a
    smaller fixed size (bottom-k prefix keeps comparison validity)."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    ins = a.get_list("in") or []
    out = a.get("out", "out1", default="%.sub.sketch")
    size = a.get_int("size", "sketchsize", default=1000)
    outs = []
    for p in ins:
        h, k = read_sketch(p)
        h = np.sort(h)[:size]
        dest = out.replace("%", p.rsplit(".", 1)[0]) if "%" in out else out
        write_sketch(dest, h, p, k)
        outs.append(dest)
    print(f"Wrote {len(outs)} subsketches.", file=sys.stderr)
    return outs


def summarizesketch(argv=None):
    """summarizesketch.sh (sketch/SummarizeSketchStats.java role):
    summarize per-query best hits from one or more comparesketch/
    sendsketch result files (Query/Ref/WKID/ANI/Matches/Size rows):
    one line per query with its best reference by WKID."""
    a = tokenize(argv if argv is not None else sys.argv[1:])
    ins = a.get_list("in") or []
    out = a.get("out", "out1")
    best: dict[bytes, tuple] = {}
    for p in ins:
        with open_input(p) as fh:
            for line in fh.read().splitlines():
                f = line.split(b"\t")
                if len(f) < 6 or f[0] in (b"Query", b"A") or not f[2].endswith(b"%"):
                    continue
                wkid = float(f[2].rstrip(b"%"))
                cur = best.get(f[0])
                if cur is None or wkid > cur[0]:
                    best[f[0]] = (wkid, f[1], f[3], f[4], f[5])
    lines = [b"#query\tbestRef\tWKID\tANI\tmatches\tsize"]
    for q in sorted(best):
        wkid, ref, ani, m, n = best[q]
        lines.append(
            q + b"\t" + ref + b"\t%.2f%%\t" % wkid + ani + b"\t" + m
            + b"\t" + n
        )
    blob = b"\n".join(lines) + b"\n"
    if out:
        with open_output(out) as fh:
            fh.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return best
