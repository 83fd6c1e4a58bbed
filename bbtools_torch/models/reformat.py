"""Reformat — universal read converter/subsampler (jgi/ReformatReads.java).

High-traffic surface: fastq<->fasta both directions (qfake= for fasta
input), paired twin files and interleaving (in2/out2: twin->interleaved,
interleaved->split), sampling (samplerate=/reads=/samplereadstarget=),
reverse-complement (rcomp/rcompmate), force trims (ftl/ftr2/ftm),
quality trimming (qtrim/trimq), length filters (minlength/maxlength),
quality filters (maq=/maxns=), name edits (addslash/underscore/
uniquenames), base edits (tuc/remap/tossjunk/fixjunk/dotdashxton),
quality quantization (quantize=), and the standard summary lines.

The PyTorch port of bbtools_tpu/models/reformat.py: quality trimming
(qtrim=/trimq=) runs `ops/trim.optimal_trim` on the run's device
(`device=`, cuda by default); the rest is the JAX package's host code.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..core.parser import tokenize
from ..core.qualtools import phred_to_prob_error
from ..io.batch import ReadBatch
from ..io.fasta import write_fasta
from ..io.fastq import FastqReader, FastqWriter
from ..io.fileformat import Format, test_input, test_output
from ..ops.trim import apply_trim, optimal_trim


def _read_batches(path: str, qfake: int, batch_reads: int,
                  qual_offset=None, sam_filter=(False, False, False)):
    low = path.lower()
    stem = low[:-3] if low.endswith(".gz") else low
    if stem.endswith((".sam", ".bam")):
        # SAM/BAM input (stream/SamReadInputStream role): each record
        # becomes a read; minus-strand alignments reverse-complement back
        # to original read orientation (SamLine.toRead :1471,2248).
        from ..io.sam_read import iter_sam

        mappedonly, unmappedonly, primaryonly = sam_filter
        seqs, quals, ids = [], [], []
        ordinal = 0
        for rec in iter_sam(path):
            if primaryonly and rec.secondary:
                continue
            if mappedonly and not rec.mapped:
                continue
            if unmappedonly and rec.mapped:
                continue
            seq, q = rec.seq, rec.qual
            if seq == b"*":  # sequence-less record (e.g. secondary)
                continue
            if rec.flag & 0x10:
                seq = seq.translate(RC)[::-1]
                q = q[::-1] if q != b"*" else q
            if q == b"*":
                q = bytes([33 + qfake]) * len(seq)
            seqs.append(seq)
            quals.append(q)
            ids.append(rec.qname)
            if len(seqs) >= batch_reads:
                yield ReadBatch.from_sequences(
                    seqs, quals=quals, ids=ids, ordinal=ordinal
                )
                seqs, quals, ids, ordinal = [], [], [], ordinal + 1
        if seqs:
            yield ReadBatch.from_sequences(
                seqs, quals=quals, ids=ids, ordinal=ordinal
            )
        return
    if stem.endswith(".scarf"):
        # Illumina scarf (stream/ScarfStreamer.scarfToRead :223):
        # Header:Sequence:Qualities, parsed right-to-left so headers may
        # contain colons; qualities are phred+64 ASCII.
        from ..io.readwrite import open_input

        seqs, quals, ids = [], [], []
        ordinal = 0
        with open_input(path) as fh:
            for line in fh:
                line = line.rstrip(b"\r\n")
                if not line:
                    continue
                b2 = line.rfind(b":")
                a2 = line.rfind(b":", 0, max(b2, 0))
                if a2 < 0 or b2 < 0:
                    continue
                ids.append(line[:a2])
                seqs.append(line[a2 + 1 : b2])
                quals.append(line[b2 + 1 :])
                if len(seqs) >= batch_reads:
                    yield ReadBatch.from_sequences(
                        seqs, quals=quals, ids=ids, qual_offset=64,
                        ordinal=ordinal,
                    )
                    seqs, quals, ids, ordinal = [], [], [], ordinal + 1
        if seqs:
            yield ReadBatch.from_sequences(
                seqs, quals=quals, ids=ids, qual_offset=64, ordinal=ordinal
            )
        return
    if test_input(path).format is Format.FASTA:
        from ..io.fasta import iter_fasta

        seqs, ids = [], []
        ordinal = 0
        for rec in iter_fasta(path):
            seqs.append(rec.seq)
            ids.append(rec.name)
            if len(seqs) >= batch_reads:
                b = ReadBatch.from_sequences(seqs, ids=ids, ordinal=ordinal)
                b.quals = np.where(b.bases < 4, qfake, 0).astype(np.uint8)
                yield b
                seqs, ids, ordinal = [], [], ordinal + 1
        if seqs:
            b = ReadBatch.from_sequences(seqs, ids=ids, ordinal=ordinal)
            b.quals = np.where(b.bases < 4, qfake, 0).astype(np.uint8)
            yield b
    else:
        yield from FastqReader(path, batch_reads=batch_reads,
                               qual_offset=qual_offset)


def _count_reads(path: str) -> int:
    n = 0
    for b in _read_batches(path, 30, 65536):
        n += b.n
    return n


RC = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


_DEFINED = frozenset(b"ACGTacgt")


def _fails_barcode(nm: bytes, bset, fail_if_none: bool) -> bool:
    """Read.failsBarcode (stream/Read.java:2100-2120): the barcode is the
    suffix after the LAST ':' (which must come after any ' ' or '/'); no
    set -> fail on any non-ACGT/+ char; with a set -> fail on absence."""
    loc = nm.rfind(b":")
    loc2 = max(nm.find(b" "), nm.find(b"/"))
    if loc < 0 or loc <= loc2 or loc >= len(nm) - 1:
        return fail_if_none
    code = nm[loc + 1 :]
    if bset is None:
        return any(c != ord("+") and c not in _DEFINED for c in code)
    return code.decode("latin-1") not in bset


def _pad_batch(bb: ReadBatch, padleft: int, padright: int, sym: int,
               padq: int) -> ReadBatch:
    """ReformatReads.pad (:1372-1399): extend every non-empty read with
    `sym` bases (quality padq) on each end."""
    from ..core.dna import BASE_TO_CODE

    n, L = bb.bases.shape
    L2 = L + padleft + padright
    code = int(BASE_TO_CODE[sym])
    nonzero = bb.lengths > 0
    bases = np.full((n, L2), 4, np.uint8)
    bases[:, padleft : padleft + L] = bb.bases
    if padleft:
        bases[nonzero, :padleft] = code
    ab = None
    if bb.ascii_bases is not None:
        ab = np.full((n, L2), sym, np.uint8)
        ab[:, padleft : padleft + L] = bb.ascii_bases
    quals = None
    if bb.quals is not None:
        quals = np.full((n, L2), padq, np.uint8)
        quals[:, padleft : padleft + L] = bb.quals
    lengths = np.where(nonzero, bb.lengths + padleft, bb.lengths).astype(
        bb.lengths.dtype
    )
    if padright:
        # right pad sits immediately after each read's last base
        pos = np.arange(L2)[None, :]
        tail = (pos >= lengths[:, None]) & (
            pos < (lengths + padright)[:, None]
        ) & nonzero[:, None]
        bases[tail] = code
        if ab is not None:
            ab[tail] = sym
        if quals is not None:
            quals[tail] = padq
        lengths = np.where(nonzero, lengths + padright, lengths).astype(
            lengths.dtype
        )
    out = ReadBatch(
        bases=bases, quals=quals, lengths=lengths, ids=bb.ids,
        ordinal=bb.ordinal,
    )
    out.ascii_bases = ab
    return out


def _rc_rows(b: ReadBatch, rows):
    for i in rows:
        n = int(b.lengths[i])
        seg = b.bases[i, :n]
        b.bases[i, :n] = np.where(seg[::-1] < 4, 3 - seg[::-1], 4)
        if b.quals is not None:
            b.quals[i, :n] = b.quals[i, :n][::-1]
    b.ascii_bases = None


def main(argv=None):
    import torch

    from ..device import resolve_device

    a = tokenize(argv if argv is not None else sys.argv[1:])
    device = resolve_device(a.get("device", default="cuda"))
    in1 = a.get("in", "in1")
    in2 = a.get("in2")
    out1 = a.get("out", "out1")
    out2 = a.get("out2")
    interleaved_in = a.get_bool("int", "interleaved", default=False)
    samplerate = a.get_float("samplerate", "sr", default=1.0)
    reads_limit = a.get_int("reads", default=-1) or -1
    srt = a.get_int("samplereadstarget", "srt", default=-1)
    rcomp = a.get_bool("rcomp", "rc", default=False)
    rcompmate = a.get_bool("rcompmate", "rcm", default=False)
    minlength = a.get_int("minlength", "ml", default=0)
    maxlength = a.get_int("maxlength", default=1 << 30)
    maq = a.get_float("maq", "minavgquality", default=0.0)
    maxns = a.get_int("maxns", default=-1)
    qtrim = a.get("qtrim")
    trimq = a.get_float("trimq", default=6.0)
    ftl = a.get_int("forcetrimleft", "ftl", default=0)
    ftr2 = a.get_int("forcetrimright2", "ftr2", default=0)
    ftm = a.get_int("forcetrimmod", "ftm", default=0)
    qfake = a.get_int("qfake", default=30)
    addslash = a.get_bool("addslash", default=False)
    underscore = a.get_bool("underscore", default=False)
    uniquenames = a.get_bool("uniquenames", default=False)
    tuc = a.get_bool("tuc", "touppercase", default=False)
    remap = a.get("remap")
    tossjunk = a.get_bool("tossjunk", default=False)
    fixjunk = a.get_bool("fixjunk", "dotdashxton", default=False)
    quantize = a.get("quantize")
    seed = a.get_int("sampleseed", default=-1)
    # round-3 flag-matrix additions (jgi/ReformatReads.java surface)
    ftr = a.get_int("forcetrimright", "ftr", default=-1)
    qin = a.get_int("qin", default=None)
    qout = a.get_int("qout", default=33)
    mingc = a.get_float("mingc", default=0.0)
    maxgc = a.get_float("maxgc", default=1.0)
    fastawrap = a.get_int("fastawrap", default=70)
    t2u = a.get_bool("t2u", default=False)
    u2t = a.get_bool("u2t", default=False)
    iupacton = a.get_bool("iupacton", "itn", default=False)
    chastity = a.get_bool("chastityfilter", "ch", default=False)
    trd = a.get_bool("trimreaddescription", "trd", default=False)
    invert = a.get_bool("invertfilters", "invert", default=False)
    skipreads = a.get_int("skipreads", default=0)
    mbq = a.get_int("minbasequality", "mbq", default=0)
    lhist = a.get("lhist")
    qhist = a.get("qhist")
    gchist = a.get("gchist")
    aqhist = a.get("aqhist")
    bhist = a.get("bhist")
    # round-4: SAM input filters, padding, barcode filters
    # (jgi/ReformatReads.java:167-179,226-237,305,778)
    mappedonly = a.get_bool("mappedonly", default=False)
    unmappedonly = a.get_bool("unmappedonly", default=False)
    primaryonly = a.get_bool("primaryonly", default=False)
    padleft = a.get_int("padleft", default=0)
    padright = a.get_int("padright", default=0)
    pad_v = a.get("pad")
    pad_symbol = ord("N")
    if pad_v:
        if pad_v[0].isalpha():
            pad_symbol = ord(pad_v[0])
        else:
            padleft = padright = int(pad_v)
    ps = a.get("padsymbol")
    if ps:
        pad_symbol = ord(ps[0])
    padq = a.get_int("padq", default=0)
    if chr(pad_symbol) in "ACGTacgt":
        padq = max(padq, 2)  # ReformatReads.java:275
    barcodes_arg = a.get("barcodes", "barcode")
    bfilter = (a.get("badbarcodes", "barcodefilter") or "f").lower()
    fail_bad_barcodes = bfilter in ("crash", "fail")
    remove_bad_barcodes = fail_bad_barcodes or bfilter in ("t", "true", "1")
    fail_no_barcode = a.get_bool("failnobarcode", default=False)
    barcode_set = None
    if barcodes_arg:
        barcode_set = set()
        for tok in barcodes_arg.split(","):
            import os as _os

            if _os.path.isfile(tok):
                with open(tok) as fh:
                    barcode_set.update(
                        x.strip() for x in fh if x.strip()
                    )
            else:
                barcode_set.add(tok)
        if barcode_set and not remove_bad_barcodes:
            remove_bad_barcodes = True
    from ..core.parser import test_output_files

    test_output_files(
        a.get_bool("overwrite", "ow", default=True),
        out1, out2, inputs=(in1, in2),
    )
    t0 = time.time()
    rng = np.random.default_rng(None if seed < 0 else seed)
    if srt > 0:
        total = _count_reads(in1)
        samplerate = min(1.0, srt / max(total, 1))
        reads_limit = srt
    qlevels = None
    if quantize and quantize not in ("f", "false", "t", "true"):
        qlevels = np.array(sorted(int(x) for x in quantize.split(",")))
    remap_tbl = None
    if remap and len(remap) >= 2:
        remap_tbl = bytes.maketrans(
            remap[0::2].encode(), remap[1::2].encode()
        )

    off = test_output(out1) if out1 else None
    fasta_out = off is not None and off.format is Format.FASTA
    writer = writer2 = None
    fa_records = []
    if out1 and not fasta_out:
        writer = FastqWriter(out1, qual_offset=qout)
        if out2:
            writer2 = FastqWriter(out2, qual_offset=qout)
    reads_out = bases_out = 0
    reads_in = bases_in = 0
    emitted = 0
    seen_names: dict[bytes, int] = {}

    sam_filter = (mappedonly, unmappedonly, primaryonly)
    reader2 = (
        iter(_read_batches(in2, qfake, 16384, qin, sam_filter))
        if in2 else None
    )
    rstats = None
    if lhist or qhist or gchist or aqhist or bhist:
        from ..utils.readstats import ReadStats

        rstats = ReadStats()
    skipped = 0
    for b in _read_batches(in1, qfake, 16384, qin, sam_filter):
        b2 = next(reader2) if reader2 is not None else None
        reads_in += b.n + (b2.n if b2 is not None else 0)
        bases_in += int(b.lengths.sum()) + (
            int(b2.lengths.sum()) if b2 is not None else 0
        )
        pair = [b] if b2 is None else [b, b2]
        keep = np.ones(b.n, dtype=bool)
        if skipped < skipreads:
            take = min(b.n, skipreads - skipped)
            keep[:take] = False
            skipped += take
        if samplerate < 1.0:
            keep &= rng.random(b.n) < samplerate
        if chastity:
            # Illumina chastity: header ' ...:Y:...' fails
            for bb in pair:
                fail = np.array(
                    [b":Y:" in bb.ids[i] for i in range(bb.n)], bool
                )
                keep &= ~fail
        if remove_bad_barcodes or fail_no_barcode:
            for bb in pair:
                fail = np.array(
                    [_fails_barcode(bb.ids[i], barcode_set, fail_no_barcode)
                     for i in range(bb.n)],
                    bool,
                )
                if fail_bad_barcodes and fail.any():
                    i = int(np.flatnonzero(fail)[0])
                    raise RuntimeError(
                        "Invalid barcode detected: "
                        + bb.ids[i].decode("latin-1")
                        + "\nThis can be disabled with the flag "
                        "barcodefilter=f"
                    )
                keep &= ~fail
        if trd:
            for bb in pair:
                for i in range(bb.n):
                    bb.ids[i] = bb.ids[i].split()[0]
        filt = np.ones(b.n, dtype=bool)
        for bi, bb in enumerate(pair):
            if ftl or ftr2 or ftm or ftr >= 0:
                ln = bb.lengths.astype(np.int64)
                right = np.maximum(ln % ftm if ftm else 0, ftr2)
                if ftr >= 0:
                    # keep positions [ftl, ftr]: trim len-1-ftr from right
                    right = np.maximum(right, ln - 1 - ftr)
                pair[bi] = bb = apply_trim(
                    bb, np.full(bb.n, ftl), np.minimum(np.maximum(right, 0), ln)
                )
            if qtrim in ("rl", "r", "l", "t", "true") and bb.quals is not None:
                avg = float(np.float32(phred_to_prob_error(trimq)))
                is_n = bb.bases >= 4
                left, right = (
                    x.cpu().numpy()
                    for x in optimal_trim(
                        *(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                          for x in (bb.quals, bb.lengths, is_n)), avg,
                    )
                )
                if qtrim == "r":
                    left = np.zeros_like(left)
                if qtrim == "l":
                    right = np.zeros_like(right)
                over = left + right + 1 > bb.lengths
                right = np.where(over, np.maximum(1, bb.lengths - 1), right)
                left = np.where(over, 0, left)
                pair[bi] = bb = apply_trim(bb, left, right)
            filt &= (bb.lengths >= minlength) & (bb.lengths <= maxlength)
            if mingc > 0.0 or maxgc < 1.0:
                inwin = (
                    np.arange(bb.bases.shape[1])[None, :]
                    < bb.lengths[:, None]
                )
                gccnt = (((bb.bases == 1) | (bb.bases == 2)) & inwin).sum(
                    axis=1
                )
                gc = gccnt / np.maximum(bb.lengths, 1)
                filt &= (gc >= mingc) & (gc <= maxgc)
            if mbq > 0 and bb.quals is not None:
                inwin = (
                    np.arange(bb.bases.shape[1])[None, :]
                    < bb.lengths[:, None]
                )
                minq = np.where(inwin, bb.quals, 127).min(axis=1)
                filt &= minq >= mbq
            if maq > 0 and bb.quals is not None:
                qs = np.where(
                    np.arange(bb.bases.shape[1])[None, :]
                    < bb.lengths[:, None],
                    bb.quals, 0,
                ).sum(axis=1)
                filt &= qs >= maq * np.maximum(bb.lengths, 1)
            if maxns >= 0:
                ncount = (
                    (bb.bases >= 4)
                    & (np.arange(bb.bases.shape[1])[None, :]
                       < bb.lengths[:, None])
                ).sum(axis=1)
                filt &= ncount <= maxns
            if tossjunk and bb.ascii_bases is not None:
                valid = np.isin(
                    bb.ascii_bases, np.frombuffer(b"ACGTNacgtn", np.uint8)
                ) | (
                    np.arange(bb.bases.shape[1])[None, :]
                    >= bb.lengths[:, None]
                )
                filt &= valid.all(axis=1)
        keep &= ~filt if invert else filt
        b, b2 = pair[0], (pair[1] if len(pair) > 1 else None)
        if reads_limit > 0:
            room = reads_limit - emitted
            sel = np.flatnonzero(keep)
            if len(sel) > room:
                keep[sel[room:]] = False
        if padleft > 0 or padright > 0:
            b = _pad_batch(b, padleft, padright, pad_symbol, padq)
            if b2 is not None:
                b2 = _pad_batch(b2, padleft, padright, pad_symbol, padq)
        rows = np.flatnonzero(keep)
        if rcomp:
            _rc_rows(b, rows)
            if b2 is not None:
                _rc_rows(b2, rows)
        elif rcompmate and b2 is not None:
            _rc_rows(b2, rows)
        for bb in (b, b2) if b2 is not None else (b,):
            if qlevels is not None and bb.quals is not None:
                # snap each quality to the nearest allowed level
                qi = np.searchsorted(qlevels, bb.quals, side="left")
                qi = np.clip(qi, 0, len(qlevels) - 1)
                lo = qlevels[np.maximum(qi - 1, 0)]
                hi = qlevels[qi]
                bb.quals = np.where(
                    np.abs(bb.quals.astype(int) - lo)
                    <= np.abs(hi - bb.quals.astype(int)),
                    lo, hi,
                ).astype(np.uint8)
                bb.ascii_bases = bb.ascii_bases  # quals changed only
            if (fixjunk or iupacton) and bb.ascii_bases is not None:
                bad = ~np.isin(
                    bb.ascii_bases, np.frombuffer(b"ACGTNacgtn", np.uint8)
                )
                bb.ascii_bases[bad] = ord("N")
                bb.bases[bad] = 4
            if tuc and bb.ascii_bases is not None:
                low = (bb.ascii_bases >= ord("a")) & (
                    bb.ascii_bases <= ord("z")
                )
                bb.ascii_bases[low] -= 32
            if (t2u or u2t) and bb.ascii_bases is not None:
                src, dst = (b"TtUu", b"UuTt") if t2u else (b"UuTt", b"TtUu")
                tbl = bytes.maketrans(src, dst)
                flat = bb.ascii_bases.tobytes().translate(tbl)
                bb.ascii_bases = np.frombuffer(flat, np.uint8).reshape(
                    bb.ascii_bases.shape
                ).copy()
            if remap_tbl is not None and bb.ascii_bases is not None:
                flat = bb.ascii_bases.tobytes().translate(remap_tbl)
                bb.ascii_bases = np.frombuffer(
                    flat, np.uint8
                ).reshape(bb.ascii_bases.shape).copy()
        for pairnum, bb in enumerate((b, b2) if b2 is not None else (b,)):
            for i in rows:
                nm = bb.ids[i]
                if underscore:
                    nm = nm.replace(b" ", b"_").replace(b"\t", b"_")
                if uniquenames:
                    c = seen_names.get(nm, 0)
                    seen_names[nm] = c + 1
                    if c:
                        nm = nm + b"_%d" % c
                if addslash and not nm.endswith((b"/1", b"/2")):
                    nm = nm + (b" /1" if pairnum == 0 else b" /2")
                bb.ids[i] = nm
        if rstats is not None:
            from ..models.bbduk import _subset

            rows_k = keep
            rstats.add_batch(_subset(b, rows_k), 0)
            if b2 is not None:
                rstats.add_batch(_subset(b2, rows_k), 1)
        emitted += int(keep.sum())
        reads_out += int(keep.sum()) * (2 if b2 is not None else 1)
        bases_out += int(b.lengths[keep].sum()) + (
            int(b2.lengths[keep].sum()) if b2 is not None else 0
        )
        if writer:
            if b2 is not None and writer2 is not None:
                writer.add(b, keep)
                writer2.add(b2, keep)
            elif b2 is not None:
                # twin -> interleaved single output
                from ..io.fastq import encode_fastq

                payload = bytearray()
                for i in rows:
                    payload += encode_fastq(b, np.eye(b.n, dtype=bool)[i])
                    payload += encode_fastq(b2, np.eye(b2.n, dtype=bool)[i])
                writer.fh.write(bytes(payload))
                writer.reads_out += 2 * len(rows)
            else:
                writer.add(b, keep)
        elif fasta_out:
            for i in rows:
                fa_records.append((b.ids[i], b.sequence(i)))
                if b2 is not None:
                    fa_records.append((b2.ids[i], b2.sequence(i)))
        if reads_limit > 0 and emitted >= reads_limit:
            break
    if writer:
        writer.close()
    if writer2:
        writer2.close()
    if fasta_out:
        write_fasta(out1, fa_records, wrap=fastawrap)
    if rstats is not None:
        paired = in2 is not None
        if qhist:
            rstats.write_qhist(qhist, paired)
        if lhist:
            rstats.write_lhist(lhist)
        if gchist:
            rstats.write_gchist(gchist)
        if aqhist:
            rstats.write_aqhist(aqhist, paired)
        if bhist:
            rstats.write_bhist(bhist)
    dt = time.time() - t0
    print(f"Input:               \t{reads_in} reads \t{bases_in} bases", file=sys.stderr)
    print(f"Output:              \t{reads_out} reads ({100.0*reads_out/max(reads_in,1):.2f}%) \t{bases_out} bases ({100.0*bases_out/max(bases_in,1):.2f}%)", file=sys.stderr)
    print(f"Time:                \t{dt:.3f} seconds.", file=sys.stderr)
    return reads_out, bases_out


if __name__ == "__main__":
    main()
