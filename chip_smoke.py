#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bbtools_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--reads N] [--pairs N] [--seed S]

From the root of a checkout, on a machine with a CUDA card:

  1. prints the card (nvidia-smi name and power limit) and versions;
  2. builds the CUDA kernels from bbtools_torch/csrc with nvcc (one
     compiler per source, in parallel);
  3. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes (exact equality), and times both with CUDA
     events: B1 lane_lookup and B2 cummax_i64 (BBDuk), B3 mm_lookup (the
     matcher configuration's index, on the full-k and short-k end keys
     the BBDuk scans send it for one batch), B5 overlap_scan and B6
     lane_table (one BBMerge batch);
  4. drives each path through the CLI entry point on device=cuda with
     every launch counter set to 0 just before it and read just after:
     `bbduk` over a seeded gzipped FASTQ of N reads (1,000,000 by
     default) at ref=adapters hdist=1 (sorted join, B2) and on one
     literal adapter (lane table, B1); `bbduk` on the matcher backend
     (ref=adapters,phix k=23 mink=11 hdist=2, B3) over 100,000 of those
     reads, with its index build timed on its own line; a paired `bbduk
     tbo tpe` over seeded interleaved pairs (B1, B5, B6); and `bbmerge`
     over a seeded pair of gzipped FASTQ files of N pairs (1,000,000 by
     default; B5, B6);
  5. runs every path but the matcher's on its first 20,000 reads (pairs)
     on device=cuda and device=cpu and requires byte-equal output files
     (the matcher's CUDA-against-CPU equality is held by the CPU tests).

Its last line is {"ok": true, "device": {...}}; any failed phase raises
and the script exits non-zero. Without CUDA, or outside a checkout, it
exits non-zero and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ADAPTER = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
ADAPTER2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
COMMON = ["k=23", "mink=11", "hdist=1", "ktrim=r", "minlen=40"]
CONFIGS = {
    "adapters_fa": ["ref=adapters"] + COMMON,
    "1adapter": [f"literal={ADAPTER.decode()}"] + COMMON,
}
#: the matcher configuration, a stand-in made to pass the sorted join's
#: cap of 8,000,000 keys: ref=adapters alone expands to 6,823,201 keys at
#: hdist=2, so the panel adds phiX (19,494,221 keys; PERF.md section 4)
MM_CONFIG = ["ref=adapters,phix", "k=23", "mink=11", "hdist=2", "ktrim=r",
             "minlen=40"]
MM_READS = 100_000
TBO_FLAGS = CONFIGS["1adapter"] + ["tbo", "tpe"]
TBO_PAIRS = 200_000
BATCH = 16384  # reads per batch of the bbduk main path (batchreads default)
MERGE_BATCH = 8192  # pairs per batch of the bbmerge main path
CHECK_READS = 20_000  # reads (pairs) of the CUDA-against-CPU comparison
#: merged share of the seeded pairs (inserts 100-400 bp, 150 bp reads):
#: the overlapping ones (insert <= ~290) that are neither ambiguous nor
#: too noisy; 0.6215 on the first 16,384 pairs (CPU run)
MERGED_RANGE = (0.55, 0.70)


def make_fastq(path: str, n: int, seed: int) -> int:
    """Seeded reads of 90-151 bp, phred 2-40, every third read carrying
    an adapter tail from a random position >= 40 (truncated at the read
    end). Returns the number of bases."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    adapter = np.frombuffer(ADAPTER, np.uint8)
    lmax = 151
    lens = rng.integers(90, lmax + 1, n)
    seq = acgt[rng.integers(0, 4, (n, lmax))]
    qual = (33 + rng.integers(2, 40, (n, lmax))).astype(np.uint8)
    start = rng.integers(40, lens - 5)
    col = np.arange(lmax)[None, :]
    off = col - start[:, None]
    tail = ((np.arange(n) % 3) == 0)[:, None] & (off >= 0) & (off < len(adapter))
    seq[tail] = adapter[off[tail]]
    with gzip.open(path, "wb", compresslevel=1) as fh:
        for c0 in range(0, n, 100_000):
            recs = []
            for i in range(c0, min(n, c0 + 100_000)):
                L = lens[i]
                recs.append(b"@r%d\n%s\n+\n%s\n" % (
                    i, seq[i, :L].tobytes(), qual[i, :L].tobytes()))
            fh.write(b"".join(recs))
    return int(lens.sum())


def make_pairs(paths: list[str], n: int, seed: int, lo: int, hi: int,
               L: int = 150) -> int:
    """Seeded pairs of L bp from inserts of lo..hi bp: r1 is the insert's
    start, r2 its reverse-complemented end, each read running into its
    adapter past the insert; phred 2-40, mostly high (41 - an exponential
    of mean 7), with sequencing errors drawn at each base's phred rate and
    an N in every 25th r1. Written to two files (r1, r2) or, given one
    path, interleaved. Returns the number of pairs."""
    rng = np.random.default_rng(seed)
    ascii_ = np.frombuffer(b"ACGTN", np.uint8)
    p_err = (10.0 ** (-np.arange(41) / 10.0)).astype(np.float32)
    fh = [gzip.open(p, "wb", compresslevel=1) for p in paths]
    try:
        for c0 in range(0, n, 100_000):
            m = min(n, c0 + 100_000) - c0
            ins = rng.integers(lo, hi + 1, m)
            frag = rng.integers(0, 4, (m, hi), dtype=np.uint8)
            pos = np.arange(L)[None, :]
            reads = []
            for mate, adapter in ((0, ADAPTER), (1, ADAPTER2)):
                ad = np.frombuffer(adapter, np.uint8)
                # r1[p] = frag[p]; r2[p] = comp(frag[ins - 1 - p])
                src = pos if mate == 0 else ins[:, None] - 1 - pos
                codes = np.take_along_axis(frag, np.clip(src, 0, hi - 1), 1)
                if mate == 1:
                    codes = 3 - codes
                s = ascii_[codes]
                past = pos - ins[:, None]  # position into the adapter
                ad_pos = (past >= 0) & (past < len(ad))
                s[ad_pos] = ad[past[ad_pos]]
                s[past >= len(ad)] = ord("A")
                q = np.clip(41 - rng.exponential(7, (m, L)), 2, 40).astype(np.uint8)
                err = rng.random((m, L), dtype=np.float32) < p_err[q]
                s[err] = ascii_[rng.integers(0, 4, int(err.sum()))]
                if mate == 0:
                    n_rows = np.arange(0, m, 25)
                    s[n_rows, rng.integers(0, L, len(n_rows))] = ord("N")
                reads.append((s, (q + 33).astype(np.uint8)))
            # fixed-width records, built as one byte matrix per mate:
            # "@p<8-digit index> <mate>:N:0\n<seq>\n+\n<qual>\n"
            ids = c0 + np.arange(m)
            digits = (ids[:, None] // 10 ** np.arange(7, -1, -1)[None, :]) % 10
            recs = []
            for mate, (s, q) in enumerate(reads):
                head = np.frombuffer(b"@p", np.uint8)[None, :].repeat(m, 0)
                tail = np.frombuffer(b" %d:N:0\n" % (mate + 1), np.uint8)
                recs.append(np.concatenate([
                    head, (48 + digits).astype(np.uint8), tail[None, :].repeat(m, 0),
                    s, np.full((m, 3), [10, 43, 10], np.uint8), q,
                    np.full((m, 1), 10, np.uint8)], axis=1))
            if len(fh) == 2:
                fh[0].write(recs[0].tobytes())
                fh[1].write(recs[1].tobytes())
            else:
                fh[0].write(np.stack(recs, axis=1).tobytes())
    finally:
        for f in fh:
            f.close()
    return n


def head_fastq(src: str, dst: str, n: int):
    with gzip.open(src, "rb") as fi, gzip.open(dst, "wb", compresslevel=1) as fo:
        for _ in range(4 * n):
            fo.write(fi.readline())


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` back-to-back calls,
    after one warm-up call, with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def compare(name: str, kernel, plain, reps: int = 20) -> dict:
    """Exact comparison of kernel() and plain() on the card, then timing
    in turns (plain, kernel, kernel, plain)."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version (max |diff| {err})")
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    row = {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}
    print(f"{name}: n={got.numel()} exact=True kernel {row['ms']:.4f} ms "
          f"plain {row['plain_ms']:.4f} ms")
    return row


def check_kernels(fq: str, pair1: str, pair2: str) -> list[dict]:
    import torch

    from bbtools_torch.io.fastq import FastqReader
    from bbtools_torch.models.bbduk import build_index, load_reference, parse_args
    from bbtools_torch.models.bbmerge import _rc_batch
    from bbtools_torch.ops import bbduk_scan, lane_index, lane_table, scan, sort_join
    from bbtools_torch.ops.bbduk_scan import KScanConfig, canonical_keys, kscan_combined
    from bbtools_torch.ops.kmers import rolling_kmers
    from bbtools_torch.ops.mm_match import MMKmerIndex, mm_lookup, mm_lookup_plain
    from bbtools_torch.ops.overlap import PROB_CORRECT4
    from bbtools_torch.ops.overlap_scan import overlap_counts, overlap_counts_plain

    dev = torch.device("cuda")
    # read the file to its end, so the reader's threads and any gzip
    # process finish
    batch = list(FastqReader(fq, batch_reads=BATCH))[0]
    bases = torch.from_numpy(batch.bases).to(dev)
    print(f"main-path batch: {tuple(bases.shape)} bases")
    fwd, rkm, _ = rolling_kmers(bases, 23)

    def keys_for(cfg_args):
        cfg = parse_args(cfg_args)
        index, _, _ = build_index(cfg)
        mm = cfg.mid_mask_bits if cfg.mask_middle else -1
        keys = canonical_keys(KScanConfig(k=cfg.k, mid_mask=mm), fwd, rkm, cfg.k)
        return index, keys

    # B1: the 1-adapter lane table, packed (as built) and unpacked
    lane, q = keys_for(CONFIGS["1adapter"])
    packed = lane_index.LaneKmerIndex.from_arrays(
        lane.tlo, lane.thi, lane.tid, *lane.static_params())
    unpacked = lane_index.LaneKmerIndex.from_arrays(
        lane.tlo, lane.thi >> 16, lane.thi & 0xFFFF, lane.nb, lane.groups,
        lane.slots, lane.rows, lane.salt, False)
    rows = []
    for label, idx in (("packed", packed), ("unpacked", unpacked)):
        tbl = idx.device_arrays(dev)
        args = (*tbl, *idx.static_params())
        r = compare(
            f"B1 lane_lookup {label} ({idx.groups}x{idx.slots} slots)",
            lambda: lane_index.lane_lookup(*args, q),
            lambda: lane_index.lookup_plain(*args, q),
        )
        hits = int((lane_index.lane_lookup(*args, q) > 0).sum().item())
        if hits == 0:
            raise AssertionError("B1: no query hit the adapter table")
        rows.append(r)
    b1 = {
        "name": "lane_lookup", "route": "cuda",
        "source": "bbtools_torch/csrc/lane_lookup.cu",
        "replaces": "bbtools_tpu/ops/lane_index.py:244",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
    }

    # B2: the cummax input of the first join chunk of config #1
    join, q = keys_for(CONFIGS["adapters_fa"])
    skeys, ids32 = join.device_arrays(dev)
    v, _, _ = sort_join.segment_words(skeys, ids32, q.reshape(-1)[: sort_join.CHUNK])
    r2 = compare(f"B2 cummax_i64 join chunk ({join.n} index rows)",
                 lambda: scan.cummax_i64(v), lambda: scan.cummax_plain(v))
    gen = torch.Generator(device="cpu").manual_seed(7)
    for n in (1, 4095, 4096, 4097, 1_000_003):
        r = torch.randint(-(2**62), 2**62, (n,), generator=gen, dtype=torch.int64)
        r[r.abs() < 2**60] *= -1
        r[:: 997] = -(2**63)
        r = r.to(dev)
        out = scan.cummax_i64(r)
        if not torch.equal(out, scan.cummax_plain(r)):
            raise AssertionError(f"B2: random n={n} differs from torch.cummax")
    print("B2 cummax_i64 random (INT64_MIN, negatives, ragged n): exact=True")
    b2 = {
        "name": "cummax_i64", "route": "cuda",
        "source": "bbtools_torch/csrc/cummax_i64.cu",
        "replaces": "bbtools_tpu/ops/scan_pallas.py:49",
        **r2,
    }

    # B3: the matcher of the main path's configuration (MM_CONFIG; its
    # raw-key columns, which need no hdist expansion) on the keys the main
    # path's scans send it for this batch: the full-k scan's and the
    # right-end short-kmer scan's (lengths mink..k-1, class channels set)
    mcfg = parse_args(MM_CONFIG)
    scaffolds, _ = load_reference(mcfg)
    mink = mcfg.mink if mcfg.use_short_kmers else 0
    mm = MMKmerIndex.build(scaffolds, mcfg.k, mink=mink, hdist=mcfg.hdist,
                           hdist2=mcfg.hdist2, mid_mask=mcfg.mid_mask_bits,
                           rcomp=mcfg.rcomp)
    table = mm.device_arrays(dev)
    scfg = KScanConfig(k=mcfg.k, mink=mink,
                       mid_mask=mcfg.mid_mask_bits if mcfg.mask_middle else -1,
                       mm=mm.static_params())
    sent = []

    def record(*args):
        sent.append(args[-1])
        return mm_lookup_plain(*args)

    bbduk_scan.mm_lookup = record
    try:
        kscan_combined(scfg, table, bases,
                       torch.from_numpy(batch.lengths).to(dev),
                       mcfg.use_short_kmers and mcfg.ktrim_left,
                       mcfg.use_short_kmers and mcfg.ktrim_right)
    finally:
        bbduk_scan.mm_lookup = mm_lookup
    if len(sent) != 2:
        raise AssertionError(f"B3: the scans sent {len(sent)} key sets, not 2")
    r3, hits = [], []
    for label, q in zip(("full-k", "short-k end"), sent):
        r = compare(f"B3 mm_lookup {label} keys {tuple(q.shape)} ({mm.n_raw} "
                    f"raw keys, Kp={mm.Kp}, Dp={mm.Dp})",
                    lambda: mm_lookup(*table, *mm.static_params(), q),
                    lambda: mm_lookup_plain(*table, *mm.static_params(), q),
                    reps=3)
        hits.append(int((mm_lookup(*table, *mm.static_params(), q) > 0).sum().item()))
        print(f"B3 mm_lookup {label}: {hits[-1]} of {q.numel()} queries hit "
              f"(Dp={mm.Dp})")
        if hits[-1] == 0:
            raise AssertionError(f"B3: no {label} query hit the matcher")
        r3.append(r)
    # one batch of the main path makes both calls
    b3 = {
        "name": "mm_lookup", "route": "cuda",
        "source": "bbtools_torch/csrc/mm_match.cu",
        "replaces": "bbtools_tpu/ops/mm_match.py:386",
        "max_abs_err": max(r["max_abs_err"] for r in r3),
        "ms": sum(r["ms"] for r in r3), "plain_ms": sum(r["plain_ms"] for r in r3),
        "Dp": mm.Dp, "queries": [q.numel() for q in sent], "hits": hits,
    }

    # B5 and B6 on one BBMerge batch: the insert scan, and the efilter's
    # probCorrect4 lookup of r1's quality plane
    from bbtools_torch.io.fastq import paired_reader

    b1m, b2m = list(paired_reader(pair1, pair2, batch_reads=MERGE_BATCH))[0]
    a = torch.from_numpy(b1m.bases).to(dev)
    b_rc = torch.from_numpy(_rc_batch(b2m)).to(dev)
    al = torch.from_numpy(b1m.lengths.astype(np.int32)).to(dev)
    bl = torch.from_numpy(b2m.lengths.astype(np.int32)).to(dev)
    min0 = 12  # the default preset's minInsert0
    D = int((b1m.lengths.astype(np.int64) + b2m.lengths).max() - min0 + 1)
    r5 = compare(f"B5 overlap_scan ({a.shape[0]} pairs, L={a.shape[1]}, D={D})",
                 lambda: torch.stack(overlap_counts(a, b_rc, al, bl, min0, D)),
                 lambda: torch.stack(overlap_counts_plain(a, b_rc, al, bl, min0, D)),
                 reps=5)
    b5 = {
        "name": "overlap_scan", "route": "cuda",
        "source": "bbtools_torch/csrc/overlap_scan.cu",
        "replaces": "bbtools_tpu/ops/overlap_pallas.py:40",
        **r5,
    }
    pc4t = torch.from_numpy(lane_table.pack_table(PROB_CORRECT4)).to(dev)
    qidx = torch.clamp(torch.from_numpy(b1m.quals).to(dev).to(torch.int32), max=59)
    qidx = qidx.contiguous()
    r6 = compare(f"B6 lane_table (pc4, {tuple(qidx.shape)} phred)",
                 lambda: lane_table.lookup(pc4t, qidx).view(torch.int32),
                 lambda: lane_table.lookup_plain(pc4t, qidx).view(torch.int32))
    b6 = {
        "name": "lane_table", "route": "cuda",
        "source": "bbtools_torch/csrc/lane_table.cu",
        "replaces": "bbtools_tpu/ops/lane_table.py:27",
        **r6,
    }
    return [b1, b2, b3, b5, b6]


def counters():
    from bbtools_torch.ops import lane_index, lane_table, mm_match, overlap_scan, scan

    return {
        "lane_lookup": lane_index.lane_lookup,
        "cummax_i64": scan.cummax_i64,
        "mm_lookup": mm_match.mm_lookup,
        "overlap_scan": overlap_scan.overlap_counts,
        "lane_table": lane_table.lookup,
    }


def run_path(name: str, fn, needs: tuple[str, ...], launches: dict):
    """Run one path with every launch counter set to 0 just before it;
    fail unless each kernel in `needs` launched, and record the first
    path's count of each kernel in `launches`. Returns (fn's result, the
    path's counts)."""
    for c in counters().values():
        c.launches = 0
    result = fn()
    got = {k: c.launches for k, c in counters().items()}
    print(f"launches on the {name} path: {got}")
    for k in needs:
        if got[k] <= 0:
            raise AssertionError(f"{k} never launched on the {name} path")
        launches.setdefault(k, got[k])
    return result, got


def run_bbduk(name: str, flags: list[str], fin: str, work: str, device: str,
              showtimes: bool = False) -> tuple[str, str, float, str]:
    from bbtools_torch.cli import main as cli_main

    out = os.path.join(work, f"{name}.{device}.fq")
    stats = os.path.join(work, f"{name}.{device}.stats.txt")
    argv = ["bbduk", f"in={fin}", f"out={out}", f"stats={stats}",
            f"device={device}", *flags] + (["showtimes=t"] if showtimes else [])
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        cli_main(argv)
    return out, stats, time.perf_counter() - t0, err.getvalue()


def run_bbmerge(fin: list[str], work: str, tag: str, device: str):
    from bbtools_torch.cli import main as cli_main

    outs = [os.path.join(work, f"merge.{tag}.{device}.{x}")
            for x in ("merged.fq", "u1.fq", "u2.fq", "ihist.txt")]
    ins = [f"in1={fin[0]}", f"in2={fin[1]}"]
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        cli_main(["bbmerge", *ins, f"out={outs[0]}", f"outu1={outs[1]}",
                  f"outu2={outs[2]}", f"ihist={outs[3]}", f"device={device}"])
    return outs, time.perf_counter() - t0, err.getvalue()


def read_all(paths) -> list[bytes]:
    out = []
    for p in paths:
        with open(p, "rb") as fh:
            out.append(fh.read())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--pairs", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "bbtools_torch")):
        print("chip_smoke: run from a checkout (bbtools_torch/ missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = f"{smi} (nvidia-smi name, power.limit)"
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from bbtools_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.build_seconds:.1f} s) -> {os.path.relpath(build.library_path(), HERE)}")
    with open(build.library_path()[:-3] + ".log") as fh:
        for line in fh:
            if "registers" in line or "Compiling entry" in line:
                print("  " + line.strip())

    work = os.path.join(HERE, "_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    launches: dict[str, int] = {}
    try:
        fq = os.path.join(work, "reads.fq.gz")
        t0 = time.perf_counter()
        n_bases = make_fastq(fq, args.reads, args.seed)
        r1, r2 = (os.path.join(work, f"pairs_{m}.fq.gz") for m in (1, 2))
        make_pairs([r1, r2], args.pairs, args.seed + 1, 100, 400)
        tbo_in = os.path.join(work, "tbo.fq.gz")
        make_pairs([tbo_in], TBO_PAIRS, args.seed + 2, 100, 300)
        print(f"input: {args.reads} reads, {n_bases} bases; {args.pairs} pairs "
              f"(inserts 100-400); {TBO_PAIRS} interleaved pairs (inserts "
              f"100-300); made in {time.perf_counter() - t0:.1f} s")

        small = os.path.join(work, "head.fq.gz")
        head_fastq(fq, small, CHECK_READS)
        small_pairs = [os.path.join(work, f"head_pairs_{m}.fq.gz") for m in (1, 2)]
        head_fastq(r1, small_pairs[0], CHECK_READS)
        head_fastq(r2, small_pairs[1], CHECK_READS)
        small_tbo = os.path.join(work, "head_tbo.fq.gz")
        head_fastq(tbo_in, small_tbo, 2 * CHECK_READS)
        mm_reads = min(MM_READS, args.reads)
        mm_in = os.path.join(work, "head_mm.fq.gz")
        head_fastq(fq, mm_in, mm_reads)
        kernels = check_kernels(small, *small_pairs)
        print(f"kernel timings on: {card}")

        # ---- the BBDuk paths, through the CLI ----
        needs = {"adapters_fa": ("cummax_i64",), "1adapter": ("lane_lookup",)}
        for name in CONFIGS:
            (_, stats, dt, _), _ = run_path(
                f"bbduk {name}",
                lambda: run_bbduk(name, CONFIGS[name], fq, work, "cuda"),
                needs[name], launches)
            with open(stats) as fh:
                text = fh.read()
            total = int(text.split("#Total\t")[1].split()[0])
            matched = int(text.split("#Matched\t")[1].split()[0])
            # every third read carries an adapter tail, some too short
            # (under mink=11 bases) to be found: ~31% match
            if total != args.reads or not args.reads // 4 <= matched < args.reads // 2:
                raise AssertionError(f"{name}: {total} reads, {matched} matched")
            print(f"bbduk {name} device=cuda: {matched} of {total} reads matched")
            print(f"bbduk {name} device=cuda: {args.reads} reads in {dt:.2f} s = "
                  f"{args.reads / dt:.0f} reads/s, {n_bases / dt:.0f} bases/s "
                  f"(wall, incl. index build and IO) on {card}")

        # ---- BBDuk on the matcher backend (B3) ----
        (_, stats, dt, log), got = run_path(
            "bbduk mm",
            lambda: run_bbduk("mm", MM_CONFIG, mm_in, work, "cuda", showtimes=True),
            ("mm_lookup",), launches)
        if got["lane_lookup"] or got["cummax_i64"]:
            raise AssertionError("bbduk mm: the index is not the matcher")
        setup = float(log.split("Setup:")[1].split()[0])
        print(f"bbduk mm index build (ref=adapters,phix k=23 mink=11 hdist=2: "
              f"expansion, gate, matcher columns; CLI Setup phase): {setup:.1f} s")
        with open(stats) as fh:
            text = fh.read()
        total = int(text.split("#Total\t")[1].split()[0])
        matched = int(text.split("#Matched\t")[1].split()[0])
        if total != mm_reads or not mm_reads // 4 <= matched < mm_reads:
            raise AssertionError(f"mm: {total} reads, {matched} matched")
        print(f"bbduk mm device=cuda: {matched} of {total} reads matched; "
              f"{mm_reads} reads in {dt:.2f} s = {mm_reads / dt:.0f} reads/s "
              f"(wall, incl. the {setup:.1f} s index build), "
              f"{mm_reads / (dt - setup):.0f} reads/s after set-up, on {card}")

        # ---- paired BBDuk with tbo tpe (B1, B5, B6) ----
        (_, stats, dt, _), _ = run_path(
            "bbduk tbo",
            lambda: run_bbduk("tbo", TBO_FLAGS, tbo_in, work, "cuda"),
            ("lane_lookup", "overlap_scan", "lane_table"), {})
        print(f"bbduk tbo tpe device=cuda: {TBO_PAIRS} pairs in {dt:.2f} s = "
              f"{TBO_PAIRS / dt:.0f} pairs/s (wall) on {card}")

        # ---- BBMerge (B5, B6) ----
        (outs, dt, log), _ = run_path(
            "bbmerge", lambda: run_bbmerge([r1, r2], work, "main", "cuda"),
            ("overlap_scan", "lane_table"), launches)
        with open(outs[3]) as fh:
            merged = int(fh.read().split("#InsertCount\t")[1].split()[0])
        share = merged / args.pairs
        print(log.strip())
        if not MERGED_RANGE[0] <= share <= MERGED_RANGE[1]:
            raise AssertionError(f"bbmerge: merged share {share:.4f} outside {MERGED_RANGE}")
        print(f"bbmerge device=cuda: {merged} of {args.pairs} pairs merged "
              f"({share:.4f}, expected {MERGED_RANGE[0]}-{MERGED_RANGE[1]})")
        print(f"bbmerge device=cuda: {args.pairs} pairs in {dt:.2f} s = "
              f"{args.pairs / dt:.0f} pairs/s, {2 * args.pairs / dt:.0f} reads/s "
              f"(wall, incl. IO) on {card}")
        for row in kernels:
            row["launches"] = launches[row["name"]]

        # ---- CUDA against CPU, byte for byte, on the first reads ----
        for name, flags, fin in (*((n, CONFIGS[n], small) for n in CONFIGS),
                                 ("tbo", TBO_FLAGS, small_tbo)):
            files = {}
            for device in ("cuda", "cpu"):
                out, stats, _, _ = run_bbduk(name, flags, fin, work, device)
                files[device] = read_all((out, stats))
            if files["cuda"] != files["cpu"]:
                raise AssertionError(f"{name}: cuda and cpu outputs differ")
            print(f"bbduk {name}: cuda == cpu on {CHECK_READS} reads/pairs "
                  f"({len(files['cuda'][0])} output bytes, stats equal)")
        files = {d: read_all(run_bbmerge(small_pairs, work, "head", d)[0])
                 for d in ("cuda", "cpu")}
        if files["cuda"] != files["cpu"]:
            raise AssertionError("bbmerge: cuda and cpu outputs differ")
        print(f"bbmerge: cuda == cpu on {CHECK_READS} pairs (merged "
              f"{len(files['cuda'][0])} bytes, unmerged and ihist equal)")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
