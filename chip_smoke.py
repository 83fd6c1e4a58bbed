#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bbtools_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--reads N] [--seed S]

From the root of a checkout, on a machine with a CUDA card:

  1. prints the card (nvidia-smi name and power limit) and versions;
  2. builds the CUDA kernels from bbtools_torch/csrc with nvcc;
  3. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes (exact equality), and times both with CUDA
     events;
  4. drives `bbduk` through the CLI entry point on device=cuda over a
     seeded gzipped FASTQ of N reads (1,000,000 by default) in two
     configurations: ref=adapters at hdist=1 (the sorted-join backend,
     kernel cummax_i64) and one literal adapter (the lane backend, kernel
     lane_lookup); every launch counter must move;
  5. runs both configurations on the first 20,000 reads on
     device=cuda and device=cpu and requires byte-equal output FASTQ and
     stats files.

Its last line is {"ok": true, "device": {...}}; any failed phase raises
and the script exits non-zero. Without CUDA, or outside a checkout, it
exits non-zero and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ADAPTER = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
COMMON = ["k=23", "mink=11", "hdist=1", "ktrim=r", "minlen=40"]
CONFIGS = {
    "adapters_fa": ["ref=adapters"] + COMMON,
    "1adapter": [f"literal={ADAPTER.decode()}"] + COMMON,
}
BATCH = 16384  # reads per batch of the bbduk main path (batchreads default)
CHECK_READS = 20_000  # reads of the CUDA-against-CPU comparison


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


def check_kernels(fq: str, card: str) -> list[dict]:
    import torch

    from bbtools_torch.io.fastq import FastqReader
    from bbtools_torch.models.bbduk import build_index, parse_args
    from bbtools_torch.ops import lane_index, scan, sort_join
    from bbtools_torch.ops.bbduk_scan import KScanConfig, canonical_keys
    from bbtools_torch.ops.kmers import rolling_kmers

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
    print(f"kernel timings on: {card}")
    return [b1, b2]


def run_bbduk(name: str, fq: str, work: str, device: str) -> tuple[str, str, float]:
    from bbtools_torch.cli import main as cli_main

    out = os.path.join(work, f"{name}.{device}.fq")
    stats = os.path.join(work, f"{name}.{device}.stats.txt")
    argv = ["bbduk", f"in={fq}", f"out={out}", f"stats={stats}",
            f"device={device}", *CONFIGS[name]]
    t0 = time.perf_counter()
    cli_main(argv)
    return out, stats, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=1_000_000)
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
    from bbtools_torch.ops import lane_index, scan

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
    try:
        fq = os.path.join(work, "reads.fq.gz")
        t0 = time.perf_counter()
        n_bases = make_fastq(fq, args.reads, args.seed)
        print(f"input: {args.reads} reads, {n_bases} bases, "
              f"made in {time.perf_counter() - t0:.1f} s")

        small = os.path.join(work, "head.fq.gz")
        head_fastq(fq, small, CHECK_READS)
        kernels = check_kernels(small, card)

        # the main path, through the CLI, with the launch counters from 0
        lane_index.lane_lookup.launches = 0
        scan.cummax_i64.launches = 0
        for name in CONFIGS:
            _, stats, dt = run_bbduk(name, fq, work, "cuda")
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
        launches = {"lane_lookup": lane_index.lane_lookup.launches,
                    "cummax_i64": scan.cummax_i64.launches}
        print(f"launches on the main path: {launches}")
        for row in kernels:
            row["launches"] = launches[row["name"]]
            if row["launches"] <= 0:
                raise AssertionError(f"{row['name']} never launched on the main path")

        # CUDA against CPU, byte for byte, on the first reads
        for name in CONFIGS:
            files = {}
            for device in ("cuda", "cpu"):
                out, stats, _ = run_bbduk(name, small, work, device)
                with open(out, "rb") as fo, open(stats, "rb") as fs:
                    files[device] = (fo.read(), fs.read())
            if files["cuda"] != files["cpu"]:
                raise AssertionError(f"{name}: cuda and cpu outputs differ")
            print(f"bbduk {name}: cuda == cpu on {CHECK_READS} reads "
                  f"({len(files['cuda'][0])} output bytes, stats equal)")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
