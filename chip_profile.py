#!/usr/bin/env python3
"""Where BBMap's time goes in the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_profile.py [--reads N] [--seed S] [--out PATH]

From the root of a checkout, on a machine with a CUDA card. Makes the
smoke run's BBMap input (a seeded genome of E. coli K-12's length, 151
bp reads with 1% substitutions and 1-10 bp indels in 10% of them), maps
one batch to build the kernels and warm up, then:

  1. maps N reads (100,000 by default) under cProfile on device=cuda and
     prints the wall and the functions with the most host time;
  2. maps the first 3 batches (12,288 reads) under torch.profiler and
     prints the device time by kernel, the launches, and the device-busy
     share (kernel time over the traced wall), beside the same reads'
     untraced wall.

The full tables go to PATH (profile_bbmap.txt by default). Imports
nothing of JAX. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="profile_bbmap.txt")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import ECOLI_LEN, head_fastq, run_tool

    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.kernels import build
    from bbtools_torch.utils.synth import random_genome, random_reads, write_reads

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    build.library()
    work = os.path.join(HERE, "_smoke_work", "profile")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    report = open(args.out, "w")
    try:
        ref_fa = os.path.join(work, "ref.fa")
        write_fasta(ref_fa, random_genome(ECOLI_LEN, seed=args.seed))
        fq = os.path.join(work, "reads.fq.gz")
        write_reads(fq, random_reads(load_reference(ref_fa), args.reads, read_len=151,
                                     snp_rate=0.01, indel_rate=0.1,
                                     indel_range=(1, 10), seed=args.seed + 3))
        head = os.path.join(work, "head.fq.gz")
        head_fastq(fq, head, 3 * 4096)
        sam = os.path.join(work, "out.sam")
        bbmap = [f"ref={ref_fa}", f"out={sam}"]
        run_tool("bbmap", [*bbmap, f"in={head}"], "cuda")  # warm-up

        prof = cProfile.Profile()
        prof.enable()
        tool, dt, _ = run_tool("bbmap", [*bbmap, f"in={fq}"], "cuda")
        torch.cuda.synchronize()
        prof.disable()
        print(f"cProfile: {args.reads} reads in {dt:.2f} s = {args.reads / dt:.0f} reads/s "
              f"(index {tool.index_seconds:.2f} s, fused overflows {tool.fused_overflows}) "
              f"on {smi}")
        for key, n in (("tottime", 25), ("cumulative", 40)):
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(n)
            report.write(buf.getvalue())
            if key == "tottime":
                print("\n".join(buf.getvalue().splitlines()[:40]))

        _, plain_wall, _ = run_tool("bbmap", [*bbmap, f"in={head}"], "cuda")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as p:
            _, traced_wall, _ = run_tool("bbmap", [*bbmap, f"in={head}"], "cuda")
            torch.cuda.synchronize()
        ka = p.key_averages()
        # the kernels themselves, not the host ops that launched them
        dev = [e for e in ka if e.device_type == DeviceType.CUDA]
        dev.sort(key=lambda e: -e.self_device_time_total)
        busy_us = sum(e.self_device_time_total for e in dev)
        launches = sum(e.count for e in dev)
        print(f"torch.profiler: 12,288 reads, traced wall {traced_wall:.2f} s (untraced "
              f"{plain_wall:.2f} s); device kernel time {busy_us / 1e6:.3f} s over "
              f"{launches} kernel launches; device busy {busy_us / 1e6 / traced_wall:.4f} "
              f"of the traced wall, {busy_us / 1e6 / plain_wall:.4f} of the untraced")
        print(f"{'device ms':>10} {'count':>8}  kernel")
        for e in dev[:15]:
            print(f"{e.self_device_time_total / 1e3:10.2f} {e.count:8d}  {e.key[:90]}")
        report.write(ka.table(sort_by="self_device_time_total", row_limit=60))
    finally:
        report.close()
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
