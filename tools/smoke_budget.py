#!/usr/bin/env python3
"""The smoke's time budget on one card: the long-read presets at two
depths, in turns, and the group-4 phase, in one call.

    python3 tools/smoke_budget.py [--before 51,13,16] [--after L,C,S] [--seed S]

From the root of a checkout, on a machine with a CUDA card. It makes
the smoke's inputs for these paths (chip_smoke.py's generators and
seeds), builds the kernels, then times `mappacbio` and `bbmapskimmer`
(chip_smoke.py's long-read phase) at two depths, each given as long
reads, chunked reads and the skimmer's records: --before (by default
51 + 13 records and the skimmer on 16) and --after (by default the
smoke's LONG_READS, LONG_CHUNKED and SKIM_READS), in the
order before, after, after, before, each a CLI run on device=cuda with
its index build; then runs chip_smoke.g4_phases (postfilter,
reassemble, fll2simulate and the pruned fill) and its fill check, and
prints each phase's seconds. The card's name and power limit come first.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def long_inputs(work: str, codes, seed: int, n_long: int, n_chunked: int, n_skim: int,
                tag: str) -> tuple[str, str]:
    """mapPacBio's FASTA and the skimmer's head of it, made as
    chip_smoke.make_a2_data makes them."""
    import chip_smoke as cs

    rng = np.random.default_rng(seed)
    long_fa, chunked = (os.path.join(work, f"long_{tag}{x}.fa") for x in ("", "_c"))
    cs.make_long_reads(long_fa, codes, rng, n_long, *cs.LONG_RANGE)
    cs.make_long_reads(chunked, codes, rng, n_chunked, *cs.LONG_CHUNKED_RANGE, tag="c")
    with open(long_fa, "ab") as fh, open(chunked, "rb") as src:
        fh.write(src.read())
    skim = os.path.join(work, f"long_{tag}_skim.fa")
    with open(long_fa, "rb") as src, open(skim, "wb") as fh:
        fh.write(b"".join(src.read().splitlines(keepends=True)[: 2 * n_skim]))
    return long_fa, skim


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before", default="51,13,16")
    ap.add_argument("--after", default=None)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("smoke_budget: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.kernels import build
    from bbtools_torch.utils.synth import random_genome, random_reads, write_reads

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    card = f"{smi} (nvidia-smi name, power.limit)"
    work = os.path.join(HERE, "_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        t0 = time.perf_counter()
        build.library()
        print(f"kernel build {time.perf_counter() - t0:.1f} s")
        ref_fa = os.path.join(work, "ecoli_len.fa")
        write_fasta(ref_fa, random_genome(cs.ECOLI_LEN, seed=args.seed))
        genome = load_reference(ref_fa)
        codes = genome.scaffold_codes(0)
        before = tuple(int(x) for x in args.before.split(","))
        after = (tuple(int(x) for x in args.after.split(",")) if args.after
                 else (cs.LONG_READS, cs.LONG_CHUNKED, cs.SKIM_READS))
        sets = {d: long_inputs(work, codes, args.seed + 30, *d, tag=f"{i}")
                for i, d in enumerate((before, after))}
        secs: dict = {d: [] for d in sets}
        for d in (before, after, after, before):
            for tool, fin in zip(("mappacbio", "bbmapskimmer"), sets[d]):
                sam = os.path.join(work, f"{tool}.sam")
                _, dt, _ = cs.run_tool(tool, [f"ref={ref_fa}", f"in={fin}", f"out={sam}",
                                              "ow=t"], "cuda")
                secs[d].append(dt)
                print(f"{tool} at {d[0] + d[1]} records (the skimmer on {d[2]}): {dt:.2f} s "
                      f"on {card}")
        for d, ts in secs.items():
            print(f"long-read presets at {d[0] + d[1]} records, the skimmer on {d[2]}: "
                  f"mappacbio {ts[0]:.2f} and {ts[2]:.2f} s, bbmapskimmer {ts[1]:.2f} and "
                  f"{ts[3]:.2f} s; the pair {(ts[0] + ts[1]):.2f} and {(ts[2] + ts[3]):.2f} s")

        t0 = time.perf_counter()
        asm = cs.make_asm_data(work, args.seed + 10)
        second_fa = os.path.join(work, "second.fa")
        write_fasta(second_fa, random_genome(cs.SECOND_GENOME, seed=args.seed + 32))
        map_small = os.path.join(work, "map_head.fq.gz")
        write_reads(map_small, random_reads(genome, cs.MAP_CHECK_READS, read_len=151,
                                            snp_rate=0.01, indel_rate=0.1,
                                            indel_range=(1, 10), seed=args.seed + 3))
        g4 = cs.make_g4_data(work, asm, second_fa, args.seed + 80)
        print(f"group 4 input {time.perf_counter() - t0:.1f} s")
        phase_s: dict = {}
        pending = cs.g4_phases(g4, {"ref_fa": ref_fa, "map_small": map_small}, work, card,
                               phase_s)
        cs.g4_fill_check(pending)
        print("group-4 phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
              + f"; total {sum(phase_s.values()):.1f}")
    finally:
        for proc in cs.SIDE_PROCS:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
