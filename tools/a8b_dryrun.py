"""CPU dry run of the JAX package on the inputs of chip_smoke.py's
read-QC phase (rqcfilter2 and decontaminate), made with the smoke's own
generators from its seed: the filterstats.txt that the phase holds the
port's run on the card to (chip_smoke.A8B_FILTERSTATS), and where each
planted class leaves the pipeline.

    JAX_PLATFORMS=cpu python tools/a8b_dryrun.py [--work DIR] [--only NAME]

NAME is rqcfilter or decontaminate. The JAX package's filterbytile reads
only in=, so its rqcfilter fails on paired input with filterbytile=t; the
dry run runs that stage as the JAX package's filterbytile over the
interleaved pairs, which is what the port's paired filterbytile computes
(tests/test_torch_rqcfilter.py holds the two equal). Takes minutes (the
JAX package's BBMap on the CPU maps the ~17,000 reads that reach the
removal stage).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as smoke  # noqa: E402


def make_inputs(work: str, seed: int) -> dict:
    """The phase's inputs as the smoke's main makes them: the
    E. coli-length genome (seed), the second genome (make_a2_data's, seed
    + 32) and make_a8b_data's pairs and libraries (seed + 70)."""
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.utils.synth import random_genome

    ref_fa = os.path.join(work, "ecoli_len.fa")
    write_fasta(ref_fa, random_genome(smoke.ECOLI_LEN, seed=seed))
    second_fa = os.path.join(work, "second.fa")
    write_fasta(second_fa, random_genome(smoke.SECOND_GENOME, seed=seed + 32))
    genome = load_reference(ref_fa)
    return smoke.make_a8b_data(work, genome.scaffold_codes(0), second_fa, seed + 70)


def jax_paired_fbt(argv):
    """The JAX package's filterbytile on paired argv: its main on the
    interleaved pairs, split back into out= and out2=."""
    from bbtools_tpu.core.parser import tokenize
    from bbtools_tpu.io.fastq import FastqReader, FastqWriter, deinterleave, interleave
    from bbtools_tpu.models import filterbytile

    a = tokenize(argv)
    if not a.get("in2"):
        return filterbytile.FilterByTile(filterbytile.parse_args(argv)).run()
    inter, kept = a.get("out") + ".in.fq", a.get("out") + ".kept.fq"
    with FastqWriter(inter) as w:
        for b1, b2 in zip(FastqReader(a.get("in")), FastqReader(a.get("in2"))):
            w.add(interleave(b1, b2))
    res = filterbytile.FilterByTile(filterbytile.parse_args(
        [f"in={inter}", f"out={kept}"])).run()
    with FastqWriter(a.get("out")) as w1, FastqWriter(a.get("out2")) as w2:
        for b in FastqReader(kept):
            b1, b2 = deinterleave(b)
            w1.add(b1)
            w2.add(b2)
    os.remove(inter)
    os.remove(kept)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", default=os.path.join(HERE, "_smoke_work", "a8b_dryrun"))
    ap.add_argument("--only", default=None)
    ap.add_argument("--seed", type=int, default=1, help="chip_smoke.py's --seed")
    args = ap.parse_args(argv)
    from bbtools_tpu.cli import main as jmain
    from bbtools_tpu.models import filterbytile

    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.work)
    t0 = time.perf_counter()
    a8b = make_inputs(args.work, args.seed)
    print(f"inputs: {a8b['pairs']} pairs, planted "
          f"{ {k: len(v) for k, v in a8b['planted'].items()} }; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.only in (None, "rqcfilter"):
        t0 = time.perf_counter()
        out = os.path.join(args.work, "rqc.jax")
        filterbytile.main = jax_paired_fbt
        jmain(smoke.a8b_rqc_argv(a8b, (a8b["r1"], a8b["r2"]), out, ["ki=t"]))
        print(f"rqcfilter2 (JAX, CPU): {time.perf_counter() - t0:.1f} s")
        with open(os.path.join(out, "filterstats.txt")) as fh:
            stats = fh.read()
        print("filterstats.txt:\n" + stats, end="")
        print(f"equal to chip_smoke.A8B_FILTERSTATS: {stats == smoke.A8B_FILTERSTATS}")
        smoke.a8b_planted_check(a8b, out)
    if args.only in (None, "decontaminate"):
        t0 = time.perf_counter()
        out = os.path.join(args.work, "decon.jax")
        jmain(smoke.a8b_decon_argv(a8b, out))
        print(f"decontaminate (JAX, CPU): {time.perf_counter() - t0:.1f} s")
        smoke.decon_check(a8b, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
