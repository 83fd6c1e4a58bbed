"""CPU dry run of the JAX package on the inputs of chip_smoke.py's phase
of the tools on the glocal identity aligner (ROADMAP L5), at a quarter
of their size (alltoall at any fraction, `--ata-scale`): the counts
that phase holds the port to on the card.

    JAX_PLATFORMS=cpu python tools/l5_dryrun.py [--work DIR] [--only NAME]
        [--ata-scale S]

`--ata-scale 1` makes alltoall's input at full size from the smoke's
seed, so it is the smoke's own input and the JAX package's deviations
are the ones the card must reproduce.

It makes the inputs with chip_smoke.py's own generators (alltoall's 16S
variants, splitribo's rRNA reads, icecream's PacBio subreads), runs
`bbtools_tpu`'s alltoall, splitribo, icecream trim=t and kzt=t,
testalignersbatch (length=2000 samples=10, at full size) and
testalignerslength (its defaults) on the CPU, and prints, for each, what
came out beside what was planted. Takes tens of minutes: the JAX
package refines each icecream hit on the host, one Python step a DP cell.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", default=os.path.join(HERE, "_smoke_work", "l5_dryrun"))
    ap.add_argument("--only", default=None)
    ap.add_argument("--seed", type=int, default=51)
    ap.add_argument("--ata-scale", type=int, default=4,
                    help="alltoall's input is ATA_SEQS // S sequences")
    args = ap.parse_args(argv)
    from bbtools_tpu.cli import main as jmain
    from bbtools_tpu.io.fasta import load_reference, write_fasta
    from bbtools_tpu.utils.synth import random_genome

    os.makedirs(args.work, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    def w(name):
        return os.path.join(args.work, name)

    def run(argv):
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                res = jmain(argv)
            except Exception as e:  # noqa: BLE001 - the JAX package's own failure
                res = f"raised {type(e).__name__}: {str(e)[:200]}"
        return res, out.getvalue(), err.getvalue(), time.perf_counter() - t0

    report = {}
    if args.only in (None, "alltoall"):
        n = smoke.ATA_SEQS // args.ata_scale
        planted = smoke.make_ata_seqs(w("ata.fa"), n, rng)
        _, _, _, dt = run(["alltoall", f"in={w('ata.fa')}", f"out={w('ata.txt')}"])
        with open(w("ata.txt")) as fh:
            got = np.array([ln.split("\t")[1:] for ln in fh.read().splitlines()[1:]],
                           np.float64) / 100
        dev = np.abs(got - planted)[np.triu_indices(n, 1)]
        report["alltoall"] = {"sequences": n, "pairs": len(dev), "max_dev": float(dev.max()),
                              "mean_dev": float(dev.mean()),
                              "p99_dev": float(np.quantile(dev, 0.99)), "seconds": dt}
        print(json.dumps({"alltoall": report["alltoall"]}), flush=True)
    if args.only in (None, "splitribo"):
        planted = smoke.make_ribo_reads(w("ribo.fa"), smoke.RIBO_READS // 4, rng)
        _, _, err, dt = run(["splitribo", f"in={w('ribo.fa')}", f"out={w('ribo_#.fa')}"])
        counts = {m[1]: int(m[2]) for m in re.finditer(r"^(\S+):\t(\d+)$", err, re.M)}
        truth = {}  # type planted -> type routed, read by read
        for t in (*smoke.RIBO_TYPES, "m16S", "m18S", "p16S", "junk"):
            if os.path.exists(w(f"ribo_{t}.fa")):
                with open(w(f"ribo_{t}.fa"), "rb") as fh:
                    for ln in fh:
                        if ln.startswith(b">"):
                            key = f"{ln[1:].split(b'_')[0].decode()}->{t}"
                            truth[key] = truth.get(key, 0) + 1
        report["splitribo"] = {"planted": planted, "routed": counts, "by_read": truth,
                               "seconds": dt}
        print(json.dumps({"splitribo": report["splitribo"]}), flush=True)
    if args.only in (None, "icecream"):
        if not os.path.exists(w("genome.fa")):
            write_fasta(w("genome.fa"), random_genome(smoke.ECOLI_LEN, seed=1))
        codes = load_reference(w("genome.fa")).scaffold_codes(0)
        n_reads, n_planted, n_even = smoke.make_subreads(
            w("pb.fq.gz"), codes, smoke.IC_ZMWS // 4, smoke.IC_PLANTED // 4, rng)
        report["icecream"] = {"subreads": n_reads, "planted": n_planted,
                              "planted_of_even_length": n_even}
        for mode in ("trim=t", "kzt=t"):
            _, _, err, dt = run(["icecream", f"in={w('pb.fq.gz')}", f"outg={w('g.fq')}",
                                 f"outb={w('b.fq')}", mode])
            report["icecream"][mode] = {
                "flagged": int(err.split("Ice cream flagged:")[1].split()[0]),
                "zmws_discarded": (int(err.split("ZMWs discarded:")[1].split()[0])
                                   if "ZMWs discarded" in err else None),
                "seconds": dt}
            print(json.dumps({"icecream": report["icecream"]}), flush=True)
    if args.only in (None, "ladders"):
        for name, argv in (("testalignersbatch", ["length=2000", "samples=10"]),
                           ("testalignerslength", [])):
            res, out, err, dt = run([name, *argv])
            table = [ln.split("\t") for ln in out.splitlines()[1:]]
            report[name] = {"levels": {r[0]: float(r[1]) for r in table},
                            "result": res if isinstance(res, str) else None, "seconds": dt}
            if name == "testalignersbatch":
                report[name]["max_dev_at_ani_ge_0.75"] = max(
                    abs(float(r[1]) - float(r[0])) for r in table if float(r[0]) >= 0.75)
            print(json.dumps({name: report[name]}), flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
