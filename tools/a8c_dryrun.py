"""CPU dry run of the JAX package on the inputs of chip_smoke.py's phase
of the last device-using tools (msa, indelfree, kmercoverage,
bloomfilter, polyfilter, the CellNet family, calibrate), made with the
smoke's own generators from its seed: the counts and the bounds that
phase and the CPU tests hold the port to.

    JAX_PLATFORMS=cpu python tools/a8c_dryrun.py [--work DIR] [--only NAME]

NAME is one of msa, indelfree, kmercoverage, bloomfilter, polyfilter,
fit, calibrate. Each prints what the JAX package's tool made of the
input beside what was planted: msa's plantings found at their offset
with their NM (all 100,000 reads), indelfree's on the check's head (the
first 128 queries against the genome's first 262,144 bp; the whole
panel against the whole genome holds ~3.7 G booleans a chunk, a run for
the card), kmercoverage's histogram mode, bloomfilter's matched counts
and polyfilter's removed count over the smoke's full inputs. `fit`
trains `bbtools_tpu` and `bbtools_torch` (on the CPU) from the same
CellNet.create weights on the CPU tests' inputs and on the smoke's
training sets (its check's 2,000 vectors and the phase's 20,000) and
prints their largest weight and loss differences; `calibrate` prints
both packages' constants on tests/test_research.py's rows and on the
smoke's. Takes minutes (polyfilter's JAX path queries its sketch once a
read; `fit` runs the torch trainer over 20,000 vectors for 2,000 epochs
on one core).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as smoke  # noqa: E402


def make_inputs(work: str, seed: int) -> tuple[dict, dict]:
    """The smoke's inputs of the phase, from its seed, as its main makes
    them: config #1's reads, the E. coli-length genome, the bloom reads
    (of the map reads), config #2's data, the L5 data (the 16S variants)
    and the phase's own (make_a8c_data)."""
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.utils.synth import random_genome, random_reads, write_reads

    def w(name):
        return os.path.join(work, name)

    fq = w("reads.fq.gz")
    smoke.make_fastq(fq, 200_000, seed)
    ref_fa = w("ecoli_len.fa")
    write_fasta(ref_fa, random_genome(smoke.ECOLI_LEN, seed=seed))
    genome = load_reference(ref_fa)
    map_fq = w("map.fq.gz")
    write_reads(map_fq, random_reads(genome, smoke.MAP_READS, read_len=151, snp_rate=0.01,
                                     indel_rate=0.1, indel_range=(1, 10), seed=seed + 3))
    bloom_fq = w("bloom.fq.gz")
    smoke.make_bloom_reads(map_fq, bloom_fq, seed + 21)
    asm = smoke.make_asm_data(work, seed + 10)
    l5 = smoke.make_l5_data(work, genome, seed + 50)
    a8c = smoke.make_a8c_data(work, genome, ref_fa, fq, bloom_fq, asm, l5, seed + 60)
    return a8c, {"fq": fq}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", default=os.path.join(HERE, "_smoke_work", "a8c_dryrun"))
    ap.add_argument("--only", default=None)
    ap.add_argument("--seed", type=int, default=1, help="chip_smoke.py's --seed")
    args = ap.parse_args(argv)
    from bbtools_tpu.cli import main as jmain

    os.makedirs(args.work, exist_ok=True)

    def w(name):
        return os.path.join(args.work, name)

    def run(argv, stdout=False):
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            jmain(argv)
        print(f"  {argv[0]}: {time.perf_counter() - t0:.1f} s; {err.getvalue().strip()}",
              flush=True)
        return out.getvalue()

    def want(name):
        return args.only in (None, name)

    t0 = time.perf_counter()
    a8c, d = make_inputs(args.work, args.seed)
    print(f"inputs made in {time.perf_counter() - t0:.1f} s", flush=True)

    if want("msa"):
        sam = w("msa.jax.sam")
        run(["msa", f"in={a8c['msa']}", f"ref={a8c['primers']}", f"out={sam}"])
        names = [b"p0", b"p1", b"r_p0", b"r_p1"]
        site = {(r[0], r[2]): (int(r[3]) - 1, int(r[11].split(b":")[-1]))
                for r in smoke.sam_body(sam)}
        missed = [p for p in a8c["msa_planted"]
                  if site.get((names[p[1]], b"m%d" % p[0])) != (p[2], p[3])]
        print(f"msa: plantings found at their offset and NM: "
              f"{len(a8c['msa_planted']) - len(missed)} of {len(a8c['msa_planted'])}; "
              f"missed {missed[:10]}")
    if want("indelfree"):
        ifa = a8c["ifa"]
        sam = w("ifa.jax.sam")
        run(["indelfree", f"in={ifa['check_q']}", f"ref={ifa['check_ref']}", f"out={sam}",
             *smoke.IFA_FLAGS])
        hits = {(r[0], int(r[1]) // 16, int(r[3]), int(r[11].split(b":")[-1]))
                for r in smoke.sam_body(sam)}
        head = ifa["planted"][:smoke.IFA_CHECK_PLANTED]
        print(f"indelfree (the check's head): {len(hits)} hits; plantings found "
              f"{sum(p in hits for p in head)} of {len(head)}")
    if want("kmercoverage"):
        hist = w("kc.jax.hist.txt")
        run(["kmercoverage", f"in={a8c['kc_in']}", f"out={w('kc.jax.fq')}", f"hist={hist}",
             "k=31"])
        with open(hist) as fh:
            counts = [int(ln.split("\t")[1]) for ln in fh.read().splitlines()[1:]]
        print(f"kmercoverage: histogram mode {int(np.argmax(counts))} "
              f"({max(counts)} reads); {sum(counts)} reads")
    if want("bloomfilter"):
        run(["bloomfilter", f"in={a8c['bloom_in']}", f"ref={a8c['ref_fa']}",
             f"out={w('bf.jax.fq')}", f"outm={w('bf.jax.m.fq')}", "k=31"])
        matched = smoke.fastq_lengths(w("bf.jax.m.fq"))
        real = sum(not k.startswith(b"junk") for k in matched)
        print(f"bloomfilter: matched {len(matched)}: {real} genome reads, "
              f"{len(matched) - real} foreign")
    if want("polyfilter"):
        run(["polyfilter", f"in={a8c['poly']}", f"out={w('pf.jax.fq')}",
             f"outb={w('pf.jax.b.fq')}", f"extra={a8c['poly']}"])
        print(f"polyfilter: {a8c['poly_tails']} reads given a poly-G tail")
    if want("fit"):
        fit_dryrun(a8c, w)
    if want("calibrate"):
        src = w("cal_test.tsv")
        smoke.make_cal_rows(src, 500, np.random.default_rng(0))
        from bbtools_torch.cli import main as tmain

        for path, epochs in ((src, 1200), (a8c["cal"], 2000)):
            for name, cli, extra in (("jax", jmain, []), ("torch", tmain, ["device=cpu"])):
                out = io.StringIO()
                with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
                    cli(["calibrate", f"in={path}", f"epochs={epochs}", *extra])
                print(f"calibrate {os.path.basename(path)} epochs={epochs} {name}: "
                      f"{out.getvalue().strip()}", flush=True)
    return 0


def fit_dryrun(a8c: dict, w):
    """bbtools_tpu's and bbtools_torch's CellNet.fit from the same start
    on the CPU: the largest weight and loss differences."""
    from bbtools_torch.core.dna import encode
    from bbtools_torch.ml.cellnet import CellNet as TNet
    from bbtools_tpu.ml.cellnet import CellNet as JNet
    from bbtools_tpu.models.mltools import load_vectors, vectorize_batch

    def both(label, dims, x, y, epochs, lr, hidden="SIG", seed=1):
        j = JNet.create(dims, seed=seed, hidden=hidden)
        t = TNet.create(dims, seed=seed, hidden=hidden)
        t.device = "cpu"
        t0 = time.perf_counter()
        lj = j.fit(x, y, epochs=epochs, lr=lr)
        t1 = time.perf_counter()
        lt = t.fit(x, y, epochs=epochs, lr=lr)
        t2 = time.perf_counter()
        dw = max(float(np.abs(a - b).max()) for a, b in zip(j.weights + j.biases,
                                                             t.weights + t.biases))
        print(f"fit {label} {dims} x {len(x)} rows, {epochs} epochs, lr {lr}: loss "
              f"{lj:.6e} / {lt:.6e}, |dloss| {abs(lj - lt):.2e}, max |dw| {dw:.2e} "
              f"({t1 - t0:.1f} s / {t2 - t1:.1f} s)", flush=True)

    x = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
    both("xor (tests/test_cellnet.py)", [2, 8, 1], x, np.array([[0], [1], [1], [0]],
                                                               np.float32), 1500, 0.05, "TANH")
    rng = np.random.default_rng(1)
    gc = [rng.choice(list(b"GCGCGCAT"), 60).astype(np.uint8) for _ in range(80)]
    at = [rng.choice(list(b"ATATATGC"), 60).astype(np.uint8) for _ in range(80)]
    codes = np.stack([encode(bytes(s)) for s in gc + at])
    y = np.array([[1]] * 80 + [[0]] * 80, np.float32)
    for k, width in ((2, 55), (0, 55)):
        xv = vectorize_batch(codes, np.full(160, 60), width, k)
        h = max(4, min(64, xv.shape[1] // 2))
        both(f"tests/test_mltools.py k={k}", [xv.shape[1], h, 1], xv, y, 600, 0.1)
    for label, tsv in (("smoke check", a8c["ml_check"]),
                       ("smoke phase", smoke.ml_vectors(a8c["ml"], os.path.dirname(
                           a8c["ml_check"]), None, "ml_train"))):
        xv, yv = load_vectors(tsv)
        h = max(4, min(64, xv.shape[1] // 2))
        both(label, [xv.shape[1], h, 1], xv, yv, 2000, 0.05, seed=0)


if __name__ == "__main__":
    sys.exit(main())
