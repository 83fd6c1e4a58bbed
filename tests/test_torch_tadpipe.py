"""The port's assembly pipeline against the JAX package's on the CPU, on
tests/test_tadpipe.py's 6,000 bp genome: `python -m bbtools_torch
tadwrapper`/`tadpolewrapper` (contigs at each k, the recommended k),
`tadpipe` with every stage on (BBDuk's adapter and quality trim with tbo
tpe, BBMerge ecco, BBMerge k=75 extend2=120 rem ecct, Tadpole
mode=correct k=50, the wrapper) and its trim stage through `bbduk`
alone, and `stats`/`assemblystats`, each byte-equal to the JAX
package's. The reads run into their adapters past short inserts, so the
trim stage has work.

Both tadpipes run the packages' BBMerge in-process, and the JAX
package's writes into its module-level presets (`nn=t`, `mininsert=`):
each test runs against a fresh copy of them (`pristine_jax_presets`, as
in tests/test_torch_bbmerge.py)."""

import contextlib
import copy
import io
import os

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as tmain
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.models import bbmerge as jbm

ADAPTER1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
ADAPTER2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
COMP = bytes.maketrans(b"ACGT", b"TGCA")
JAX_PRESETS = copy.deepcopy(jbm.PRESETS)
#: tadpipe's trim stage (TadPipe.java :230-260), as both packages write it
TRIM_FLAGS = ["ref=adapters", "ktrim=r", "k=23", "mink=11", "hdist=1", "qtrim=r",
              "trimq=10", "tbo", "tpe", "minlen=62"]


@pytest.fixture(autouse=True)
def pristine_jax_presets(monkeypatch):
    monkeypatch.setattr(jbm, "PRESETS", copy.deepcopy(JAX_PRESETS))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU runs: the suite runs several
    test processes on shared cores, where torch's thread pool, woken at
    each of the many small ops of the mate selection and the fills,
    stalls (as in tests/test_torch_bbmap.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(17)
    return bytes(b"ACGT"[c] for c in rng.integers(0, 4, 6000))


def _paired_reads(genome, n, lo, hi, rl, seed, err=0.003):
    """n pairs of rl bp from inserts of lo..hi bp, each mate running into
    its adapter past the insert, with `err` substitutions (at phred 15)
    and a low-quality 3' tail (phred 5) on every 10th read."""
    rng = np.random.default_rng(seed)
    out = ([], [])
    for i in range(n):
        ins = int(rng.integers(lo, hi + 1))
        p = int(rng.integers(0, len(genome) - ins))
        frag = genome[p : p + ins]
        mates = ((frag + ADAPTER1 + b"A" * rl)[:rl],
                 (frag.translate(COMP)[::-1] + ADAPTER2 + b"A" * rl)[:rl])
        for m, r in enumerate(mates):
            s = np.frombuffer(r, np.uint8).copy()
            q = np.full(rl, ord("I"), np.uint8)
            e = rng.random(rl) < err
            s[e] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, e.sum())]
            q[e] = ord("0")
            if i % 10 == m:
                q[-12:] = ord("&")
            out[m].append(b"@r%d /%d\n%s\n+\n%s\n" % (i, m + 1, s.tobytes(), q.tobytes()))
    return b"".join(out[0]), b"".join(out[1])


@pytest.fixture(scope="module")
def reads(genome, tmp_path_factory):
    d = tmp_path_factory.mktemp("tadpipe")
    r1, r2 = _paired_reads(genome, 700, 100, 320, 150, 4)
    (d / "r1.fq").write_bytes(r1)
    (d / "r2.fq").write_bytes(r2)
    return d


def _stderr(fn, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        res = fn(argv)
    return res, err.getvalue()


def test_tadpipe_trim_stage_through_bbduk_equals_jax(reads, tmp_path):
    files = {}
    for pkg, main in (("jax", jmain), ("torch", tmain)):
        outs = [tmp_path / f"{pkg}.{x}" for x in ("t1.fq", "t2.fq", "stats.txt")]
        main(["bbduk", f"in={reads / 'r1.fq'}", f"in2={reads / 'r2.fq'}",
              f"out={outs[0]}", f"out2={outs[1]}", f"stats={outs[2]}", *TRIM_FLAGS]
             + (["device=cpu"] if pkg == "torch" else []))
        files[pkg] = [o.read_bytes() for o in outs]
    assert files["torch"] == files["jax"]
    # the adapters were found and cut (inserts of 100-150 bp) and the
    # low-quality tails trimmed; every insert passes minlen=62
    r1 = files["torch"][0].split(b"\n")[1::4]
    assert len(r1) == 700 and sum(len(s) < 150 for s in r1) > 100


def _contig_lens(fa: bytes) -> list:
    return [len(b"".join(r.split(b"\n")[1:])) for r in fa.split(b">")[1:]]


def test_tadwrapper_equals_jax(genome, tmp_path):
    """test_tadpipe.py's wrapper case: 1,500 single reads of 150 bp from
    inserts of 150 bp, k=21,31,62."""
    from bbtools_torch.cli import TOOLS

    r1, _ = _paired_reads(genome, 1500, 150, 150, 150, 3, err=0.0)
    (tmp_path / "r1.fq").write_bytes(r1)
    res = {}
    for pkg, main in (("jax", jmain), ("torch", tmain)):
        out = tmp_path / f"{pkg}_%.fa"
        argv = ["tadwrapper", f"in={tmp_path}/r1.fq", f"out={out}", "k=21,31,62"]
        _, log = _stderr(main, argv + (["device=cpu"] if pkg == "torch" else []))
        res[pkg] = (log.split("Recommended K:\t")[1].split()[0],
                    [(tmp_path / f"{pkg}_{k}.fa").read_bytes() for k in (21, 31, 62)])
    assert res["torch"] == res["jax"]
    assert max(max(_contig_lens(f), default=0) for f in res["torch"][1]) >= 2000
    assert TOOLS["tadpolewrapper"] is TOOLS["tadwrapper"]


def test_tadpipe_equals_jax(reads, tmp_path):
    """tadpipe k=31,62 with every stage on and deletetemp=f: the final
    contigs and every kept stage file byte-equal."""
    stages = ["trimmed_1.fq", "trimmed_2.fq", "ecco_1.fq", "ecco_2.fq", "merged.fq",
              "unmerged_1.fq", "unmerged_2.fq", "ecc_0.fq", "ecc_1.fq", "ecc_2.fq",
              "contigs_31.fa", "contigs_62.fa"]
    files, logs = {}, {}
    for pkg, main in (("jax", jmain), ("torch", tmain)):
        tmp = tmp_path / pkg
        argv = ["tadpipe", f"in={reads / 'r1.fq'}", f"in2={reads / 'r2.fq'}",
                f"out={tmp_path / pkg}.asm.fa", f"tmpdir={tmp}", "k=31,62", "deletetemp=f"]
        _, logs[pkg] = _stderr(main, argv + (["device=cpu"] if pkg == "torch" else []))
        files[pkg] = [(tmp_path / f"{pkg}.asm.fa").read_bytes()] + [
            (tmp / s).read_bytes() for s in stages]
        assert sorted(os.listdir(tmp)) == sorted(stages)
    for name, got, want in zip(["asm.fa"] + stages, files["torch"], files["jax"]):
        assert got == want, name
    log = logs["torch"]
    assert "Recommended K:" in log and "Merged by extension:" in log
    assert log.split("Recommended K:")[1].split()[0] == logs["jax"].split(
        "Recommended K:")[1].split()[0]
    assert max(_contig_lens(files["torch"][0])) >= 1500
    # the stages did work: trim cut reads, ecco changed bases, the merge
    # stage merged pairs, some by extension
    assert files["torch"][1] != (reads / "r1.fq").read_bytes()
    assert files["torch"][3] != files["torch"][1]
    assert int(log.split("Merged by extension: \t")[1].split()[0]) > 0
    assert files["torch"][5].count(b"\n") > 4 * 300


def test_stats_equals_jax(tmp_path):
    rng = np.random.default_rng(8)
    recs = []
    for i, n in enumerate([5000, 1200, 800, 300, 90, 2_500_000]):
        s = bytearray(b"ACGT"[c] for c in rng.integers(0, 4, n))
        if i % 2:
            s[n // 3 : n // 3 + 20] = b"N" * 20  # a gap splits it into contigs
        recs.append(b">c%d\n%s\n" % (i, bytes(s)))
    (tmp_path / "asm.fa").write_bytes(b"".join(recs))
    outs = {}
    for pkg, main, name in (("jax", jmain, "stats"), ("torch", tmain, "stats"),
                            ("torch2", tmain, "assemblystats")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main([name, f"in={tmp_path / 'asm.fa'}", "mingap=10"])
        outs[pkg] = buf.getvalue()
    assert outs["torch"] == outs["jax"] == outs["torch2"]
    assert "Main genome contig total:           \t9" in outs["torch"]
