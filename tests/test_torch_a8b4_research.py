"""A8b group 4's research launchers and the pruned fill on the CPU.

Each of the 19 research launcher names of the port against the JAX
package's on the same seeded inputs, one case a name: the cardinality
harness (six names, LogLog on the run's device), the ddl sketch
pipeline, the binning and log-collating launchers, and the two device pipelines,
postfilter (BBMap on the device, then pileup and FilterByCoverage) and
reassemble (Tadpole on the device once a tid_ input). The port's runs
of the device launchers take device=cpu. Every output file, the
standard output and the standard error are equal byte for byte. The
inputs are the JAX package's own test shapes (tests/test_research.py,
tests/test_tadpole.py's genome and read sizes).

`ops.msa.msa_fill_batch`, the pruned fill (fillLimitedX) and the
unlimited one, is held exactly to the JAX package's on
tests/test_msa.py's cases, with a task that prune mode kills; and
postfilter, reassemble and the cardinality harness run on the card
unless asked for the CPU."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from torch_parity import run_host_both, warm_native_codecs  # noqa: F401  (autouse)

ACGT = np.frombuffer(b"ACGT", np.uint8)
PHIX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "bbtools_tpu", "resources", "phix2.fa.gz")
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _seq(rng, n):
    return ACGT[rng.integers(0, 4, n)].tobytes()


def _reads(rng, src, n, length=100, err=0.0, name=b"r"):
    """n reads of `length` from src, half reverse-complemented, with
    substitutions at rate err."""
    out = []
    for i in range(n):
        p = int(rng.integers(0, len(src) - length))
        s = bytearray(src[p:p + length])
        for j in np.nonzero(rng.random(length) < err)[0]:
            s[j] = ACGT[(int(np.searchsorted(ACGT, s[j])) + 1) % 4]
        s = bytes(s)
        if i % 2:
            s = s.translate(COMP)[::-1]
        out.append(b"@%s%d\n%s\n+\n%s\n" % (name, i, s, b"I" * length))
    return b"".join(out)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs every case reads, made once from seed 47."""
    from bbtools_tpu.cli import main as jmain

    d = tmp_path_factory.mktemp("a8b4_research_in")
    rng = np.random.default_rng(47)
    with contextlib.redirect_stderr(io.StringIO()):
        jmain(["ddlwriter", f"in={PHIX}", f"out={d}/ddl.tsv", "mode=perfile", "size=500"])
    g1 = _seq(rng, 3000)
    (d / "two.fa").write_bytes(b">a tid_5\n" + g1 + b"\n>b tid_5\n" + g1[:2000] + _seq(rng, 1000)
                               + b"\n>c tid_6\n" + _seq(rng, 3000) + b"\n")
    with contextlib.redirect_stderr(io.StringIO()):
        jmain(["ddlwriter", f"in={d}/two.fa", f"out={d}/ddl2.tsv", "mode=persequence",
               "size=200", "k=21"])
    (d / "hits.tsv").write_bytes(b"#query\tref\tscore\tani\n" + b"".join(
        b"q%d\tref%d\tscore=%.3f\tani=%.3f\tlabel\n" % (i, i % 3, 0.1 * i, 0.9 + 0.01 * i)
        for i in range(8)))
    (d / "cov.tsv").write_text("#c\ts0\ts1\ts2\n" + "".join(
        f"ctg{i}\t{v}\t{v * 1.01}\t{1.0 + i % 3}\n" for i, v in enumerate(range(1, 21))))
    with open(d / "bins.fa", "w") as f:
        for g in range(2):
            base = "".join("ACGT"[i] for i in rng.integers(0, 4, 4000))
            for c in range(2):
                f.write(f">ctg{g}_{c}_tid_{g + 1}\n{base[c * 1000:c * 1000 + 2500]}\n")
    (d / "bins_cov.tsv").write_text("#ID\tAvg_fold\n" + "".join(
        f"ctg{g}_{c}_tid_{g + 1}\t{10 + 5 * g + c}\n" for g in range(2) for c in range(2)))
    (d / "m1.tsv").write_text("#ids\n1\t0.9\t0.8\n0.9\t1\t0.7\nname\t0.5\n")
    (d / "m2.tsv").write_text("#ids\n1\t0.95\t0.85\n0.95\t1\t0.75\n")
    (d / "bloom.log").write_text(
        "threads=8\nkeys=1000 increments=2000\njunk line\nTime: 1.2 s\nreads/s 5000\n"
        "another bad line\nbits=32 hashes=3 cells=100\n")
    for n, (pairs, joined, amb, ns) in (("f1", (1000, 800, 20, 180)), ("f2", (500, 300, 5, 195))):
        (d / f"{n}.log").write_text(
            f"Pairs:               \t{pairs}\nJoined:              \t{joined}   \t"
            f"{100 * joined / pairs:.3f}%\nAmbiguous:           \t{amb}\n"
            f"No Solution:         \t{ns}\n")
    # postfilter: a 12 kb genome cut into two covered contigs of 5,000 bp,
    # an uncovered one of 1,500 bp and a covered one of 150 bp; 240 reads
    g = _seq(rng, 12000)
    (d / "asm.fa").write_bytes(b">big1\n" + g[:5000] + b"\n>big2\n" + g[5000:10000]
                               + b"\n>lonely\n" + _seq(rng, 1500) + b"\n>tiny\n"
                               + g[10000:10150] + b"\n")
    (d / "pf.fq").write_bytes(_reads(rng, g[:10150], 240, err=0.005))
    # reassemble: two tid_ inputs of 300 reads of 100 bp (15x) of a
    # 2,000 bp region each
    for tid, tag in ((1, "a"), (2, "b")):
        (d / f"tid_{tid}_{tag}.fq").write_bytes(_reads(rng, _seq(rng, 2000), 300,
                                                       name=b"t%d_" % tid))
    return d


#: name -> argv with {i} the inputs and {o} the side's output directory
CASES = {
    "fll2simulate": ["tiers=1000,20000", "trials=3"],
    "ttllsimulate": ["tiers=500,5000", "trials=2", "buckets=1024", "seed=7"],
    "dlctieraccuracy": ["cardinalities=3000", "samples=4"],
    "trainlchist": ["tiers=2000", "trials=2", "buckets=512"],
    "mantissacompare": ["tiers=100,1000", "trials=2", "seed=3"],
    "lowcomplexcalibrate": ["tiers=40000", "trials=1", "buckets=4096"],
    "ddlwriter": ["in={i}/two.fa", "out={o}/d.tsv", "mode=pertid", "size=300", "k=21"],
    "ddlmerger": ["in={i}/ddl.tsv,{i}/ddl2.tsv", "out={o}/m.tsv", "size=400"],
    "ddlcompare": ["in={i}/ddl2.tsv", "out={o}/c.tsv"],
    "ddlblacklist": ["in={i}/ddl2.tsv", "out={o}/bl.txt", "minfraction=0.5"],
    "ddlcalibrate": ["length=20000", "size=500", "seed=5"],
    "rankingvectorizer": ["in={i}/hits.tsv", "out={o}/v.tsv"],
    "covmaker": ["in={i}/cov.tsv", "out={o}/o.tsv"],
    "makequickbinvector": ["in={i}/bins.fa", "out={o}/v.tsv", "cov={i}/bins_cov.tsv",
                           "pairs=300"],
    "matrixtocolumns": ["{i}/m1.tsv", "{i}/m2.tsv", "{o}/cols.tsv"],
    "bloomfilterparser": ["in={i}/bloom.log", "out={o}/good.txt", "outb={o}/bad.txt"],
    "processfrag": ["in={i}/f1.log,{i}/f2.log", "out={o}/frag.tsv"],
    "postfilter": ["in={i}/pf.fq", "ref={i}/asm.fa", "out={o}/filtered.fa"],
    "reassemble": ["in={i}/tid_1_a.fq,{i}/tid_2_b.fq", "out={o}/contigs.fa", "k=31"],
}
#: the rate BBMap prints, masked in both sides' standard error
MASKS = ((r"Reads/sec:\s+\S+", "Reads/sec: R"),)
DEVICE = ("fll2simulate", "ttllsimulate", "dlctieraccuracy", "trainlchist",
          "mantissacompare", "lowcomplexcalibrate", "postfilter", "reassemble")


@pytest.mark.parametrize("tool", list(CASES))
def test_research_tool_equals_jax(inputs, tmp_path, tool):
    res = run_host_both(tool, CASES[tool], inputs, tmp_path, device=tool in DEVICE,
                        masks=MASKS)
    assert res["torch"] == res["jax"]
    assert res["jax"][2] or res["jax"][0] or res["jax"][1], "no output"


def test_postfilter_and_reassemble_do_their_work(inputs, tmp_path):
    """postfilter keeps the covered 5,000 bp contigs and drops the
    uncovered and the short one; reassemble labels every contig with its
    input's tid_, and both inputs give contigs."""
    from bbtools_torch.cli import main

    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        main(["postfilter", f"in={inputs}/pf.fq", f"ref={inputs}/asm.fa",
              f"out={tmp_path}/f.fa", "device=cpu"])
        main(["reassemble", f"in={inputs}/tid_1_a.fq,{inputs}/tid_2_b.fq",
              f"out={tmp_path}/c.fa", "device=cpu"])
    names = [ln[1:].split()[0] for ln in (tmp_path / "f.fa").read_bytes().split(b"\n")
             if ln.startswith(b">")]
    assert names == [b"big1", b"big2"]
    heads = [ln for ln in (tmp_path / "c.fa").read_bytes().split(b"\n") if ln.startswith(b">")]
    assert heads and all(h.startswith((b">tid_1_", b">tid_2_")) for h in heads)
    assert {h[:6] for h in heads} == {b">tid_1", b">tid_2"}


def test_loglog_hash_kmers_equals_jax():
    """The port's LogLog fed host keys (the harness's route) holds the
    JAX package's bucket maxima and estimate."""
    from bbtools_torch.models.loglog import LogLog as TLogLog
    from bbtools_tpu.models.loglog import LogLog as JLogLog

    rng = np.random.default_rng(5)
    for buckets, n in ((256, 10), (2048, 50_000)):
        keys = rng.integers(0, 1 << 62, n, dtype=np.int64)
        t, j = TLogLog(buckets=buckets, device="cpu"), JLogLog(buckets=buckets)
        t.hash_kmers(keys)
        j.hash_kmers(keys)
        assert np.array_equal(t.maxima.numpy(), j.maxima)
        assert t.cardinality() == j.cardinality()


def _msa_cases(monkeypatch):
    """tests/test_msa.py's task sets, drawn with its make_task from its
    seed: (name, reads, read_lens, refs, ref_lens, min_score)."""
    import test_msa
    from bbtools_tpu.ops import msa_constants as C

    monkeypatch.setattr(test_msa, "rng", np.random.default_rng(31337))
    mk = test_msa.make_task
    cases = []

    def add(name, tasks, minratio):
        reads = np.stack([t[0] for t in tasks])
        rl = np.array([t[1] for t in tasks], np.int32)
        refs = np.stack([t[2] for t in tasks])
        cl = np.array([t[3] for t in tasks], np.int32)
        mx = C.POINTS_MATCH + (rl.astype(np.int64) - 1) * C.POINTS_MATCH2
        cases.append((name, reads, rl, refs, cl, (mx * minratio).astype(np.int64)))

    add("unlimited_random", [mk(R=30 + 2 * i, sub=0.02 * (i % 4), ins=0.02 * (i % 2),
                                dele=0.02 * ((i // 2) % 2)) for i in range(12)], 0.0)
    add("perfect", [mk(R=50, sub=0.0)], 0.5)
    t = list(mk(R=40, sub=0.0))
    t[0][5] = 4  # N in read
    t[2][20] = 4  # N in ref
    add("n_bases", [tuple(t)], 0.5)
    for minratio in (0.4, 0.7):
        add(f"limited_{minratio}", [mk(R=60, pad_r=64, pad_c=96, sub=0.03 * (i % 3),
                                       ins=0.01 * (i % 2)) for i in range(10)], minratio)
    add("consistency", [mk(R=70, pad_r=72, pad_c=96, sub=0.02)], 0.6)
    # a set where prune mode kills tasks: a high floor over noisy reads
    add("killed", [mk(R=60, pad_r=64, pad_c=96, sub=0.08 + 0.04 * (i % 3), ins=0.02)
                   for i in range(8)], 0.95)
    return cases


@pytest.mark.parametrize("prune", [True, False])
def test_msa_fill_batch_equals_jax(monkeypatch, prune):
    from bbtools_torch.ops.msa import msa_fill_batch as tfill
    from bbtools_tpu.ops import msa_constants as C
    from bbtools_tpu.ops.msa import msa_fill_batch as jfill

    killed = 0
    for name, reads, rl, refs, cl, mins in _msa_cases(monkeypatch):
        want = jfill(reads, rl, refs, cl, mins, prune=prune)
        got = tfill(reads, rl, refs, cl, mins, prune=prune, device="cpu")
        for w, g in zip(want, got):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        if prune:
            killed += int((got[0] < mins - C.MIN_SCORE_ADJUST).sum())
    assert killed > 0 or not prune


def test_msa_fill_batch_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bbtools_torch.ops.msa import msa_fill_batch

    z = np.zeros((1, 8), np.uint8)
    with pytest.raises(RuntimeError, match="cuda"):
        msa_fill_batch(z, np.array([8]), z, np.array([8]), np.array([0]))


#: the device launchers of A8b group 4 and the argv that reaches their
#: first device work
A8B4_DEVICE_TOOLS = {
    "postfilter": ["in={fq}", "ref={tmp}/ref.fa", "out={tmp}/o.fa"],
    "reassemble": ["in={tmp}/tid_1_x.fq", "out={tmp}/o.fa"],
    "fll2simulate": ["tiers=100", "trials=1"],
    "ttllsimulate": ["tiers=100", "trials=1"],
    "dlctieraccuracy": ["tiers=100", "trials=1"],
    "trainlchist": ["tiers=100", "trials=1"],
    "mantissacompare": ["tiers=100", "trials=1"],
    "lowcomplexcalibrate": ["tiers=100", "trials=1"],
}


@pytest.mark.parametrize("tool", list(A8B4_DEVICE_TOOLS))
def test_a8b4_device_tools_default_to_cuda(tmp_path, tool):
    """postfilter (BBMap), reassemble (Tadpole) and the cardinality
    harness (LogLog) run on the card unless asked for the CPU: without
    one, the default raises before any output is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bbtools_torch.cli import main

    fq = tmp_path / "tid_1_x.fq"
    fq.write_text("@r\n" + "ACGTTGCAAG" * 6 + "\n+\n" + "I" * 60 + "\n")
    (tmp_path / "ref.fa").write_text(">s\n" + "ACGTTGCAAGCTTCGA" * 40 + "\n")
    argv = [a.format(fq=fq, tmp=tmp_path) for a in A8B4_DEVICE_TOOLS[tool]]
    with pytest.raises(RuntimeError, match="cuda"), \
            contextlib.redirect_stdout(io.StringIO()) as out:
        main([tool, *argv])
    assert not list(tmp_path.glob("o.*")) and "cardinality" not in out.getvalue()
