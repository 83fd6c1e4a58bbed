"""A8b group 4's sequence, gene, protein and binning tools on the CPU:
each launcher name of the port against the JAX package's on the same
seeded inputs, one case a name (misctools' 10 names beside
kmercoverage, contam's 2, bbcrisprfinder, randomreads, quickbin,
gradebins, callgenes, pgmtrain's 2, prottools' 5 and scalartools' 3).
Every output file, the standard output and the standard error are equal
byte for byte. The inputs are the JAX package's own test shapes
(tests/test_longtail{3,8,9}.py, tests/test_prottools.py,
tests/test_crispr_cbcl.py, tests/test_research.py, tests/test_tools.py).
The inputs that chain one tool into the next (callgenes' GFF for
analyzegenes, its model for mergepgm, markerfactory's markers for
markervector, its vector for magqc) are made once with the JAX
package. All of these tools are host code copied from the JAX package;
callgenes names its program in the GFF's source column, which the
port's copy writes as bbtools_torch, and reads the JAX package's
bundled gene model by path."""

import contextlib
import io
import os

import numpy as np
import pytest

from torch_parity import run_host_both, warm_native_codecs  # noqa: F401  (autouse)

ACGT = np.frombuffer(b"ACGT", np.uint8)
AAS = "ARNDCQEGHILKMFPSTWYV"
PHIX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "bbtools_tpu", "resources", "phix2.fa.gz")


def _seq(rng, n):
    return ACGT[rng.integers(0, 4, n)].tobytes()


def _fq(recs):
    return b"".join(b"@%s\n%s\n+\n%s\n" % (n, s, q or b"I" * len(s)) for n, s, q in recs)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs every case reads, made once from seed 43."""
    from bbtools_tpu.cli import main as jmain
    from bbtools_tpu.models.misctools import SMRTBELL

    d = tmp_path_factory.mktemp("a8b4_seqtools_in")
    rng = np.random.default_rng(43)
    uniq = [(b"u%d" % i, _seq(rng, 60), b"") for i in range(10)]
    (d / "dups.fq").write_bytes(_fq(uniq + [(b"d%d" % i, uniq[0][1], b"") for i in range(3)]))
    (d / "ck.fq").write_bytes(_fq([(b"r", b"AAAAACAC", b""), (b"s", _seq(rng, 40), b"")]))
    ref = b"ACGTACGTTGCAACGGTCAG"
    (d / "kp.fq").write_bytes(_fq([(b"a", b"TTTTT" + ref + b"TTTTT", b""),
                                   (b"b", b"GGGGCCCCGGGGCCCCGGGGCCCCGGGGCC", b""),
                                   (b"c", ref + _seq(rng, 20), b"")]))
    (d / "kp.fa").write_bytes(b">x\n" + ref + b"\n")
    (d / "mb.fq").write_bytes(_fq([(b"r1", b"ACGTACGT", b""), (b"r2", b"TTGGACGT", b"")]))
    (d / "bar.fq").write_bytes(_fq([(b"r1", b"TTGGCC", b"IIIIII"), (b"r2", b"AACCGG", b"FFFFFF")]))
    ad = bytearray(SMRTBELL)
    ad[5] = ord("A") if ad[5] != ord("A") else ord("C")
    (d / "pb.fq").write_bytes(_fq([(b"z", _seq(rng, 200) + bytes(ad) + _seq(rng, 150), b""),
                                   (b"y", _seq(rng, 120), b"")]))
    q = bytearray(b"I" * 10)
    q[5] = 33 + 20
    (d / "subs.sam").write_bytes(b"".join([
        b"@SQ\tSN:c\tLN:100\n",
        b"s1\t0\tc\t1\t40\t5=1X4=\t*\t0\t0\t" + b"A" * 10 + b"\t" + bytes(q) + b"\n",
        b"s2\t0\tc\t1\t40\t10=\t*\t0\t0\t" + b"A" * 10 + b"\tIIIIIIIIII\n",
        b"s3\t0\tc\t1\t40\t4=1I5=\t*\t0\t0\t" + b"A" * 10 + b"\tIIII5IIIII\n"]))
    (d / "raw.fq").write_bytes(_fq([(b"r0", b"ACGTACGTAC", b""), (b"r1", b"TTTTTTTTTT", b"")]))
    (d / "c1.fq").write_bytes(_fq([(b"r0", b"ACGAACGTAC", b""), (b"r1", b"TTTTTTTTTT", b"")]))
    (d / "c2.fq").write_bytes(_fq([(b"r0", b"ACGAACGTAC", b""), (b"r1", b"TTTTCTTTTT", b"")]))
    (d / "otu.txt").write_bytes(
        b"#ID\tAvg_fold\tLength\tRef_GC\tCovered_percent\tCovered_bases\tPlus_reads\t"
        b"Minus_reads\n"
        b"c1 otuA\t10.0\t100\t0.5\t90.0\t90\t5\t5\n"
        b"c2 otuA\t20.0\t300\t0.5\t50.0\t150\t15\t15\n"
        b"c3 otuB\t5.0\t200\t0.4\t100.0\t200\t4\t6\n")
    (d / "ctgs.fa").write_bytes(b"".join(b">c%d\n%s\n" % (i, _seq(rng, n))
                                         for i, n in enumerate((500, 800, 40, 1200, 700))))
    for nm in (b"x", b"y"):
        (d / ("%s.fq" % nm.decode())).write_bytes(
            _fq([(b"%s%d" % (nm, i), _seq(rng, 10), b"FFFFFFFFFF") for i in range(200)]))
    (d / "h.fa").write_bytes(b">h\n" + b"ACGT" * 2500 + b"\n")
    (d / "c.fa").write_bytes(b">c\n" + b"TTGG" * 2500 + b"\n")
    # bbcrisprfinder: a read with a planted array (repeat 30, spacers 30,
    # 4 copies) and one without
    rep = _seq(rng, 30)
    arr = rep + b"".join(_seq(rng, 30) + rep for _ in range(3))
    (d / "crispr.fq").write_bytes(_fq([(b"hit", arr, b""), (b"miss", _seq(rng, len(arr)), b"")]))
    # quickbin: two organisms of distinct composition, 3 contigs each
    recs, cov = [], [b"#ID\tAvg_fold\n"]
    for j in range(3):
        for src, p, depth in ((b"A", [0.32, 0.18, 0.18, 0.32], 30.0),
                              (b"B", [0.18, 0.32, 0.32, 0.18], 8.0)):
            nm = b"%s_ctg%d" % (src, j)
            recs.append(b">%s\n%s\n" % (nm, ACGT[rng.choice(4, 6000, p=p)].tobytes()))
            cov.append(b"%s\t%.1f\n" % (nm, depth))
    (d / "qb.fa").write_bytes(b"".join(recs))
    (d / "qb_cov.txt").write_bytes(b"".join(cov))
    # gradebins
    a, b, c = _seq(rng, 1000), _seq(rng, 500), _seq(rng, 1500)
    (d / "gb_ref.fa").write_bytes(b">c1 tid_7\n" + a + b"\n>c2 tid_7\n" + b + b"\n>c3 tid_9\n"
                                  + c + b"\n")
    (d / "bin1.fa").write_bytes(b">c1 tid_7\n" + a + b"\n>c3 tid_9\n" + c + b"\n")
    (d / "bin2.fa").write_bytes(b">c2 tid_7\n" + b + b"\n")
    # proteins: a query, a database, three genomes sharing three markers
    seq = "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRVGDGTQDNLSGAEKAVQ"
    (d / "q.faa").write_text(f">q0\n{seq}\n>q1\n{seq[5:40]}\n")
    (d / "db.faa").write_text(f">t0\n{seq}\n>t1\n{seq[::-1]}\n>t2\n{seq[:30]}WWWW{seq[30:]}\n")

    def rand_prot(n):
        return "".join(AAS[i] for i in rng.integers(0, 20, n))

    def mutate(s, n=3):
        s = list(s)
        for p in rng.integers(0, len(s), n):
            s[p] = AAS[int(rng.integers(0, 20))]
        return "".join(s)

    markers = [rand_prot(60) for _ in range(3)]
    for g in range(3):
        with open(d / f"g{g}.faa", "w") as f:
            for mi, m in enumerate(markers):
                f.write(f">m{mi}_g{g}\n{mutate(m)}\n")
            f.write(f">extra_g{g}\n{rand_prot(50)}\n")
    (d / "all.faa").write_text("".join((d / f"g{g}.faa").read_text() for g in range(3)))
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        jmain(["markerfactory", f"in={d}/g0.faa,{d}/g1.faa,{d}/g2.faa",
               f"out={d}/markers.tsv", "minid=80"])
        jmain(["markervector", f"in={d}/g0.faa", f"markers={d}/markers.tsv",
               f"out={d}/vec.tsv", "minid=80"])
        jmain(["callgenes", f"in={PHIX}", f"outgff={d}/phix.gff"])
        jmain(["analyzegenes", f"in={PHIX}", f"gff={d}/phix.gff", f"out={d}/trained.pgm"])
    (d / "scal.fa").write_bytes(b">s1\n" + _seq(rng, 3000) + b"\n>s2\n" + b"AT" * 900 + b"\n")
    return d


#: name -> argv with {i} the inputs and {o} the side's output directory
CASES = {
    "countduplicates": ["in={i}/dups.fq", "out={o}/o.fq", "outd={o}/d.txt"],
    "commonkmers": ["in={i}/ck.fq", "out={o}/o.txt", "k=2", "display=2"],
    "kmerposition": ["in={i}/kp.fq", "ref={i}/kp.fa", "out={o}/o.txt", "k=20"],
    "mergebarcodes": ["in={i}/mb.fq", "barcode={i}/bar.fq", "out={o}/o.fq"],
    "removesmartbell": ["in={i}/pb.fq", "out={o}/o.fq", "split=t"],
    "filtersubs": ["in={i}/subs.sam", "out={o}/o.sam", "minq=15", "maxq=25",
                   "countindels=t"],
    "consect": ["in={i}/raw.fq,{i}/c1.fq,{i}/c2.fq", "out={o}/out.fq"],
    "mergeotus": ["in={i}/otu.txt", "out={o}/m.txt"],
    "mergefastacontigs": ["in={i}/ctgs.fa", "out={o}/m.fa", "info={o}/m.info", "npad=100",
                          "minlen=100", "maxlen=2000"],
    "partitionfastafile": ["in={i}/ctgs.fa", "out={o}/p_%.fa", "ways=2"],
    "crosscontaminate": ["in={i}/x.fq,{i}/y.fq", "out={o}/x2.fq,{o}/y2.fq", "rate=0.05",
                         "seed=7"],
    "makecontaminatedgenomes": ["ref={i}/h.fa", "contam={i}/c.fa", "out={o}/m.fa",
                                "fraction=0.1", "fragsize=500"],
    "bbcrisprfinder": ["in={i}/crispr.fq", "outc={o}/c.tsv", "consensus={o}/cons.fa",
                       "out={o}/h.fq", "outu={o}/u.fq"],
    "randomreads": ["ref={i}/ctgs.fa", "out={o}/r1.fq", "out2={o}/r2.fq", "reads=50",
                    "length=100", "snprate=0.01", "mininsert=150", "maxinsert=300", "seed=3"],
    "quickbin": ["in={i}/qb.fa", "cov={i}/qb_cov.txt", "out={o}/bin_%.fa"],
    "gradebins": ["{i}/bin1.fa", "{i}/bin2.fa", "ref={i}/gb_ref.fa", "report={o}/rep.txt"],
    "callgenes": ["in=" + PHIX, "outgff={o}/p.gff", "outa={o}/p.faa"],
    "analyzegenes": ["in=" + PHIX, "gff={i}/phix.gff", "out={o}/trained.pgm"],
    "mergepgm": ["in={i}/trained.pgm,{i}/trained.pgm", "out={o}/m.pgm"],
    "proteinsearch": ["query={i}/q.faa", "db={i}/db.faa", "out={o}/hits.tsv", "evalue=1e-5"],
    "clusterproteins": ["in={i}/all.faa", "out={o}/clusters.tsv", "minid=60"],
    "markerfactory": ["in={i}/g0.faa,{i}/g1.faa,{i}/g2.faa", "out={o}/markers.tsv",
                      "minid=80"],
    "markervector": ["in={i}/g1.faa", "markers={i}/markers.tsv", "out={o}/vec.tsv",
                     "minid=80"],
    "magqc": ["in={i}/vec.tsv", "out={o}/qc.tsv"],
    "scalars": ["in={i}/scal.fa", "out={o}/sc.tsv", "perseq=t"],
    "scalarintervals": ["in={i}/scal.fa", "out={o}/si.tsv", "interval=1000"],
    "cloudplot": ["in={i}/scal.fa", "out={o}/cloud.tsv", "window=500", "bins=10"],
}


def _rename_program(res):
    """The JAX side's files with the program's name as the port writes
    it (callgenes' source column)."""
    out, err, files = res["jax"]
    return (out, err, {k: v.replace(b"bbtools_tpu", b"bbtools_torch") if isinstance(v, bytes)
                       else v for k, v in files.items()})


@pytest.mark.parametrize("tool", list(CASES))
def test_seq_tool_equals_jax(inputs, tmp_path, tool):
    res = run_host_both(tool, CASES[tool], inputs, tmp_path)
    assert res["torch"] == _rename_program(res)
    assert res["jax"][2] or res["jax"][0] or res["jax"][1], "no output"


def test_callgenes_reads_the_bundled_model_by_path():
    """The port's gene model is the JAX package's model.pgm, parsed the
    same, and the port ships no copy of it."""
    from bbtools_torch.models import pgm as tpgm
    from bbtools_tpu.models import pgm as jpgm

    t, j = tpgm.parse_pgm(), jpgm.parse_pgm()
    assert sorted(t.stats) == sorted(j.stats) and len(t.stats) >= 3
    for name in j.stats:
        assert np.array_equal(t[name].probs, j[name].probs)
    assert not os.path.exists(os.path.join(os.path.dirname(tpgm.__file__), "..", "resources"))
