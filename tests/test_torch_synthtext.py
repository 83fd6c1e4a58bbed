"""The synthesis, k-mer and text tools of A8b on the CPU: each launcher
name of the port against the JAX package's on the same seeded inputs,
one case a name (the 16 synthtools names, kmerlimit and kmerlimit2
among them, and the 28 texttools names beside bloomfilter). Every
output file, the standard output and the standard error are equal byte
for byte; a .gz output (bamlinestreamer's) is compared decompressed,
as its header carries the time of writing.

kmerlimit/kmerlimit2 and kmercountmulti track their cardinality with the
port's LogLog on the run's device: the port's runs take device=cpu (the
JAX package builds the k-mers with XLA on the CPU). translate6frames
reads the port's copy of callgenes.translate. The rest is host code
copied from the JAX package."""

import numpy as np
import pytest

from torch_parity import run_host_both, warm_native_codecs  # noqa: F401  (autouse)

ACGT = np.frombuffer(b"ACGT", np.uint8)
#: tools that do device work (the port's run takes device=cpu)
DEVICE = ("kmerlimit", "kmerlimit2", "kmercountmulti")


def _seq(rng, n):
    return ACGT[rng.integers(0, 4, n)].tobytes()


def _fq(name, seq, q=None):
    return b"@%s\n%s\n+\n%s\n" % (name, seq, q or b"F" * len(seq))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs every case reads, made once from seed 31."""
    d = tmp_path_factory.mktemp("synthtext_in")
    rng = np.random.default_rng(31)
    rep = _seq(rng, 300)
    c1 = _seq(rng, 2000) + rep + _seq(rng, 1500) + rep + _seq(rng, 1000)
    c2 = _seq(rng, 2500) + rep + _seq(rng, 500)
    (d / "genome.fa").write_bytes(b">chr1 first\n%s\n>chr2\n%s\n" % (c1, c2))
    (d / "contigs.fa").write_bytes(b"".join(b">ctg%d\n%s\n" % (i, _seq(rng, int(rng.integers(300, 900))))
                                            for i in range(6)))
    (d / "small.fa").write_bytes(b">s1\n%s\n>s2\n%s\n" % (_seq(rng, 120), _seq(rng, 90)))
    reads = []
    for i in range(320):
        src = c1 if i % 4 else c2
        p = int(rng.integers(0, len(src) - 150))
        s = src[p:p + 150]
        if i % 2:
            s = s[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
        if i % 17 == 0:
            s = s[:70] + b"N" + s[71:]
        reads.append(_fq(b"r%d insert=%d" % (i, 150 - i % 3), s,
                         bytes(33 + rng.integers(2, 40, 150).astype(np.uint8))))
    (d / "reads.fq").write_bytes(b"".join(reads))
    (d / "reads_crlf.fq").write_bytes(b"".join(reads[:5]).replace(b"\n", b"\r\n")
                                      + b"@broken\nACGT\n")
    import gzip

    with gzip.open(d / "reads.fq.gz", "wb") as fh:
        fh.write(b"".join(reads[:40]))
    core = _seq(rng, 31)
    (d / "kfs.fa").write_bytes(b"".join(b">k%d\n%s\n" % (i, _seq(rng, 20) + core + _seq(rng, 20))
                                        for i in range(8)))
    (d / "tid_77_a.fa").write_bytes(b">a1\n" + _seq(rng, 3000) + b"\n")
    (d / "b.fa").write_bytes(b">b1\n" + _seq(rng, 1500) + b"\n>b2\n" + _seq(rng, 1500) + b"\n")
    # text inputs
    (d / "lines.txt").write_bytes(b"alpha one\nBeta two\ngamma\ndelta four\nalphabet\n\nomega\n")
    (d / "names.txt").write_bytes(b"alpha\ngamma\n")
    (d / "set2.txt").write_bytes(b"gamma\nBeta two\nzeta\n")
    (d / "unicode.txt").write_bytes("naïve café — “quotes” ½ \x07bell\tend\nÅngström\n".encode())
    (d / "aln.phy").write_bytes(b"3 12\nseqA  ACGTAC\nseqB  ACGTTC\nseqC  AGGTAC\n\n"
                                b"GTACGT\nGTACGA\nGTTCGT\n")
    for n, rows in (("sampleA", [(b"sampleA_ref", 900), (b"other", 80), (b"*unmatched*", 20)]),
                    ("sampleB", [(b"x", 300), (b"y", 500)])):
        (d / f"{n}.seal.txt").write_bytes(b"#Name\tReads\tReadsPct\n" + b"".join(
            b"%s\t%d\t1.0\n" % r for r in rows))
    (d / "ani.tsv").write_bytes(b"#q\tr\tani\n" + b"".join(
        b"f%d\tf%d\t%.2f\n" % (a, b, 80 + (a * 7 + b * 3) % 19)
        for a in range(5) for b in range(5)))
    for n in ("c1", "c2"):
        (d / f"{n}.basecov.txt").write_bytes(b"#RefName\tPos\tCoverage\n" + b"".join(
            b"chr1\t%d\t%d\n" % (p, int(rng.integers(0, 30))) for p in range(200)))
        (d / f"{n}.scafstats.txt").write_bytes(
            b"#name\t%unambiguousReads\tunambiguousMB\t%ambiguousReads\tambiguousMB\t"
            b"unambiguousReads\tambiguousReads\n" + b"".join(
                b"s%d\t1.0\t0.1\t0.1\t0.0\t%d\t%d\n" % (k, int(rng.integers(0, 500)),
                                                         int(rng.integers(0, 50)))
                for k in range(4)))
    (d / "grade1.txt").write_bytes(b"Correct:   \t90\nIncorrect:\t10\nToo Short: \t4\n"
                                   b"Too Long:  \t6\nSNR:       \t9.54 dB\n")
    (d / "grade2.txt").write_bytes(b"Correct:   \t95.5%\nSNR:       \t13.2 dB\n")
    (d / "q1.tsv").write_bytes(b"Assembly\tasm1\n# contigs\t12\nN50\t4400\n")
    (d / "q2.tsv").write_bytes(b"Assembly\tasm2\nN50\t5100\nGC (%)\t50.1\n")
    (d / "key.tsv").write_bytes(b"#k\tv\na\t1\nb\t2\tx\nsingle\n")
    from bbtools_tpu.cli import main as jmain
    from bbtools_tpu.io.bam import BamWriter
    from bbtools_tpu.io.sam_read import SamRecord
    import contextlib
    import io

    w = BamWriter(str(d / "t.bam"), b"@HD\tVN:1.4\n", [(b"c1", 1000), (b"c2", 500)])
    for i in range(30):
        s = _seq(rng, 20)
        w.write_record(SamRecord(qname=b"r%d" % i, flag=16 * (i % 2), rname=b"c%d" % (1 + i % 2),
                                 pos=10 + 7 * i, mapq=30 + i % 5, cigar="20M", seq=s,
                                 qual=b"I" * 20))
    w.close()
    with contextlib.redirect_stderr(io.StringIO()):
        jmain(["icecreammaker", f"out={d}/pb.fq", "zmws=20", "minlen=300", "maxlen=600",
               "minmovie=2000", "maxmovie=4000", "missingrate=0.5", "miner=0.01",
               "maxer=0.03", "seed=33", "genomesize=20000"])
    return d


#: name -> argv with {i} the inputs and {o} the side's output directory
CASES = {
    "mutate": ["in={i}/genome.fa", "out={o}/mut.fa", "vcf={o}/mut.vcf", "subrate=0.01",
               "indelrate=0.004", "maxindel=3", "seed=5"],
    "mutategenome": ["in={i}/contigs.fa", "out={o}/mut.fa", "vcf={o}/mut.vcf",
                     "subrate=0.02", "seed=9"],
    "bbfakereads": ["in={i}/contigs.fa", "out={o}/r1.fq", "out2={o}/r2.fq", "length=100"],
    "fakereads": ["in={i}/contigs.fa", "out={o}/r.fq", "length=250", "minlength=50",
                  "identifier=fake", "q=30"],
    "kcompress": ["in={i}/reads.fq", "out={o}/kc.fa", "k=21", "min=2"],
    "kmerlimit": ["in={i}/reads.fq", "out={o}/lim.fq", "limit=7000", "batchreads=64"],
    "kmerlimit2": ["in={i}/reads.fq", "out={o}/lim.fq", "limit=6000", "k=21",
                   "batchreads=32"],
    "findrepeats": ["in={i}/genome.fa", "out={o}/rep.tsv", "outs={o}/rep.fa", "k=21",
                    "gap=5"],
    "addadapters": ["in={i}/reads.fq", "out={o}/ad.fq", "literal=AGATCGGAAGAGCACACG,CTGTCTCTTATA",
                    "rate=0.5", "seed=3"],
    "makechimeras": ["in={i}/contigs.fa", "out={o}/chim.fa", "chimeras=7", "seed=2"],
    "checkstrand": ["in={i}/reads.fq", "ref={i}/genome.fa", "k=21"],
    "kmutate": ["in={i}/small.fa", "out={o}/km.fa", "k=15", "hdist=1"],
    "randomreadsmg": ["{i}/tid_77_a.fa", "{i}/b.fa", "out={o}/mg.fq", "depth=5", "paired=t",
                      "seed=5"],
    "kmerfilterset": ["in={i}/kfs.fa", "out={o}/set.fa", "k=21", "maxkpp=1"],
    "icecreammaker": ["out={o}/pb.fq", "zmws=12", "minlen=300", "maxlen=500",
                      "minmovie=1500", "maxmovie=3000", "missingrate=0.3", "miner=0.01",
                      "maxer=0.02", "seed=12", "genomesize=20000"],
    "icecreamgrader": ["in={i}/pb.fq"],
    "readlength": ["in={i}/reads.fq", "out={o}/lh.txt", "bin=7"],
    "countgc": ["in={i}/contigs.fa", "out={o}/gc.txt"],
    "testformat": ["{i}/reads.fq", "{i}/contigs.fa", "{i}/reads.fq.gz"],
    "testformat2": ["in={i}/reads.fq.gz"],
    "translate6frames": ["in={i}/small.fa", "out={o}/aa.fa"],
    "statswrapper": ["in={i}/genome.fa,{i}/contigs.fa"],
    "sketchblacklist": ["in={i}/genome.fa,{i}/contigs.fa,{i}/genome.fa", "out={o}/bl.sketch",
                        "k=21", "size=500"],
    "sketchblacklist2": ["in={i}/genome.fa,{i}/genome.fa", "out={o}/bl.sketch", "perseq=f",
                         "size=300"],
    "rename": ["in={i}/reads.fq", "out={o}/rn.fq", "prefix=sample"],
    "bbrename": ["in={i}/reads.fq", "out={o}/rn.fq", "prefix=lib1", "addprefix=t"],
    "kmercountmulti": ["in={i}/reads.fq", "out={o}/kcm.txt", "sweep=15,27,4"],
    "filterlines": ["in={i}/lines.txt", "out={o}/fl.txt", "names={i}/names.txt,delta",
                    "include=t", "prefix=t"],
    "countsharedlines": ["in={i}/lines.txt,{i}/names.txt", "in2={i}/set2.txt",
                         "out={o}/shared.txt", "case=f"],
    "unicode2ascii": ["in={i}/unicode.txt", "out={o}/a.txt"],
    "phylip2fasta": ["in={i}/aln.phy", "out={o}/aln.fa"],
    "summarizeseal": ["in={i}/sampleA.seal.txt,{i}/sampleB.seal.txt", "out={o}/ss.tsv"],
    "picksubset": ["in={i}/ani.tsv", "out={o}/keep.txt", "invalid={o}/drop.txt", "files=3"],
    "summarizecoverage": ["{i}/c1.basecov.txt", "{i}/c2.basecov.txt", "out={o}/cov.tsv"],
    "summarizescafstats": ["in={i}/c1.scafstats.txt,{i}/c2.scafstats.txt"],
    "fastqscan": ["{i}/reads.fq"],
    "loadreads": ["in={i}/reads_crlf.fq"],
    "plotgc": ["in={i}/genome.fa", "out={o}/gc.tsv", "interval=500", "psb=f"],
    "summarizemerge": ["in={i}/grade1.txt,{i}/grade2.txt", "out={o}/sm.tsv"],
    "summarizequast": ["{i}/q1.tsv", "{i}/q2.tsv", "out={o}/quast.tsv"],
    "invertkey": ["in={i}/key.tsv", "out={o}/inv.tsv"],
    "bam2sam": ["in={i}/t.bam", "out={o}/t.sam"],
    "bamlinestreamer": ["in={i}/t.bam", "out={o}/t.sam.gz"],
    "streamsam": ["in={i}/t.bam", "out={o}/t.sam"],
}


@pytest.mark.parametrize("tool", list(CASES))
def test_host_tool_equals_jax(inputs, tmp_path, tool):
    res = run_host_both(tool, CASES[tool], inputs, tmp_path, device=tool in DEVICE)
    assert res["torch"] == res["jax"]
    assert res["jax"][2] or res["jax"][0] or res["jax"][1], "no output"


def test_kmerlimit_stops_at_its_limit(inputs, tmp_path):
    """kmerlimit passes whole batches until the port's LogLog counts the
    limit: fewer reads than the input at a low limit, all of them at a
    high one, equal to the JAX package's in both."""
    n_in = (inputs / "reads.fq").read_bytes().count(b"\n") // 4
    for limit, stops in ((1500, True), (10 ** 9, False)):
        sub = tmp_path / str(limit)
        sub.mkdir()
        res = run_host_both("kmerlimit", ["in={i}/reads.fq", "out={o}/l.fq", f"limit={limit}",
                                          "batchreads=64"], inputs, sub, device=True)
        assert res["torch"] == res["jax"]
        n_out = res["torch"][2]["l.fq"].count(b"\n") // 4
        assert (n_out < n_in) == stops and (n_out % 64 == 0 or n_out == n_in)
