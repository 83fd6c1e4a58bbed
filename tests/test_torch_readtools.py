"""The read-handling host tools of A8b's read-QC slice on the CPU: each
launcher name of the port against the JAX package's on the same seeded
inputs, one case a name. The tools are host code copied from the JAX
package (filterbytile, demux, seqtools, novademux, filtertools,
splitpairs, sortbyname, bbmask, smalltools, barcodetools, hiseqtools,
illuminatools, splitnextera): every output file, the standard output and
the standard error (its seconds masked) are equal byte for byte. They
need no device=. summarizecrossblock's case is in
tests/test_torch_decontaminate.py."""

import contextlib
import gzip
import io
import os
import re
import struct

import numpy as np
import pytest

from bbtools_torch.cli import main as tmain
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.models.illuminatools import write_cbcl
from torch_parity import warm_native_codecs  # noqa: F401  (autouse: the codecs built first)

ACGT = np.frombuffer(b"ACGT", np.uint8)
EXPECTED = (b"ACGTACGT", b"TTTTCCCC", b"GGGGAAAA")
JUNCTION = b"CTGTCTCTTATACACATCTAGATGTGTATAAGAGACAG"


def _seq(rng, n):
    return ACGT[rng.integers(0, 4, n)].tobytes()


def _fq(name, seq, q=None):
    return b"@%s\n%s\n+\n%s\n" % (name, seq, q or b"F" * len(seq))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs every case reads, made once from seed 7."""
    d = tmp_path_factory.mktemp("readtools_in")
    rng = np.random.default_rng(7)
    # a tiled flowcell: a corner of tile 1103 of poor quality, barcodes
    # with errors, every 25th read with a poly-G tail, the last 30 with
    # random barcodes
    fc = []
    for i in range(630):
        tile = 1101 + i % 4
        bc = bytearray(EXPECTED[i % 3])
        if i % 6 == 0:
            bc[int(rng.integers(0, 8))] = b"ACGT"[int(rng.integers(0, 4))]
        if i % 50 == 0:
            bc[0] = ord("N")
        if i >= 600:
            bc = bytearray(_seq(rng, 8))
        s = _seq(rng, 100)
        if i % 25 == 0:
            s = s[:60] + b"G" * 40
        x, y = int(rng.integers(0, 3000)), int(rng.integers(0, 3000))
        q = (b"+" if tile == 1103 and x < 1000 and y < 1000 else b"F") * 100
        h = b"M0:7:FC1:1:%d:%d:%d 1:N:0:%s" % (tile, x, y, bytes(bc))
        fc.append(_fq(h, s, q))
    (d / "fc.fq").write_bytes(b"".join(fc))
    # pairs: mate files, interleaved, and a broken interleaved file
    r1, r2, inter = [], [], []
    for i in range(120):
        a, b = _fq(b"p%d/1" % i, _seq(rng, 80)), _fq(b"p%d/2" % i, _seq(rng, 80))
        r1.append(a)
        r2.append(b)
        inter += [a, b]
    (d / "r1.fq").write_bytes(b"".join(r1))
    (d / "r2.fq").write_bytes(b"".join(r2))
    (d / "inter.fq").write_bytes(b"".join(inter))
    order = rng.permutation(len(inter))
    (d / "broken.fq").write_bytes(b"".join(inter[j] for j in order if j % 37))
    # named reads, unsorted, some sharing a name prefix
    named = [_fq(b"read%03d extra" % int(j), _seq(rng, int(rng.integers(40, 120))))
             for j in rng.permutation(200)]
    (d / "named.fq").write_bytes(b"".join(named))
    half = sorted(named, key=lambda r: r.split(b"\n")[0])
    (d / "sorted_a.fq").write_bytes(b"".join(half[0::2]))
    (d / "sorted_b.fq").write_bytes(b"".join(half[1::2]))
    (d / "names.txt").write_bytes(b"read005\nread017\nread150 extra\n")
    (d / "seqs.fa").write_bytes(b"".join(b">s%d\n%s\n" % (j, r.split(b"\n")[1])
                                         for j, r in enumerate(named[::40])))
    # contigs with low-complexity runs; a longer genome
    contigs = []
    for i in range(6):
        s = _seq(rng, int(rng.integers(1_000, 3_000)))
        if i % 2:
            s = s[:300] + b"AT" * 60 + b"A" * 50 + s[470:]
        contigs.append(b">contig%d len=%d\n%s\n" % (i, len(s), s))
    (d / "contigs.fa").write_bytes(b"".join(contigs))
    (d / "genome.fa").write_bytes(b">chr1\n%s\n>chr2\n%s\n" % (_seq(rng, 9_000),
                                                             _seq(rng, 5_000)))
    # coverage of the contigs (pileup covstats) and its ranges
    rows = [b"#ID\tAvg_fold\tLength\tRef_GC\tCovered_percent\tCovered_bases\tPlus_reads"
            b"\tMinus_reads\tRead_GC\tMedian_fold\tStd_Dev"]
    rng_rows = []
    for i in range(6):
        fold = [40.0, 2.0, 12.0, 0.5, 25.0, 6.0][i]
        rows.append(b"contig%d\t%.4f\t2000\t0.5\t%.4f\t1900\t%d\t%d\t0.5\t%d\t1.0"
                    % (i, fold, min(100.0, 20 * fold), int(fold * 10), int(fold * 10),
                       int(fold)))
        rng_rows.append(b"#contig%d\n50-%d\t%.1f\n%d-%d\t%.1f\n"
                        % (i, 700 + 100 * i, fold, 900 + 100 * i, 1800, fold / 2))
    (d / "cov1.txt").write_bytes(b"\n".join(rows) + b"\n")
    rows0 = [rows[0]] + [re.sub(rb"^(contig\d+)\t[0-9.]+", rb"\1\t30.0000", r)
                         for r in rows[1:]]
    (d / "cov0.txt").write_bytes(b"\n".join(rows0) + b"\n")
    (d / "ranges.txt").write_bytes(b"".join(rng_rows))
    # a k-mer histogram with two peaks
    x = np.arange(1, 200)
    y = (3000 * np.exp(-0.5 * ((x - 40) / 6) ** 2) + 1500 * np.exp(-0.5 * ((x - 80) / 8) ** 2)
         + 5000 * np.exp(-x / 2.0)).astype(int)
    (d / "khist.txt").write_bytes(b"#Depth\tCount\n" + b"".join(
        b"%d\t%d\n" % (a, b) for a, b in zip(x, y)))
    (d / "headers.txt").write_bytes(b"".join(b"newname%d\n" % i for i in range(200)))
    # SAM with substitutions against a VCF; primer sites on reads
    ref = _seq(rng, 300)
    sam = [b"@SQ\tSN:chr1\tLN:300"]
    for i in range(40):
        p = int(rng.integers(0, 200))
        s = bytearray(ref[p: p + 60])
        if i % 3 == 0:
            s[20] = ord(b"A" if s[20] != ord("A") else b"C")
        sam.append(b"r%d\t0\tchr1\t%d\t60\t60M\t*\t0\t0\t%s\t%s"
                   % (i, p + 1, bytes(s), b"I" * 60))
    (d / "in.sam").write_bytes(b"\n".join(sam) + b"\n")
    vcf = [b"##fileformat=VCFv4.2", b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    for i in range(0, 200, 7):
        vcf.append(b"chr1\t%d\t.\t%s\tA\t50\tPASS\tAD=1;AF=0.004" % (i + 21, ref[i + 20:i + 21]))
    (d / "v.vcf").write_bytes(b"\n".join(vcf) + b"\n")
    prim = [_fq(b"q%d" % i, _seq(rng, 90)) for i in range(20)]
    (d / "prim.fq").write_bytes(b"".join(prim))
    s1 = [b"@SQ\tSN:q%d\tLN:90" % i for i in range(20)]
    s2 = list(s1)
    for i in range(20):
        s1.append(b"p1\t%d\tq%d\t%d\t60\t12M\t*\t0\t0\tAAAAAAAAAAAA\tIIIIIIIIIIII"
                  % (16 * (i % 2), i, 5 + i % 7))
        s2.append(b"p2\t0\tq%d\t%d\t60\t12M\t*\t0\t0\tCCCCCCCCCCCC\tIIIIIIIIIIII" % (i, 60 + i % 9))
    (d / "s1.sam").write_bytes(b"\n".join(s1) + b"\n")
    (d / "s2.sam").write_bytes(b"\n".join(s2) + b"\n")
    # Nextera LMP pairs, the junction in some mates
    l1, l2 = [], []
    for i in range(80):
        a, b = bytearray(_seq(rng, 120)), bytearray(_seq(rng, 120))
        if i % 3 == 0:
            p = int(rng.integers(10, 80))
            a[p: p + len(JUNCTION)] = JUNCTION
        if i % 4 == 1:
            b[50: 50 + len(JUNCTION)] = JUNCTION
        l1.append(_fq(b"lmp%d 1:N:0:" % i, bytes(a)[:120]))
        l2.append(_fq(b"lmp%d 2:N:0:" % i, bytes(b)[:120]))
    (d / "lmp1.fq").write_bytes(b"".join(l1))
    (d / "lmp2.fq").write_bytes(b"".join(l2))
    # labels of two demultiplexers; barcode qualities in names
    lab = []
    for i in range(150):
        l_a = EXPECTED[i % 3] if i % 10 else b"unknown"
        l_b = l_a if i % 7 else EXPECTED[(i + 1) % 3]
        lab.append(_fq(b"m%d\t%s\t%s" % (i, l_a, l_b), _seq(rng, 30)))
    (d / "labels.fq").write_bytes(b"".join(lab))
    bq = [_fq(b"b%d_%s_%s" % (i, EXPECTED[i % 3],
                               bytes(33 + rng.integers(2, 40, 8).astype(np.uint8))), _seq(rng, 30))
          for i in range(150)]
    (d / "bq.fq").write_bytes(b"".join(bq))
    # BGI headers
    (d / "bgi.fq").write_bytes(b"".join(
        _fq(b"E200008112L1C%03dR%03d%07d/1" % (i % 9 + 1, i % 5, 60000 + i), _seq(rng, 50))
        for i in range(40)))
    # a metric table for plothist
    (d / "m.tsv").write_bytes(b"#a\tb\n" + b"".join(
        b"%d\t%.3f\n" % (i, float(rng.normal(10, 3))) for i in range(300)))
    # a run folder of CBCL files: 2 tiles x 12 cycles, filter and locs
    bc = d / "run" / "Data" / "Intensities" / "BaseCalls" / "L001"
    n = 30
    for cyc in range(1, 13):
        cdir = bc / f"C{cyc}.1"
        cdir.mkdir(parents=True)
        write_cbcl(str(cdir / "L001_1.cbcl"), 1101, _seq(rng, n),
                   rng.integers(0, 4, n))
    with open(bc / "s_1_1101.filter", "wb") as fh:
        fh.write(struct.pack("<iii", 0, 3, n) + bytes((rng.random(n) < 0.9).astype(np.uint8)))
    with open(d / "run" / "Data" / "Intensities" / "s.locs", "wb") as fh:
        fh.write(struct.pack("<iii", 1, 0, n)
                 + rng.uniform(0, 2000, 2 * n).astype("<f4").tobytes())
    with gzip.open(d / "fc.fq.gz", "wb") as fh:
        fh.write((d / "fc.fq").read_bytes())
    return d


#: name -> (argv with {i} the inputs and {o} the side's output directory,
#: the output files)
CASES = {
    "filterbytile": (["in={i}/fc.fq", "out={o}/k.fq", "outb={o}/b.fq"], ["k.fq", "b.fq"]),
    "analyzeflowcell": (["in={i}/fc.fq.gz", "out={o}/k.fq.gz", "qd=1.5"], ["k.fq.gz"]),
    "demux": (["in={i}/fc.fq", "out={o}/d_%.fq", "outu={o}/u.fq", "barcode=t",
               "names=ACGTACGT,TTTTCCCC,GGGGAAAA", "hdist=1"],
              ["d_ACGTACGT.fq", "d_TTTTCCCC.fq", "d_GGGGAAAA.fq", "u.fq"]),
    "demuxbyname": (["in={i}/named.fq", "out={o}/n_%.fq", "outu={o}/u.fq",
                     "names=read00,read01,read1", "prefixmode=t"],
                    ["n_read00.fq", "n_read01.fq", "n_read1.fq", "u.fq"]),
    "filterbycoverage": (["in={i}/contigs.fa", "cov1={i}/cov1.txt", "cov0={i}/cov0.txt",
                          "out={o}/c.fa", "outd={o}/d.fa", "minc=5", "minratio=1.5",
                          "log={o}/log.txt"], ["c.fa", "d.fa", "log.txt"]),
    "trimcontigs": (["in={i}/contigs.fa", "ranges={i}/ranges.txt", "out={o}/t.fa",
                     "outd={o}/d.fa", "mincov=3", "minlen=100"], ["t.fa", "d.fa"]),
    "shuffle": (["in={i}/named.fq", "out={o}/s.fq", "seed=3"], ["s.fq"]),
    "shuffle2": (["in={i}/r1.fq", "in2={i}/r2.fq", "out={o}/s1.fq", "out2={o}/s2.fq",
                  "seed=5"], ["s1.fq", "s2.fq"]),
    "getreads": (["in={i}/named.fq", "out={o}/g.fq", "id=3,7-12,150"], ["g.fq"]),
    "replaceheaders": (["in={i}/named.fq", "hin={i}/headers.txt", "out={o}/h.fq",
                        "prefix=t"], ["h.fq"]),
    "randomgenome": (["len=20k", "chroms=3", "gc=0.4", "seed=9", "out={o}/g.fa"], ["g.fa"]),
    "makepolymers": (["k=2", "maxk=3", "minlen=20", "out={o}/p.fa"], ["p.fa"]),
    "tetramerfreq": (["in={i}/genome.fa", "out={o}/t.tsv", "window=2000", "step=1000"],
                     ["t.tsv"]),
    "callpeaks": (["in={i}/khist.txt", "out={o}/p.txt"], ["p.txt"]),
    "novademux": (["in={i}/fc.fq", "out={o}/nd_%.fq", "outu={o}/u.fq",
                   "expected=ACGTACGT,TTTTCCCC,GGGGAAAA", "stats={o}/s.txt"],
                  ["nd_ACGTACGT.fq", "nd_TTTTCCCC.fq", "nd_GGGGAAAA.fq", "u.fq", "s.txt"]),
    "filterbyname": (["in={i}/named.fq", "out={o}/f.fq", "names={i}/names.txt",
                      "substring=t"], ["f.fq"]),
    "filterbysequence": (["in={i}/named.fq", "out={o}/f.fq", "outm={o}/m.fq",
                          "ref={i}/seqs.fa"], ["f.fq", "m.fq"]),
    "filtersam": (["in={i}/in.sam", "out={o}/g.sam", "outb={o}/b.sam", "vcf={i}/v.vcf",
                   "mbv=1", "border=0"], ["g.sam", "b.sam"]),
    "countbarcodes": (["in={i}/fc.fq", "counts={o}/c.txt",
                       "expected=ACGTACGT,TTTTCCCC,GGGGAAAA"], ["c.txt"]),
    "countbarcodes2": (["in={i}/fc.fq", "counts={o}/c.txt", "countundefined=f"], ["c.txt"]),
    "cutprimers": (["in={i}/prim.fq", "out={o}/c.fq", "sam1={i}/s1.sam",
                    "sam2={i}/s2.sam"], ["c.fq"]),
    "repair": (["in={i}/broken.fq", "out={o}/r1.fq", "out2={o}/r2.fq", "outs={o}/s.fq"],
               ["r1.fq", "r2.fq", "s.fq"]),
    "splitpairs": (["in={i}/inter.fq", "out={o}/a.fq", "out2={o}/b.fq"], ["a.fq", "b.fq"]),
    "bbsplitpairs": (["in={i}/r1.fq", "in2={i}/r2.fq", "out={o}/i.fq"], ["i.fq"]),
    "sortbyname": (["in={i}/named.fq", "out={o}/s.fq"], ["s.fq"]),
    "bbsort": (["in={i}/named.fq", "out={o}/s.fq", "length=t", "descending=t"], ["s.fq"]),
    "mergesorted": (["{i}/sorted_a.fq", "{i}/sorted_b.fq", "out={o}/m.fq"], ["m.fq"]),
    "bbmask": (["in={i}/contigs.fa", "out={o}/m.fa", "entropy=0.7"], ["m.fa"]),
    "shred": (["in={i}/contigs.fa", "out={o}/s.fa", "length=500", "overlap=50",
               "minlength=100"], ["s.fa"]),
    "fuse": (["in={i}/contigs.fa", "out={o}/f.fa", "pad=50", "name=all"], ["f.fa"]),
    "fusesequence": (["in={i}/contigs.fa", "out={o}/f.fa"], ["f.fa"]),
    "partition": (["in={i}/named.fq", "out={o}/p_%.fq", "ways=3"],
                  ["p_0.fq", "p_1.fq", "p_2.fq"]),
    "partitionreads": (["in={i}/inter.fq", "out={o}/p_%.fq", "ways=2"],
                       ["p_0.fq", "p_1.fq"]),
    "bbcountunique": (["in={i}/fc.fq", "out={o}/u.txt", "k=20", "interval=100"], ["u.txt"]),
    "calcuniqueness": (["in={i}/named.fq", "out={o}/u.txt", "k=15", "interval=50",
                        "cumulative=t"], ["u.txt"]),
    "comparelabels": (["in={i}/labels.fq", "out={o}/c.txt", "labelstats={o}/l.txt"],
                      ["c.txt", "l.txt"]),
    "muxbyname": (["{i}/r1.fq", "{i}/prim.fq", "out={o}/m.fq"], ["m.fq"]),
    "removebadbarcodes": (["in={i}/fc.fq", "out={o}/r.fq"], ["r.fq"]),
    "filterbarcodes": (["in={i}/bq.fq", "out={o}/f.fq", "maq=20", "baqhist={o}/a.txt",
                        "bmqhist={o}/m.txt"], ["f.fq", "a.txt", "m.txt"]),
    "tiledump": (["in={i}/fc.fq", "out={o}/d.tsv", "xsize=1000", "ysize=1000"], ["d.tsv"]),
    "plotflowcell": (["in={i}/fc.fq", "out={o}/p.tsv"], ["p.tsv"]),
    "plothist": (["in={i}/m.tsv", "out={o}/h_#.tsv", "bins=10"], ["h_a.tsv", "h_b.tsv"]),
    "plotreadposition": (["in={i}/fc.fq", "out={o}/p.tsv",
                          "expected=ACGTACGT,TTTTCCCC,GGGGAAAA"], ["p.tsv"]),
    "cg2illumina": (["in={i}/bgi.fq", "out={o}/c.fq", "barcode=ACGT"], ["c.fq"]),
    "kapastats": (["in={i}/fc.fq"], []),
    "cbcl2text": (["runfolder={i}/run", "out={o}/c.fq"], ["c.fq"]),
    "splitnextera": (["in={i}/lmp1.fq", "in2={i}/lmp2.fq", "out={o}/l1.fq", "out2={o}/l2.fq",
                      "outf={o}/f.fq", "outu={o}/u.fq", "outs={o}/s.fq", "mask=t"],
                     ["l1.fq", "l2.fq", "f.fq", "u.fq", "s.fq"]),
    "splitnexteralmp": (["in={i}/lmp1.fq", "out={o}/l.fq", "outs={o}/s.fq", "mask=t",
                         "minlength=30"], ["l.fq", "s.fq"]),
}


def _run(cli, argv):
    err, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        cli(argv)
    return re.sub(r"\d+\.\d+ s(ec(ond)?s?)?\b", "T s", err.getvalue()), out.getvalue()


@pytest.mark.parametrize("tool", list(CASES))
def test_host_tool_equals_jax(inputs, tmp_path, tool):
    argv, outs = CASES[tool]
    res = {}
    for tag, cli in (("jax", jmain), ("torch", tmain)):
        o = tmp_path / tag
        o.mkdir()
        err, out = _run(cli, [tool, *(a.format(i=inputs, o=o) for a in argv)])
        res[tag] = (err.replace(str(o), "O"), out.replace(str(o), "O"),
                    sorted(os.listdir(o)), [(o / f).read_bytes() for f in outs])
    assert res["torch"] == res["jax"]
    assert all(res["jax"][3]) or tool == "kapastats", "an output is empty"
