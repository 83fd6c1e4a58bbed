"""A8b group 4's SAM, VCF, GFF and assembly-finishing tools on the CPU:
each launcher name of the port against the JAX package's on the same
seeded inputs, one case a name (samutils' 9 names, vcftools' 4,
gfftools' 3, fixgaps, fungalrelease, consensus/consensusmaker and
lilypad). Every output file, the standard output and the standard
error are equal byte for byte. The inputs are the JAX package's own
test shapes (tests/test_longtail{2,3,4,5,7,8}.py, tests/test_tools.py);
the SAMs that consensus and lilypad read are written from known read
positions instead of a mapper's run. All of these tools are host code
copied from the JAX package; vcf2gff names its program in the GFF's
source column, which the port's copy writes as bbtools_torch."""

import numpy as np
import pytest

from torch_parity import run_host_both, warm_native_codecs  # noqa: F401  (autouse)

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _seq(rng, n):
    return ACGT[rng.integers(0, 4, n)].tobytes()


SAM_HEADER = b"@HD\tVN:1.4\tSO:unsorted\n@SQ\tSN:chr1\tLN:1000\n@SQ\tSN:chr2\tLN:1000\n"


def _sam_line(qname, flag, rname=b"chr1", pos=100, mapq=30, cigar=b"10M", seq=b"A" * 10):
    return b"\t".join([qname, b"%d" % flag, rname, b"%d" % pos, b"%d" % mapq, cigar,
                       b"=", b"0", b"0", seq, b"I" * len(seq)]) + b"\n"


VCF = (
    b"##fileformat=VCFv4.2\n"
    b"##contig=<ID=chr1,length=1000>\n"
    b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
    b"chr1\t5\t.\tA\tT\t40.0\tPASS\tTYP=SUB;AD=10;AF=0.9;STA=4;STO=5\tGT:DP\t1/1:10\n"
    b"chr1\t12\t.\tCA\tC\t30.0\tPASS\tTYP=DEL;AD=4;AF=0.4;STA=11;STO=13\tGT:DP\t0/1:10\n"
    b"chr1\t40\t.\tG\tGCC\t50\tPASS\tTYP=INS;AD=7;AF=0.7;STA=39;STO=40\tGT:DP\t0/1:10\n"
    b"chr2\t3\t.\tG\tGTT\t20.0\tPASS\tTYP=INS;AD=2;AF=0.2;STA=2;STO=3\tGT:DP\t0/1:10\n"
)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs every case reads, made once from seed 41."""
    d = tmp_path_factory.mktemp("a8b4_samvcf_in")
    rng = np.random.default_rng(41)
    # splitsam, mergesam, samtoroc, dedupebymapping, samtoest
    (d / "split.sam").write_bytes(
        SAM_HEADER + _sam_line(b"p", 0) + _sam_line(b"m", 16)
        + _sam_line(b"u", 4, rname=b"*", pos=0, cigar=b"*")
        + _sam_line(b"a", 0x41 | 0x20) + _sam_line(b"a", 0x81 | 16)
        + _sam_line(b"b", 0x41 | 0x8) + _sam_line(b"b", 0x81 | 4, rname=b"*", pos=0,
                                                   cigar=b"*"))
    (d / "a.sam").write_bytes(SAM_HEADER + _sam_line(b"x", 0))
    (d / "b.sam").write_bytes(SAM_HEADER + _sam_line(b"y", 0, pos=300))
    roc = [SAM_HEADER]
    for i in range(5):
        roc.append(_sam_line(b"r%d_scaf0_pos%d_strand0_insert0" % (i, 100 + i), 0,
                             pos=101 + i, mapq=30))
    roc.append(_sam_line(b"r9_scaf0_pos50_strand0_insert0", 0, rname=b"chr2", pos=51,
                         mapq=3))
    roc.append(_sam_line(b"r7_scaf0_pos70_strand1_insert0", 16, pos=75, mapq=12))
    (d / "roc.sam").write_bytes(b"".join(roc))
    q_hi, q_lo = b"I" * 10, b"#" * 10
    (d / "dup.sam").write_bytes(b"\n".join([
        b"@SQ\tSN:c1\tLN:1000",
        b"dup1\t0\tc1\t100\t40\t10M\t*\t0\t0\tACGTACGTAC\t" + q_lo,
        b"dup2\t0\tc1\t100\t40\t10M\t*\t0\t0\tACGTACGTAC\t" + q_hi,
        b"dup3\t0\tc1\t100\t40\t10M\t*\t0\t0\tACGTACGTAC\t" + q_lo,
        b"rev\t16\tc1\t100\t40\t10M\t*\t0\t0\tACGTACGTAC\t" + q_hi,
        b"uniq\t0\tc1\t300\t40\t10M\t*\t0\t0\tGGGGCCCCAA\t" + q_hi,
        b"unmapped\t4\t*\t0\t0\t*\t*\t0\t0\tTTTTTTTTTT\t" + q_hi,
    ]) + b"\n")
    (d / "est.sam").write_bytes(b"\n".join([
        b"@SQ\tSN:c1\tLN:10000",
        b"e1\t0\tc1\t100\t40\t100M\t*\t0\t0\t" + b"A" * 100 + b"\t" + b"I" * 100,
        b"e2\t0\tc1\t500\t40\t50M50S\t*\t0\t0\t" + b"C" * 100 + b"\t" + b"I" * 100,
        b"e4\t0\tc1\t900\t40\t30M2D70M\t*\t0\t0\t" + b"T" * 100 + b"\t" + b"I" * 100,
        b"e3\t4\t*\t0\t0\t*\t*\t0\t0\t" + b"G" * 100 + b"\t" + b"I" * 100,
    ]) + b"\n")
    # VCF tools
    (d / "in.vcf").write_bytes(VCF)
    (d / "apply.fa").write_bytes(b">chr1\nAAAAACAAAAACAAA\n>chr2\nGGGGGGGGGG\n")
    (d / "apply.vcf").write_bytes(
        b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        b"chr1\t6\t.\tC\tT\t40\tPASS\tAD=9\n"
        b"chr1\t12\t.\tCA\tC\t40\tPASS\tAD=9\n"
        b"chr2\t3\t.\tG\tGTT\t40\tPASS\tAD=9\n")
    # GFF tools
    (d / "t.gbff").write_bytes(
        b"LOCUS       NC_001422             5386 bp    DNA\n"
        b"ACCESSION   NC_001422\n"
        b"FEATURES             Location/Qualifiers\n"
        b"     source          1..5386\n"
        b"     gene            100..500\n"
        b"                     /locus_tag=\"tag1\"\n"
        b"     CDS             100..500\n"
        b"                     /product=\"test protein\"\n"
        b"                     /locus_tag=\"tag1\"\n"
        b"     CDS             complement(600..900)\n"
        b"                     /product=\"rev protein\"\n"
        b"     rRNA            1000..2000\n"
        b"                     /product=\"16S ribosomal RNA\"\n"
        b"     CDS             3000..3200\n"
        b"                     /pseudo\n"
        b"ORIGIN\n"
        b"        1 acgtacgtac\n"
        b"//\n")
    g100 = _seq(rng, 100)
    (d / "g.fna").write_bytes(b">c1\n" + g100 + b"\n")
    (d / "g.gff").write_bytes(
        b"##gff-version 3\n"
        b"c1\tx\tCDS\t11\t40\t.\t+\t0\tID=f1\n"
        b"c1\tx\tCDS\t51\t80\t.\t-\t0\tID=f2\n"
        b"c1\tx\trRNA\t5\t9\t.\t+\t.\tID=r1\n")
    (d / "ref.gff").write_bytes(
        b"c1\tx\tCDS\t10\t40\t.\t+\t0\tID=a\n"
        b"c1\tx\tCDS\t60\t90\t.\t-\t0\tID=b\n")
    (d / "q.gff").write_bytes(
        b"c1\ty\tCDS\t10\t40\t.\t+\t0\tID=a\n"
        b"c1\ty\tCDS\t66\t90\t.\t-\t0\tID=b2\n"
        b"c1\ty\tCDS\t200\t260\t.\t+\t0\tID=c\n")
    # fixgaps: 600 bp + 20 Ns + 600 bp; the true gap is 50, the insert 200
    fa, fb = _seq(rng, 600), _seq(rng, 600)
    scaffold = fa + b"N" * 20 + fb
    (d / "gap.fa").write_bytes(b">s\n" + scaffold + b"\n")
    lines = [b"@SQ\tSN:s\tLN:%d\n" % len(scaffold)]

    def pair(qname, pos, tlen):
        return b"\t".join([qname, b"99", b"s", b"%d" % pos, b"40", b"50M", b"=",
                           b"%d" % (pos + tlen - 50), b"%d" % tlen, b"A" * 50,
                           b"I" * 50]) + b"\n"

    i = 0
    for starts, tlen in ((range(1, 420, 4), 200), (range(640, 1040, 4), 200),
                         (range(470, 570, 2), 170)):
        for s in starts:
            lines.append(pair(b"n%d" % i, s, tlen))
            i += 1
    (d / "gap.sam").write_bytes(b"".join(lines))
    # fungalrelease
    c1, c2 = _seq(rng, 120), _seq(rng, 80)
    (d / "asm.fa").write_bytes(b">sA desc\n" + c1 + b"NNN" + c2 + b"\n>sB\n" + _seq(rng, 30)
                               + b"\n>sC\n" + _seq(rng, 300) + b"\n")
    # consensus: a 6,000 bp truth, the given reference with 3 planted
    # errors, 600 reads of 100 bp at known positions (10x)
    truth = bytearray(_seq(rng, 6000))
    wrong = bytearray(truth)
    for p in (1500, 3000, 4500):
        wrong[p] = ACGT[(int(np.searchsorted(ACGT, wrong[p])) + 1) % 4]
    (d / "cref.fa").write_bytes(b">scaffold_0\n" + bytes(wrong) + b"\n")
    cl = [b"@SQ\tSN:scaffold_0\tLN:6000\n"]
    for r in range(600):
        s0 = int(rng.integers(0, 5900))
        seq = bytes(truth[s0:s0 + 100])
        if r % 9 == 0:  # a 2 bp deletion in some reads
            seq = seq[:50] + seq[52:] + bytes(truth[s0 + 100:s0 + 102])
            cig = b"50M2D50M"
        else:
            cig = b"100M"
        cl.append(b"r%d\t%d\tscaffold_0\t%d\t40\t%s\t*\t0\t0\t%s\t%s\n" % (
            r, 16 * (r % 2), s0 + 1, cig, seq, b"F" * 100))
    (d / "cons.sam").write_bytes(b"".join(cl))
    # lilypad: two contigs of a 6,000 bp genome with a 200 bp gap, 30
    # pairs whose mates fall on either side (insert 600)
    g = _seq(rng, 6000)
    (d / "ctg.fa").write_bytes(b">ctgA\n" + g[:2500] + b"\n>ctgB\n" + g[2700:5500] + b"\n")
    ll = [b"@SQ\tSN:ctgA\tLN:2500\n@SQ\tSN:ctgB\tLN:2800\n"]
    for p in range(30):
        s0 = 2200 + int(rng.integers(0, 200))
        e0 = s0 + 500 - 2700
        ll.append(b"p%d\t97\tctgA\t%d\t40\t100M\tctgB\t%d\t0\t%s\t%s\n" % (
            p, s0 + 1, e0 + 1, g[s0:s0 + 100], b"F" * 100))
        ll.append(b"p%d\t145\tctgB\t%d\t40\t100M\tctgA\t%d\t0\t%s\t%s\n" % (
            p, e0 + 1, s0 + 1, g[s0 + 500:s0 + 600], b"F" * 100))
    (d / "lily.sam").write_bytes(b"".join(ll))
    return d


#: name -> argv with {i} the inputs and {o} the side's output directory
CASES = {
    "splitsam": ["{i}/split.sam", "{o}/p.sam", "{o}/m.sam", "{o}/u.sam", "header"],
    "splitsam4way": ["{i}/split.sam", "{o}/p.sam", "{o}/m.sam", "{o}/c.sam", "{o}/u.sam"],
    "splitsam6way": ["{i}/split.sam", "{o}/r1p.sam", "{o}/r1m.sam", "{o}/r1u.sam",
                     "{o}/r2p.sam", "{o}/r2m.sam", "{o}/r2u.sam"],
    "mergesam": ["{i}/a.sam", "{i}/b.sam", "out={o}/o.sam"],
    "mergesam2": ["in={i}/a.sam,{i}/b.sam", "out={o}/o.sam"],
    "samtoroc": ["in={i}/roc.sam", "out={o}/roc.txt", "reads=8"],
    "dedupebymapping": ["in={i}/dup.sam", "out={o}/out.fq"],
    "samtoest": ["in={i}/est.sam", "out={o}/est.txt"],
    "bbest": ["in={i}/est.sam"],
    "invertvcf": ["in={i}/in.vcf", "out={o}/inv.vcf"],
    "filtervcf": ["in={i}/in.vcf", "out={o}/o.vcf", "del=f", "minreads=3"],
    "applyvariants": ["in={i}/apply.fa", "vcf={i}/apply.vcf", "out={o}/o.fa"],
    "vcf2gff": ["in={i}/in.vcf", "out={o}/o.gff"],
    "gbff2gff": ["in={i}/t.gbff", "out={o}/t.gff"],
    "cutgff": ["in={i}/g.fna", "gff={i}/g.gff", "out={o}/o.fa", "types=CDS"],
    "comparegff": ["in={i}/q.gff", "ref={i}/ref.gff", "out={o}/o.txt"],
    "fixgaps": ["in={i}/gap.sam", "ref={i}/gap.fa", "out={o}/fixed.fa"],
    "fungalrelease": ["in={i}/asm.fa", "out={o}/o.fa", "outc={o}/c.fa", "agp={o}/o.agp",
                      "legend={o}/leg.txt", "minscaf=50", "mingap=10"],
    "consensus": ["in={i}/cons.sam", "ref={i}/cref.fa", "out={o}/cons.fa"],
    "consensusmaker": ["in={i}/cons.sam", "ref={i}/cref.fa", "out={o}/cons.fa",
                       "noindels=t"],
    "lilypad": ["ref={i}/ctg.fa", "in={i}/lily.sam", "out={o}/sc.fa", "ns=200",
                "mindepth=4"],
}


def _rename_program(res):
    """The JAX side's files with the program's name as the port writes
    it (vcf2gff's source column)."""
    out, err, files = res["jax"]
    return (out, err, {k: v.replace(b"bbtools_tpu", b"bbtools_torch") if isinstance(v, bytes)
                       else v for k, v in files.items()})


@pytest.mark.parametrize("tool", list(CASES))
def test_sam_vcf_tool_equals_jax(inputs, tmp_path, tool):
    res = run_host_both(tool, CASES[tool], inputs, tmp_path)
    assert res["torch"] == _rename_program(res)
    assert res["jax"][2] or res["jax"][0] or res["jax"][1], "no output"


def test_the_finishing_tools_do_their_work(inputs, tmp_path):
    """consensus corrects the planted errors, lilypad makes the one join
    and fixgaps resizes the gap toward its true 50 bp, in both packages
    alike (the cases above hold them equal)."""
    from bbtools_torch.cli import main

    main(["consensus", f"in={inputs}/cons.sam", f"ref={inputs}/cref.fa",
          f"out={tmp_path}/c.fa"])
    main(["lilypad", f"ref={inputs}/ctg.fa", f"in={inputs}/lily.sam", f"out={tmp_path}/s.fa",
          "ns=200", "mindepth=4"])
    main(["fixgaps", f"in={inputs}/gap.sam", f"ref={inputs}/gap.fa", f"out={tmp_path}/f.fa"])

    def seqs(p):
        return [ln for ln in p.read_bytes().split(b"\n") if ln and not ln.startswith(b">")]

    wrong = b"".join(seqs(inputs / "cref.fa"))
    cons = b"".join(seqs(tmp_path / "c.fa"))
    assert len(cons) == len(wrong) and sum(x != y for x, y in zip(cons, wrong)) >= 3
    assert (tmp_path / "s.fa").read_bytes().count(b">") == 1
    assert b"N" * 200 in b"".join(seqs(tmp_path / "s.fa"))
    assert 40 <= b"".join(seqs(tmp_path / "f.fa")).count(b"N") <= 60
