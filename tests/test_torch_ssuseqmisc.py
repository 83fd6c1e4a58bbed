"""The SSU tools and the sequence odds and ends of A8b on the CPU: each
launcher name of the port against the JAX package's on the same seeded
inputs, one case a name (comparessu, findssu, filtersilva, reducesilva,
addssu, idtree, trnaconsensus, runhmm; adjusthomopolymers, restorebases,
representative, bedset, tagandmerge, processhi-c, synthmda,
kmercountshort, kmerhashdump, estherfilter, renameref, renamebymapping,
renamecami, renameimg, renamebysketch), then the library cases of
tests/test_ssutools.py and tests/test_seqmisc.py at a small size. Every
output file, the standard output and the standard error are equal byte
for byte, with one mask: runhmm's seconds and its lines/s and bytes/s
rates (`Time: ... seconds.`, `...k lines/sec`, `...m bytes/sec`).

comparessu and findssu align on the run's device (the glocal identity
aligner, L5): the port's runs take device=cpu. The rest is host code
copied from the JAX package."""

import os

import numpy as np
import pytest

from bbtools_tpu.models.taxonomy import TaxTree
from torch_parity import run_host_both, warm_native_codecs  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACGT = np.frombuffer(b"ACGT", np.uint8)
NODES = ("1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tsuperkingdom\t|\n"
         "2759\t|\t1\t|\tsuperkingdom\t|\n561\t|\t2\t|\tgenus\t|\n"
         "562\t|\t561\t|\tspecies\t|\n563\t|\t561\t|\tspecies\t|\n"
         "4930\t|\t2759\t|\tgenus\t|\n4932\t|\t4930\t|\tspecies\t|\n")
NAMES = ("1\t|\troot\t|\t\t|\tscientific name\t|\n2\t|\tBacteria\t|\t\t|\tscientific name\t|\n"
         "2759\t|\tEukaryota\t|\t\t|\tscientific name\t|\n"
         "561\t|\tEscherichia\t|\t\t|\tscientific name\t|\n"
         "562\t|\tEscherichia coli\t|\t\t|\tscientific name\t|\n"
         "563\t|\tEscherichia other\t|\t\t|\tscientific name\t|\n"
         "4930\t|\tSaccharomyces\t|\t\t|\tscientific name\t|\n"
         "4932\t|\tSaccharomyces cerevisiae\t|\t\t|\tscientific name\t|\n")


def _seq(rng, n):
    return ACGT[rng.integers(0, 4, n)].tobytes()


def _mutated(rng, s, n_subs):
    b = bytearray(s)
    for j in rng.choice(len(b), n_subs, replace=False):
        b[j] = ACGT[(b"ACGT".index(b[j]) + int(rng.integers(1, 4))) % 4]
    return bytes(b)


def _fq(name, seq, q=None):
    return b"@%s\n%s\n+\n%s\n" % (name, seq, q or b"F" * len(seq))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs every case reads, made once from seed 23."""
    d = tmp_path_factory.mktemp("ssuseqmisc_in")
    rng = np.random.default_rng(23)
    (d / "nodes.dmp").write_text(NODES)
    (d / "names.dmp").write_text(NAMES)
    TaxTree.load(str(d / "names.dmp"), str(d / "nodes.dmp")).save(str(d / "tree.npz"))
    base = _seq(rng, 120)
    ssu = [(b"tid|562|ecoli", base), (b"tid|563|other", _mutated(rng, base, 6)),
           (b"tid|4932|yeast", _mutated(rng, base, 30)), (b"noid", _mutated(rng, base, 2)),
           (b"tid|562|ecoli2", _mutated(rng, base, 1))]
    (d / "ssu.fa").write_bytes(b"".join(b">%s\n%s\n" % r for r in ssu))
    (d / "panel.fa").write_bytes(b"".join(b">p%d\n%s\n" % (i, _mutated(rng, base, 3 * i + 1))
                                          for i in range(4)))
    (d / "silva.fa").write_bytes(
        b">A1 Bacteria;Proteobacteria;Gamma;Escherichia;Ecoli\nACGTACGT\n"
        b">A2 Eukaryota;Plants;Chloroplast;X\nACGTACGT\n"
        b">A3 Eukaryota;Fungi;Saccharomyces;Yeast\nACGTAAAA\n"
        b">A4 nodesc\nACGTACGT\n>A5 Eukaryota;Animals;Mitochondria;Y\nACGT\n"
        b">A6 Bacteria;Proteobacteria;Gamma;Escherichia;Efergusonii\nACGTCCCC\n"
        b">A7 Archaea;Eury;Methano;Mx\nGGGGACGT\n")
    (d / "s16.fa").write_bytes(b">tid|562|a\nAAAACCCC\n>tid|4932|b\nCCCCAAAA\n>x\nGGGG\n")
    (d / "s18.fa").write_bytes(b">tid|4932|c\nTTTTGGGG\n>tid|563|d\nGGGGTTTT\n")
    names = ["a", "b", "c", "d", "e"]
    m = np.array([[100, 97, 80, 82, 60], [97, 100, 81, 83, 61], [80, 81, 100, 95, 70],
                  [82, 83, 95, 100, 71], [60, 61, 70, 71, 100]], float)
    (d / "idm.tsv").write_text("".join(n + "\t" + "\t".join(f"{x:.1f}" for x in row) + "\n"
                                       for n, row in zip(names, m)))
    trna = _seq(rng, 76)
    (d / "trna.fa").write_bytes(b"".join(
        b">t%d\n%s\n" % (i, _mutated(rng, trna, 4)[: 76 - (i % 3)]) for i in range(12))
        + b">odd\n" + _seq(rng, 40) + b"\n")
    (d / "dom.txt").write_bytes(
        b"#                        --- full sequence ---\n"
        b"# target name  accession  tlen query name  accession  qlen ...\n"
        b"protein_1 - 257 ATP-synt_A PF00119.18 211 1.9e-49 159.6 27.5 "
        b"1 1 7.3e-51 2.5e-49 159.2 27.5 3 210 41 250 38 251 0.87 - extra\n"
        b"protein_1 - 300 ATP-synt_C PF00137.16 76 3e-10 40.1 5.0 "
        b"1 2 1e-11 4e-10 39.0 5.0 1 70 10 85 8 88 0.91 desc words\n"
        b"protein_2 - 120 ATP-synt_A PF00119.18 211 1e-20 70.0 1.0 "
        b"1 1 1e-21 2e-20 69.0 1.0 5 200 6 115 4 118 0.80 -\n")
    # reads with homopolymers; SAM with secondary records and soft clips
    reads = []
    for i in range(60):
        s = bytearray(_seq(rng, 80))
        p = int(rng.integers(0, 60))
        s[p:p + 6] = b"ACGT"[i % 4:i % 4 + 1] * 6
        reads.append(_fq(b"r%d" % i, bytes(s), bytes(33 + rng.integers(2, 40, 80).astype(np.uint8))))
    (d / "reads.fq").write_bytes(b"".join(reads))
    ref = _seq(rng, 2000)
    sam = [b"@SQ\tSN:c1\tLN:2000", b"@SQ\tSN:c2\tLN:500"]
    for i in range(40):
        p = int(rng.integers(0, 1900))
        s = ref[p:p + 60]
        q = bytes(33 + rng.integers(2, 40, 60).astype(np.uint8))
        cig = [b"60M", b"25S35M", b"30M30S", b"5S55M"][i % 4]
        name = b"tid_%d_read%d" % (562 if i % 3 else 4932, i)
        sam.append(b"%s\t%d\tc%d\t%d\t60\t%s\t*\t0\t0\t%s\t%s"
                   % (name, 16 * (i % 2), 1 + i % 2, p + 1, cig, s, q))
        if i % 5 == 0:
            sam.append(b"%s\t%d\tc1\t%d\t0\t60M\t*\t0\t0\t*\t*" % (name, 256 + 16 * (i % 3 == 0), p + 40))
        if i % 7 == 0:
            sam.append(b"%s\t2048\tc2\t%d\t0\t60M\t*\t0\t0\t*\t*" % (name, 10 + i))
    sam.append(b"un\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII")
    (d / "in.sam").write_bytes(b"\n".join(sam) + b"\n")
    (d / "edges.tsv").write_bytes(b"#a\tb\tdist\na\tb\t0.01\nb\tc\t0.015\nc\td\t0.5\n"
                                  b"d\te\t0.01\ne\tf\t0.03\nf\tg\t0.02\nh\ti\t0.9\n")
    (d / "a.bed").write_bytes(b"track x\nc1\t0\t100\nc1\t200\t300\nc2\t50\t80\nc1\t90\t150\n")
    (d / "b.bed").write_bytes(b"c1\t50\t250\nc2\t0\t60\n")
    (d / "c.bed").write_bytes(b"c1\t60\t70\nc1\t240\t260\nc3\t0\t10\n")
    (d / "demux_ACGTACGT.fq").write_bytes(b"".join(reads[:10]))
    (d / "x_TTTTCCCC-GGGGAAAA.fq").write_bytes(b"".join(reads[10:15]))
    (d / "nobarcode.fq").write_bytes(b"".join(reads[15:18]))
    (d / "contigs.fa").write_bytes(b">c1 first\n%s\n>c2\n%s\n>c3 tid_77\n%s\n"
                                   % (ref, ref[:500], _seq(rng, 300)))
    (d / "map.tsv").write_bytes(b"#old\tnew\nc1\tchrom1\nc2\tchrom2\n")
    (d / "query.fa").write_bytes(b"".join(b">q%d desc\n%s\n" % (i, _seq(rng, 50)) for i in range(6)))
    (d / "blast.tsv").write_bytes(b"".join(
        b"q%d\ts%d\t98.0\t50\t1\t0\t1\t50\t1\t50\t1e-20\t%d\n" % (i, i, 60 + 20 * i)
        for i in range(6)))
    (d / "key.tsv").write_bytes(b"c1\t562\nc3\t4932\n")
    (d / "img.tsv").write_bytes(b"c2\t1280\nc3\t562\n")
    (d / "gA.fa").write_bytes(b">gA\n" + ref + b"\n")
    (d / "gB.fa").write_bytes(b">gB\n" + _seq(rng, 2000) + b"\n")
    (d / "qA.fa").write_bytes(b">qA\n" + _mutated(rng, ref, 10) + b"\n")
    return d


TREE = "tree={i}/tree.npz"
RES_PHIX = "ref=" + os.path.join(REPO, "bbtools_tpu", "resources", "phix2.fa.gz")
#: tools that do device work (the port's run takes device=cpu)
DEVICE = ("comparessu", "findssu")

#: name -> argv with {i} the inputs and {o} the side's output directory
CASES = {
    "comparessu": ["in={i}/ssu.fa", "out={o}/cmp.tsv", TREE],
    "findssu": ["in={i}/ssu.fa", "ref={i}/panel.fa", "out={o}/best.tsv"],
    "filtersilva": ["in={i}/silva.fa", "out={o}/f.fa"],
    "reducesilva": ["in={i}/silva.fa", "out={o}/r.fa", "column=2"],
    "addssu": ["16S={i}/s16.fa", "18S={i}/s18.fa", "out={o}/ssu.fa", TREE],
    "idtree": ["in={i}/idm.tsv", "out={o}/tree.nwk"],
    "trnaconsensus": ["in={i}/trna.fa", "out={o}/cons.fa"],
    "runhmm": ["in={i}/dom.txt"],
    "adjusthomopolymers": ["in={i}/reads.fq", "out={o}/adj.fq", "rate=0.5"],
    "restorebases": ["in={i}/in.sam", "out={o}/rb.sam"],
    "representative": ["in={i}/edges.tsv", "out={o}/reps.txt", "thresh=0.02"],
    "bedset": ["in={i}/a.bed,{i}/b.bed,{i}/c.bed", "out={o}/s.bed", "mode=subtract"],
    "tagandmerge": ["in={i}/demux_ACGTACGT.fq,{i}/x_TTTTCCCC-GGGGAAAA.fq,{i}/nobarcode.fq",
                    "out={o}/merged.fq"],
    "processhi-c": ["in={i}/in.sam", "out={o}/junc.tsv", "k=6", "minclip=20"],
    "synthmda": [RES_PHIX, "out={o}/mda.fa", "depth=2", "minfrag=300", "seed=3"],
    "kmercountshort": ["in={i}/reads.fq", "out={o}/k.tsv", "k=4", "skip=2"],
    "kmerhashdump": ["in={i}/reads.fq", "out={o}/h.txt", "k=21"],
    "estherfilter": ["query={i}/query.fa", "blast={i}/blast.tsv", "out={o}/e.fa",
                     "cutoff=110"],
    "renameref": ["in={i}/in.sam", "out={o}/rr.sam", "map={i}/map.tsv"],
    "renamebymapping": ["in={i}/contigs.fa", "sam={i}/in.sam", "out={o}/rm.fa"],
    "renamecami": ["in={i}/contigs.fa", "key={i}/key.tsv", "out={o}/rc.fa"],
    "renameimg": ["in={i}/contigs.fa", "img={i}/img.tsv", "out={o}/ri.fa"],
    "renamebysketch": ["in={i}/qA.fa,{i}/gB.fa", "ref={i}/gA.fa,{i}/gB.fa"],
}
MASKS = [(r"Time:\s+\t[0-9.]+ seconds\.", "Time: T seconds."),
         (r"[0-9.]+k lines/sec", "Rk lines/sec"), (r"[0-9.]+m bytes/sec", "Rm bytes/sec")]


@pytest.mark.parametrize("tool", list(CASES))
def test_host_tool_equals_jax(inputs, tmp_path, tool):
    res = run_host_both(tool, CASES[tool], inputs, tmp_path, device=tool in DEVICE,
                        masks=MASKS)
    assert res["torch"] == res["jax"]
    assert res["jax"][2] or res["jax"][0] or res["jax"][1], "no output"


# ------------------------------------------------ library cases, small size


def test_tid_of_and_upgma_equal_jax():
    from bbtools_torch.models import ssutools as t
    from bbtools_tpu.models import ssutools as j

    for name in (b"tid|123|foo bar", b"x tid_77_y", b"noid here", b"ncbi:42 z", b"9606|h"):
        assert t._tid_of(name) == j._tid_of(name)
    rng = np.random.default_rng(5)
    x = rng.random((6, 6))
    d = (x + x.T) / 2
    names = [f"s{i}" for i in range(6)]
    assert t.upgma_newick(d, names) == j.upgma_newick(d, names)


def test_parse_domtbl_equals_jax(inputs):
    from bbtools_torch.models import ssutools as t
    from bbtools_tpu.models import ssutools as j

    lt, st, nt, bt = t.parse_domtbl(str(inputs / "dom.txt"))
    lj, sj, nj, bj = j.parse_domtbl(str(inputs / "dom.txt"))
    assert (nt, bt) == (nj, bj) == (5, 455)
    assert [[getattr(x, f) for f in t.HMMSearchLine.__slots__] for x in lt] == \
        [[getattr(x, f) for f in j.HMMSearchLine.__slots__] for x in lj]
    assert {k: v.map for k, v in st.items()} == {k: v.map for k, v in sj.items()}


def test_adjust_read_and_hash64shift_equal_jax():
    from bbtools_torch.models import seqmisc as t
    from bbtools_tpu.models import seqmisc as j

    for seq, rate in ((b"AAAAACGT", 0.4), (b"AAAAACGT", -0.4), (b"GGGGNNNNTT", 0.5),
                      (b"ACGT", 1.0)):
        assert t._adjust_read(seq, b"I" * len(seq), rate) == \
            j._adjust_read(seq, b"I" * len(seq), rate)
    x = np.random.default_rng(3).integers(0, 1 << 62, 1000, dtype=np.int64)
    assert (t._hash64shift(x) == j._hash64shift(x)).all()


def test_clade_db_roundtrip_between_packages(tmp_path):
    """A clade DB the port writes loads in the JAX package with the same
    profiles, and classifies a query as the JAX package's does."""
    from bbtools_torch.models import clade as t
    from bbtools_tpu.models import clade as j

    phix = os.path.join(REPO, "bbtools_tpu", "resources", "phix2.fa.gz")
    ref = os.path.join(REPO, "bbtools_tpu", "resources", "16S_consensus_sequence.fa")
    t.save_db([t.profile_fasta(phix), t.profile_fasta(ref)], str(tmp_path / "db.npz"))
    back = j.load_db(str(tmp_path / "db.npz"))
    direct = j.profile_fasta(phix)
    assert len(back) == 2 and j.compare(direct, back[0]) < 1e-5
    q = t.profile_fasta(phix)
    assert [(round(s, 12), c.name) for s, c in t.classify(q, t.load_db(str(tmp_path / "db.npz")))] \
        == [(round(s, 12), c.name) for s, c in j.classify(direct, back)]
