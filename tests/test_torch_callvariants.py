"""The port's CallVariants against the JAX package's on the CPU, on the
cases of tests/test_callvariants.py: `python -m bbtools_torch
callvariants ... device=cpu` writes the VCF byte-equal to `python -m
bbtools_tpu callvariants ...` (but for the package named in the
`##source` line) at defaults, `ploidy=2`, `realign=t`, `multisample`,
`junctions` and `invcf`. With `nn=t` the QUAL column is the scoring
net's float32 output scaled to 0-40 and printed to two decimals: the
two packages' float32 matmuls sum in different orders, and where a
scaled score lies within a few ulps of a rounding boundary its last
digit flips. That test finds each flipped digit and allows nothing else
(see `assert_vcf_equal`). Also `CellNet.apply` against the JAX net on
the bundled .bbnet files, and `realign_batch` against the JAX one."""

import numpy as np
import pytest

from bbtools_torch.cli import main as tmain
from bbtools_torch.ml import cellnet as tcn
from bbtools_torch.models import callvariants as tcv
from bbtools_torch.ops import msa as tmsa
from bbtools_torch.utils import vcfdiff
from bbtools_tpu.core.dna import CODE_TO_BASE
from bbtools_tpu.io.fasta import load_reference, write_fasta
from bbtools_tpu.io.sam import SamWriter
from bbtools_tpu.ml import cellnet as jcn
from bbtools_tpu.models import callvariants as jcv
from bbtools_tpu.models.bbmap import BBMap, BBMapConfig
from bbtools_tpu.models.bbmap_index import SeedIndex
from bbtools_tpu.ops import msa as jmsa
from bbtools_tpu.utils.synth import mutate_genome, random_genome, random_reads, write_reads

#: the largest difference allowed between the two packages' net outputs
#: (sigmoid outputs in [0, 1]): float32 matmuls of up to 160 terms in six
#: layers, summed in different orders, differ by a few ulps at each layer
NET_TOL = 4e-6


def assert_vcf_equal(want: bytes, got: bytes, qual_flips: bool = False) -> int:
    """The port's VCF equals the JAX package's, but for the package name
    in `##source`. With qual_flips, a row may differ in its QUAL column
    and its SCR= field only, each by one unit in the last printed digit
    (0.01), and both by the same amount: the rounding of a float32 net
    score (`bbtools_torch.utils.vcfdiff.qual_flips`, which also bounds
    such rows to one in fifty). Returns the number of such rows."""
    assert want.count(b"bbtools_tpu") == 1  # ##source=bbtools_tpu.callvariants
    want = want.replace(b"bbtools_tpu", b"bbtools_torch")
    if want == got:
        return 0
    assert qual_flips, "VCFs differ"
    return vcfdiff.qual_flips(want, got)


def run_both(tmp, tag, args, qual_flips=False):
    """Run `callvariants` in both packages; returns the port's tool (None
    through the CLI), the JAX package's, and the count of flipped QUAL
    digits."""
    files, tools = {}, {}
    for pkg in ("jax", "torch"):
        out = tmp / f"{tag}.{pkg}.vcf"
        argv = [*args, f"vcf={out}"]
        if pkg == "jax":
            tools[pkg] = jcv.main(argv)
        elif tag.startswith("cli"):
            assert tmain(["callvariants", *argv, "device=cpu"]) == 0
        else:
            tools[pkg] = tcv.main([*argv, "device=cpu"])
        files[pkg] = out.read_bytes()
    flips = assert_vcf_equal(files["jax"], files["torch"], qual_flips)
    return tools.get("torch"), tools["jax"], flips


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """test_callvariants_end_to_end's data at a third of its size: a
    20 kb genome, reads of a copy with SNPs (0.3%) drawn with 1%
    substitutions and 1-10 bp indels in 10% of them, mapped by the JAX
    package's BBMap."""
    tmp = tmp_path_factory.mktemp("tcv")
    write_fasta(str(tmp / "ref.fa"), random_genome(20_000, n_scaffolds=1, seed=21))
    ref = load_reference(str(tmp / "ref.fa"))
    mutated, _ = mutate_genome(ref, sub_rate=0.003, seed=22)
    write_fasta(str(tmp / "mut.fa"),
                [(b"scaffold_0", CODE_TO_BASE[np.minimum(mutated[0], 4)].tobytes())])
    mref = load_reference(str(tmp / "mut.fa"))
    write_reads(str(tmp / "r.fq"), random_reads(
        mref, 1200, read_len=100, snp_rate=0.01, indel_rate=0.1, indel_range=(1, 10),
        seed=23))
    BBMap(BBMapConfig(in1=str(tmp / "r.fq"), out=str(tmp / "m.sam"), batch_reads=1200),
          index=SeedIndex.build(ref, k=13)).run()
    return tmp


@pytest.mark.parametrize("tag,flags", [
    ("cli_default", []), ("ploidy2", ["ploidy=2"]), ("realign", ["realign=t"]),
    ("junctions", ["junctions=t", "minscore=0"]),
    ("filters", ["minallelefraction=0.05", "minreads=1", "rarity=0.5"]),
])
def test_vcf_equal_jax(mapped, tag, flags):
    tool, jtool, _ = run_both(mapped, tag, [f"in={mapped / 'm.sam'}",
                                            f"ref={mapped / 'ref.fa'}", *flags])
    assert len(jtool.varmap) > 50
    if tool is not None:
        assert tool.realigned == jtool.realigned


def test_vcf_nn_equal_jax_but_for_flipped_digits(mapped):
    """nn=t: rows equal but for the last digit of QUAL where the float32
    net score rounds the other way (`assert_vcf_equal`); the count of
    such rows is at most one in fifty."""
    tool, jtool, flips = run_both(mapped, "nn", [
        f"in={mapped / 'm.sam'}", f"ref={mapped / 'ref.fa'}", "nn=t", "minscore=10"],
        qual_flips=True)
    assert str(tool.net.device) == "cpu"
    print(f"nn=t: {flips} of {len(jtool.varmap)} rows with a flipped last QUAL digit")
    assert flips <= max(1, len(jtool.varmap) // 50), flips


_ROW = (b"scaffold_0\t%d\t.\tA\tC\t%s\tPASS\tSN=0;STA=%d;TYP=SUB;AF=0.5;DP=%d;SCR=%s"
        b"\tGT:DP\t0/1:%d")


def _vcf(rows):
    return b"##fileformat=VCFv4.2\n#CHROM\tPOS\n" + b"".join(
        _ROW % (i + 1, q, i, dp, scr, dp) + b"\n" for i, (q, dp, scr) in enumerate(rows))


_BASE = [(b"31.25", 12, b"31.25")] + [(b"20.00", 9, b"20.00")] * 59


@pytest.mark.parametrize("change,flips", [
    ((0, (b"31.25", 12, b"31.25")), 0),  # equal
    ((0, (b"31.26", 12, b"31.26")), 1),  # QUAL and SCR= up by 0.01
    ((0, (b"31.24", 12, b"31.24")), 1),  # and down
    ((0, (b"31.26", 12, b"31.25")), None),  # QUAL alone
    ((0, (b"31.26", 12, b"31.24")), None),  # SCR= the other way
    ((0, (b"31.27", 12, b"31.27")), None),  # by 0.02
    ((0, (b"31.26", 13, b"31.26")), None),  # another INFO field (and sample) too
])
def test_vcfdiff_allows_only_a_flipped_qual_digit(change, flips):
    """The comparator every nn=t check uses (CPU tests, card tests, the
    chip smoke): a row may differ in QUAL and SCR= by the same 0.01 and
    in nothing else."""
    i, row = change
    got = list(_BASE)
    got[i] = row
    if flips is None:
        with pytest.raises(ValueError):
            vcfdiff.qual_flips(_vcf(_BASE), _vcf(got))
    else:
        assert vcfdiff.qual_flips(_vcf(_BASE), _vcf(got)) == flips


def test_vcfdiff_bounds_the_flipped_rows():
    """At most one data row in fifty (at least one) may flip; a missing
    row is never a flip."""
    got = list(_BASE)
    got[0] = (b"31.26", 12, b"31.26")
    got[1] = (b"20.01", 9, b"20.01")
    assert vcfdiff.qual_flips(_vcf(_BASE + _BASE[1:] * 2), _vcf(got + _BASE[1:] * 2)) == 2
    with pytest.raises(ValueError):
        vcfdiff.qual_flips(_vcf(_BASE), _vcf(got))
    with pytest.raises(ValueError):
        vcfdiff.qual_flips(_vcf(_BASE), _vcf(_BASE[:-1]))


def test_cellnet_apply_matches_jax():
    """The port's float32 forward against the JAX net's on every bundled
    .bbnet (CallVariants', BBMerge's and the rest), within NET_TOL; the
    classes agree wherever the score is further than NET_TOL from the
    cutoff."""
    import glob
    import os

    here = os.path.dirname(os.path.abspath(jcn.__file__))
    nets = sorted(glob.glob(os.path.join(here, "..", "resources", "*.bbnet")))
    assert len(nets) >= 5
    rng = np.random.default_rng(0)
    for path in nets:
        jnet = jcn.parse_bbnet(path)
        tnet = tcn.parse_bbnet(path)
        tnet.device = "cpu"
        x = rng.normal(0, 2, (2000, jnet.dims[0])).astype(np.float32)
        want = jnet.apply(x)
        got = tnet.apply(x)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=NET_TOL, err_msg=path)
        clear = np.abs(want[:, 0] - jnet.cutoff) > NET_TOL
        np.testing.assert_array_equal(tnet.classify(x)[clear], jnet.classify(x)[clear])


def test_cellnet_activations_match_jax():
    """Each activation type alone, on a grid: equal to the JAX package's
    within float32 rounding of exp/log/tanh."""
    import jax.numpy as jnp
    import torch

    x = np.linspace(-12, 12, 4001, dtype=np.float32)
    for t in range(len(jcn.TYPES)):
        types = np.full(len(x), t, np.int32)
        want = np.asarray(jcn._activations(jnp.asarray(x), types))
        got = tcn._activations(torch.from_numpy(x), types).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-7, err_msg=jcn.TYPES[t])


def test_realign_batch_matches_jax():
    """Matches, start columns and scores of realign_batch on ragged
    windows (lengths 150-400 in a 400-column array), reads with
    substitutions, a 5 bp deletion, undefined bases and ragged lengths."""
    g = np.random.default_rng(3)
    B, R, W = 48, 120, 400
    genome = g.integers(0, 4, 5000).astype(np.uint8)
    reads = np.full((B, R), 4, np.uint8)
    rl = g.integers(60, R + 1, B).astype(np.int32)
    refs = np.full((B, W), 4, np.uint8)
    wl = g.integers(150, W + 1, B).astype(np.int32)
    for i in range(B):
        s = int(g.integers(0, 4500))
        refs[i, : wl[i]] = genome[s : s + wl[i]]
        off = int(g.integers(0, max(1, wl[i] - rl[i])))
        r = genome[s + off : s + off + rl[i] + 5].copy()
        m = g.random(len(r)) < 0.05
        r[m] = g.integers(0, 4, m.sum())
        if i % 3 == 0:
            r = np.concatenate([r[:30], r[35:]])
        r = r[: rl[i]]
        if i % 7 == 0:
            r[5] = 4
        reads[i, : len(r)] = r
        rl[i] = len(r)
    want = jmsa.realign_batch(reads, rl, refs, wl)
    got = tmsa.realign_batch(reads, rl, refs, wl, "cpu")
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    assert sum(m.count(b"D") >= 5 for m in got[0]) >= B // 6


def test_prepare_limits_matches_jax():
    g = np.random.default_rng(4)
    reads = g.integers(0, 5, (6, 40)).astype(np.uint8)
    refs = g.integers(0, 5, (6, 90)).astype(np.uint8)
    rl = np.array([40, 30, 1, 12, 40, 25])
    fl = np.array([90, 60, 3, 40, 88, 90])
    ms = g.integers(0, 500, 6)
    for w, t in zip(jmsa.prepare_limits_np(reads, rl, refs, fl, ms),
                    tmsa.prepare_limits_np(reads, rl, refs, fl, ms)):
        np.testing.assert_array_equal(t, w)


def _write_sam(path, ref, rows):
    w = SamWriter(str(path), ref.names, ref.lengths)
    w.add_batch(0, b"".join(b"\t".join(r) + b"\n" for r in rows))
    w.close()


def test_realign_recovers_deletion_equal_jax(tmp_path):
    """test_realign_recovers_deletion: reads spanning a 3 bp deletion,
    written with the tail soft-clipped; realign=t recovers it."""
    write_fasta(str(tmp_path / "ref.fa"), random_genome(5_000, 1, seed=77))
    ref = load_reference(str(tmp_path / "ref.fa"))
    codes = ref.scaffold_codes(0)
    rows = []
    for i in range(10):
        start = 1950 - i * 4
        read = np.concatenate([codes[start:2000],
                               codes[2003 : 2003 + (100 - (2000 - start))]])
        n_pre = 2000 - start
        rows.append([b"r%d" % i, b"0", ref.names[0].split()[0], str(start + 1).encode(),
                     b"40", b"%d=%dS" % (n_pre, 100 - n_pre), b"*", b"0", b"0",
                     CODE_TO_BASE[np.minimum(read, 4)].tobytes(), b"F" * 100])
    _write_sam(tmp_path / "mis.sam", ref, rows)
    args = [f"in={tmp_path / 'mis.sam'}", f"ref={tmp_path / 'ref.fa'}", "minreads=2",
            "minscore=0", "realign=t"]
    tool, jtool, _ = run_both(tmp_path, "mis", args)
    assert tool.realigned == jtool.realigned >= 8
    assert any(v.type == tcv.DEL and v.start == 2000 and v.reflen() == 3
               for v in tool.varmap.values())


def test_multisample_equal_jax(tmp_path):
    """test_multisample_vcf: two samples, one SNP each."""
    write_fasta(str(tmp_path / "ref.fa"), random_genome(3_000, 1, seed=88))
    ref = load_reference(str(tmp_path / "ref.fa"))
    codes = ref.scaffold_codes(0)
    for name, var_pos in (("s1", 1000), ("s2", 2000)):
        rows = []
        for i in range(6):
            start = var_pos - 50 + i * 3
            read = codes[start : start + 100].copy()
            read[var_pos - start] = (read[var_pos - start] + 1) % 4
            rows.append([b"r%d" % i, b"0", ref.names[0].split()[0], str(start + 1).encode(),
                         b"40", b"%d=1X%d=" % (var_pos - start, 99 - (var_pos - start)),
                         b"*", b"0", b"0", CODE_TO_BASE[np.minimum(read, 4)].tobytes(),
                         b"F" * 100])
        _write_sam(tmp_path / f"{name}.sam", ref, rows)
    run_both(tmp_path, "multi", [f"in={tmp_path / 's1.sam'},{tmp_path / 's2.sam'}",
                                 f"ref={tmp_path / 'ref.fa'}", "multisample=t",
                                 "minscore=0", "minreads=2"])
    text = (tmp_path / "multi.torch.vcf").read_text()
    assert text.splitlines()[[l.startswith("#CHROM") for l in text.splitlines()].index(True)
                             ].split("\t")[-2:] == ["s1", "s2"]


def test_junctions_equal_jax(tmp_path):
    """test_junction_variants: reads with a 30 bp foreign tail."""
    g = random_genome(2000, seed=44)
    write_fasta(str(tmp_path / "ref.fa"), g)
    seq = g[0][1]
    foreign = CODE_TO_BASE[np.random.default_rng(7).integers(0, 4, 30).astype(np.uint8)].tobytes()
    lines = [b"@SQ\tSN:scaffold_0\tLN:2000"]
    for i in range(6):
        lines.append(b"r%d\t0\tscaffold_0\t501\t60\t70M30S\t*\t0\t0\t%s\t%s"
                     % (i, seq[500:570] + foreign, b"I" * 100))
    (tmp_path / "in.sam").write_bytes(b"\n".join(lines) + b"\n")
    for flag in ("junctions=t", "junctions=f"):
        run_both(tmp_path, f"j_{flag[-1]}", [f"in={tmp_path / 'in.sam'}",
                                            f"ref={tmp_path / 'ref.fa'}", flag,
                                            "minscore=0", "minreads=2"])
    assert b"TYP=RJUNCT" in (tmp_path / "j_t.torch.vcf").read_bytes()


def test_invcf_forced_equal_jax(mapped, tmp_path):
    """test_invcf_forced_variants: rows of a first pass's VCF, fed back
    with invcf=, are forced through with their evidence merged."""
    first = mapped / "cli_default.jax.vcf"
    if not first.exists():
        jcv.main([f"in={mapped / 'm.sam'}", f"ref={mapped / 'ref.fa'}", f"vcf={first}"])
    rows = [l for l in first.read_text().splitlines() if not l.startswith("#")]
    fails = [l for l in rows if l.split("\t")[6] == "FAIL"][:5]
    assert fails
    with open(tmp_path / "force.vcf", "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for l in fails:
            fh.write("\t".join(l.split("\t")[:8]) + "\n")
        fh.write("scaffold_0\t77\t.\tA\tACC\t.\t.\t.\n")  # an insertion nobody saw
    tool, jtool, _ = run_both(tmp_path, "forced", [
        f"in={mapped / 'm.sam'}", f"ref={mapped / 'ref.fa'}",
        f"invcf={tmp_path / 'force.vcf'}"])
    assert sum(v.forced for v in tool.varmap.values()) == sum(
        v.forced for v in jtool.varmap.values()) >= len(fails)


def _clip_indels(src, dst):
    """SAM src to dst with each record whose CIGAR holds an insertion or a
    deletion after an aligned op soft-clipped from that indel on (the
    reads bbrealign exists for). Returns how many were clipped."""
    import re

    clipped = 0
    with open(src, "rb") as fi, open(dst, "wb") as fo:
        for line in fi:
            if not line.startswith(b"@"):
                f = line.split(b"\t")
                ops = re.findall(rb"(\d+)([MIDNSHP=X])", f[5])
                cut = next((i for i, (_, op) in enumerate(ops) if op in b"ID"), None)
                if cut is not None and any(op in b"M=X" for _, op in ops[:cut]):
                    tail = sum(int(x) for x, op in ops[cut:] if op in b"MIS=X")
                    f[5] = b"".join(x + op for x, op in ops[:cut]) + b"%dS" % tail
                    line = b"\t".join(f)
                    clipped += 1
            fo.write(line)
    return clipped


def _bbrealign_both(tmp, sam, ref):
    """`bbrealign` in both packages; returns each one's (realigned,
    total) and output bytes."""
    from bbtools_torch.models.bbrealign import main as trealign
    from bbtools_tpu.models.bbrealign import main as jrealign

    res = {}
    for pkg, main in (("jax", jrealign), ("torch", trealign)):
        out = tmp / f"realigned.{pkg}.sam"
        argv = [f"in={sam}", f"ref={ref}", f"out={out}"]
        counts = main(argv + (["device=cpu"] if pkg == "torch" else []))
        res[pkg] = (counts, out.read_bytes())
    return res


def test_bbrealign_equals_jax_on_clipped_indels(mapped, tmp_path):
    clipped = _clip_indels(mapped / "m.sam", tmp_path / "clip.sam")
    res = _bbrealign_both(tmp_path, tmp_path / "clip.sam", mapped / "ref.fa")
    assert res["torch"] == res["jax"]
    realigned, total = res["torch"][0]
    assert clipped > 20 and total >= 1100 and realigned >= clipped // 2
    # through the CLI name as well
    out = tmp_path / "cli.sam"
    assert tmain(["bbrealign", f"in={tmp_path / 'clip.sam'}", f"ref={mapped / 'ref.fa'}",
                  f"out={out}", "device=cpu"]) == 0
    assert out.read_bytes() == res["jax"][1]


def test_bbrealign_sloppy_record_equals_jax(tmp_path):
    """tests/test_longtail3.py's case: a read of ref[100:160] written at
    the wrong position with a noisy CIGAR is moved to 101, 60=."""
    rng = np.random.default_rng(3)
    ref = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 400))
    (tmp_path / "ref.fa").write_bytes(b">c\n" + ref + b"\n")
    seg = ref[100:160]
    (tmp_path / "in.sam").write_bytes(
        b"@SQ\tSN:c\tLN:400\n"
        b"r\t0\tc\t95\t10\t20S40M\t*\t0\t0\t" + seg + b"\t" + b"I" * 60 + b"\n")
    res = _bbrealign_both(tmp_path, tmp_path / "in.sam", tmp_path / "ref.fa")
    assert res["torch"] == res["jax"]
    assert res["torch"][0] == (1, 1)
    f = res["torch"][1].splitlines()[1].split(b"\t")
    assert int(f[3]) == 101 and f[5] == b"60="
