"""The tools around BBMap, the port's against the JAX package's on the
CPU, byte for byte (but for the program name of a SAM's @PG line): BBMap's
inline covstats=/basecov=/covhist=/bincov= and pileup over its SAM,
calctruequality and BBDuk's recalibrate=t, gradesam, bbsplit, bbwrap and
removehuman."""

import contextlib
import io

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as tmain
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.core.dna import CODE_TO_BASE
from bbtools_tpu.io.fasta import load_reference, write_fasta
from bbtools_tpu.utils.synth import random_genome, random_reads, write_reads

COV = ("covstats", "basecov", "covhist", "bincov")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(pkg, argv):
    """One CLI call of either package, its stdout and stderr captured;
    the port's on the CPU."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        if pkg == "jax":
            jmain(argv)
        else:
            tmain([*argv, "device=cpu"])
    return out.getvalue()


def same_sam(tpath, jpath):
    want = jpath.read_bytes()
    assert want.count(b"bbtools_tpu") == 2  # @PG ID and PN
    assert tpath.read_bytes() == want.replace(b"bbtools_tpu", b"bbtools_torch")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_bbmap_modes.py's coverage genome (40 kb, three
    scaffolds); 2,048 reads of 100 bp from it with 2% substitutions,
    qualities 10-40; a second seeded genome of 30 kb holding 2 kb of the
    first (reads there are ambiguous between the two); 300 reads of each
    genome and of random sequence for bbsplit and removehuman."""
    tmp = tmp_path_factory.mktemp("tbbmaptools")
    write_fasta(str(tmp / "ref.fa"), random_genome(40_000, n_scaffolds=3, seed=8))
    ref = load_reference(str(tmp / "ref.fa"))
    rng = np.random.default_rng(21)
    recs = [(n, s, (33 + rng.integers(10, 41, len(s))).astype(np.uint8).tobytes())
            for n, s, _q in random_reads(ref, 2048, read_len=100, snp_rate=0.02,
                                          seed=23)]
    write_reads(str(tmp / "reads.fq"), recs)
    (name, seq), = random_genome(30_000, seed=9)
    shared = CODE_TO_BASE[ref.scaffold_codes(0)[2000:4000]].tobytes()
    write_fasta(str(tmp / "other.fa"), [(b"other", seq[:10_000] + shared + seq[10_000:])])
    other = load_reference(str(tmp / "other.fa"))
    mix = []
    for g, tag in ((ref, b"ref"), (other, b"oth")):
        for n, s, q in random_reads(g, 300, read_len=100, snp_rate=0.01, seed=31):
            mix.append((tag + b"_" + n, s, q))
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for i in range(300):
        mix.append((b"junk%d" % i, acgt[rng.integers(0, 4, 100)].tobytes(), b"F" * 100))
    write_reads(str(tmp / "mix.fq"), mix)
    return tmp


@pytest.fixture(scope="module")
def mapped(data):
    """bbmap over the 2,048 reads with the four coverage outputs, run by
    both packages; the port's outputs already held equal to the JAX
    package's."""
    for pkg in ("jax", "torch"):
        run(pkg, ["bbmap", f"ref={data / 'ref.fa'}", f"in={data / 'reads.fq'}",
                  f"out={data / f'{pkg}.sam'}", "binsize=500",
                  *(f"{c}={data / f'{pkg}.inline.{c}'}" for c in COV)])
    same_sam(data / "torch.sam", data / "jax.sam")
    for c in COV:
        assert (data / f"torch.inline.{c}").read_bytes() == (
            data / f"jax.inline.{c}").read_bytes(), c
    return data


@pytest.mark.parametrize("tool", ["pileup", "coveragepileup", "pileup2"])
def test_inline_coverage_equals_pileup_and_jax(mapped, tool):
    """BBMap's inline coverage equals the JAX package's and a pileup pass
    of either package over the port's SAM (tests/test_bbmap_modes.py's
    check, after AbstractMapper.printOutput -> CoveragePileup)."""
    d = mapped
    for pkg in ("jax", "torch"):
        run(pkg, [tool, f"in={d / 'torch.sam'}", f"ref={d / 'ref.fa'}", "binsize=500",
                  f"out={d / f'{tool}.{pkg}.covstats'}",
                  *(f"{c}={d / f'{tool}.{pkg}.{c}'}" for c in COV[1:])])
        for c in COV:
            got = (d / f"{tool}.{pkg}.{c}").read_bytes()
            assert got == (d / f"torch.inline.{c}").read_bytes(), (pkg, c)
    stats = (d / "torch.inline.covstats").read_bytes().splitlines()
    assert stats[0].startswith(b"#ID\tAvg_fold") and len(stats) == 4
    assert all(float(r.split(b"\t")[4]) > 90 for r in stats[1:])  # covered %


def test_calctruequality_then_recalibrate_equals_jax(mapped, tmp_path):
    """calctruequality over the SAM writes the JAX package's matrices
    (two passes); BBDuk recalibrate=t with them writes its FASTQ."""
    import gzip

    d = mapped
    for pkg in ("jax", "torch"):
        (tmp_path / pkg).mkdir()
        run(pkg, ["calctruequality", f"in={d / 'torch.sam'}", f"path={tmp_path / pkg}"])
        run(pkg, ["bbduk", f"in={d / 'reads.fq'}", f"out={tmp_path / f'{pkg}.fq'}",
                  "recalibrate=t", f"path={tmp_path / pkg}"])
    names = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 7  # qbp, qb012, qb123, qb234, p for pass 0; qbp, p for 1
    for n in names:
        got = gzip.decompress((tmp_path / "torch" / n).read_bytes())
        assert got == gzip.decompress((tmp_path / "jax" / n).read_bytes()), n
        assert got
    got = (tmp_path / "torch.fq").read_bytes()
    assert got == (tmp_path / "jax.fq").read_bytes()
    before = (d / "reads.fq").read_bytes().splitlines()[3::4]
    after = got.splitlines()[3::4]
    assert len(after) == 2048 and after != before


def test_gradesam_equals_jax(mapped):
    reports = [run(pkg, ["gradesam", f"in={mapped / 'torch.sam'}",
                         f"ref={mapped / 'ref.fa'}"]) for pkg in ("jax", "torch")]
    assert reports[0] == reports[1]
    assert "Correct (loose):" in reports[1]
    correct = int(reports[1].split("Correct (loose):")[1].split()[0])
    assert correct >= 0.95 * 2048


@pytest.mark.parametrize("ambig", ["best", "toss"])
def test_bbsplit_equals_jax(data, tmp_path, ambig):
    """bbsplit with two references: the reads of each genome go to its
    file, random reads to outu=, reads of the shared 2 kb by ambiguous2=;
    every file and the refstats table equal the JAX package's."""
    files = {}
    for pkg in ("jax", "torch"):
        run(pkg, ["bbsplit", f"in={data / 'mix.fq'}",
                  f"ref={data / 'ref.fa'},{data / 'other.fa'}",
                  f"basename={tmp_path / pkg}_%.fq", f"outu={tmp_path / pkg}_u.fq",
                  f"refstats={tmp_path / pkg}_stats.txt", f"ambiguous2={ambig}"])
        files[pkg] = {x: (tmp_path / f"{pkg}_{x}").read_bytes()
                      for x in ("ref.fq", "other.fq", "u.fq", "stats.txt")}
    assert files["torch"] == files["jax"]
    names = {x: files["torch"][x].splitlines()[0::4] for x in ("ref.fq", "other.fq", "u.fq")}
    assert sum(n.startswith(b"@ref_") for n in names["ref.fq"]) >= 280
    assert sum(n.startswith(b"@oth_") for n in names["other.fq"]) >= 250
    assert sum(n.startswith(b"@junk") for n in names["u.fq"]) == 300
    if ambig == "toss":
        assert len(names["u.fq"]) > 300


def test_bbwrap_equals_jax_with_one_index(data, tmp_path, monkeypatch):
    """bbwrap maps two inputs to two SAMs with one index build."""
    from bbtools_torch.models import bbmap_index

    builds = []
    build = bbmap_index.SeedIndex.build
    monkeypatch.setattr(bbmap_index.SeedIndex, "build",
                        staticmethod(lambda *a, **k: builds.append(1) or build(*a, **k)))
    for pkg in ("jax", "torch"):
        run(pkg, ["bbwrap", f"ref={data / 'ref.fa'}",
                  f"in={data / 'reads.fq'},{data / 'mix.fq'}",
                  f"out={tmp_path / pkg}.1.sam,{tmp_path / pkg}.2.sam"])
    assert len(builds) == 1
    for i in (1, 2):
        same_sam(tmp_path / f"torch.{i}.sam", tmp_path / f"jax.{i}.sam")
    assert (tmp_path / "torch.2.sam").read_bytes().count(b"\tjunk") == 0
    assert (tmp_path / "torch.2.sam").read_bytes().count(b"\n") == 900 + 5


def test_removehuman_equals_jax(data, tmp_path):
    """removehuman ref=<genome>: reads of the genome go to outm=, the rest
    (the other genome's and random reads) to outu=, with the bloom
    prescreen; without ref= or path= the tool raises, as the JAX
    package's does."""
    for pkg in ("jax", "torch"):
        run(pkg, ["removehuman", f"ref={data / 'ref.fa'}", f"in={data / 'mix.fq'}",
                  f"outm={tmp_path / pkg}.m.fq", f"outu={tmp_path / pkg}.u.fq"])
        with pytest.raises(ValueError, match="requires ref="):
            run(pkg, ["removehuman", f"in={data / 'mix.fq'}"])
    for x in ("m", "u"):
        got = (tmp_path / f"torch.{x}.fq").read_bytes()
        assert got == (tmp_path / f"jax.{x}.fq").read_bytes(), x
    kept = (tmp_path / "torch.m.fq").read_bytes().splitlines()[0::4]
    assert sum(n.startswith(b"@ref_") for n in kept) >= 280
    assert not any(n.startswith(b"@junk") for n in kept)
