"""The port's Tadpole against the JAX package's on the CPU, on the cases
of tests/test_tadpole.py: `python -m bbtools_torch tadpole ...
device=cpu` writes contigs (k=31, 62, 93) byte-equal to `python -m
bbtools_tpu tadpole ...`, and `second_highest_position` and the
reassemble-only correction equal the JAX package's. The read modes and
shave/rinse are in tests/test_torch_tadpole_modes.py."""

import numpy as np
import pytest

from bbtools_torch.cli import main as tmain
from bbtools_torch.models import tadpole as tt
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.io.fasta import load_reference, write_fasta
from bbtools_tpu.models import tadpole as jt
from bbtools_tpu.utils.synth import random_genome, random_reads, write_reads

ACGT = np.frombuffer(b"ACGT", np.uint8)
#: reads of 100 bp in every k <= 31 case of this file: the JAX package's
#: CPU count runs its k-mer ops eagerly, compiling them for each new
#: batch shape, so one shape compiles once
N_READS = 800


def run_both(tmp, tag, args, out_ext="fa"):
    """Run `tadpole` in both packages; return the port's tool and output
    bytes, asserting them equal to the JAX package's."""
    files = {}
    tools = {}
    for pkg, main in (("jax", jmain), ("torch", tmain)):
        out = tmp / f"{tag}.{pkg}.{out_ext}"
        argv = ["tadpole", *args, f"out={out}"]
        if pkg == "torch" and tag.startswith("cli"):
            assert tmain(argv + ["device=cpu"]) == 0
        elif pkg == "torch":
            tools[pkg] = tt.main(argv[1:] + ["device=cpu"])
        else:
            tools[pkg] = jt.main(argv[1:])
        files[pkg] = out.read_bytes()
    assert files["torch"] == files["jax"]
    return tools.get("torch"), tools["jax"], files["torch"]


def test_second_highest_position_matches_jax():
    a = np.random.default_rng(1).integers(0, 100, (500, 4)).astype(np.int64)
    a[::5, 1] = a[::5, 0]  # ties
    np.testing.assert_array_equal(tt.second_highest_position(a),
                                  jt.second_highest_position(a))


def _genome_reads(tmp, glen, gseed, n, read_len, rseed, **kw):
    write_fasta(str(tmp / "g.fa"), random_genome(glen, n_scaffolds=1, seed=gseed))
    ref = load_reference(str(tmp / "g.fa"))
    write_reads(str(tmp / "reads.fq"), random_reads(ref, n, read_len=read_len,
                                                    seed=rseed, **kw))
    return str(tmp / "reads.fq")


#: the cases of test_assemble_simple_genome, test_assemble_bigk and
#: test_assemble_k93_exact_words at a fifth to a quarter of their genome
#: lengths and read counts (the same depth): the host walk's steps grow
#: with the longest contig, and each case runs twice. The k=31 case runs
#: the port through `python -m bbtools_torch tadpole`.
@pytest.mark.parametrize("k,glen,gseed,n,read_len", [
    (31, 4_000, 5, N_READS, 100),
    (62, 3_000, 42, 600, 120),
    (93, 3_000, 77, 600, 150),
])
def test_contigs_equal_jax(tmp_path, k, glen, gseed, n, read_len):
    fq = _genome_reads(tmp_path, glen, gseed, n, read_len, gseed + 1, snp_rate=0.0)
    tag = "cli31" if k == 31 else f"k{k}"
    tool, jtool, out = run_both(tmp_path, tag, [f"in={fq}", f"k={k}"])
    if tool is not None:
        assert tool.contigs == jtool.contigs and tool.cov == jtool.cov
        assert tool.reads_in == n
    assert sum(len(c) for c in jtool.contigs) > 0.75 * glen
    assert out.count(b">") == len(jtool.contigs)


def test_contigs_with_errors_equal_jax(tmp_path):
    """Reads with substitutions: error k-mers, tips and bubbles in the
    graph, at k=31 and k=62."""
    fq = _genome_reads(tmp_path, 3_000, 9, N_READS, 100, 10, snp_rate=0.01)
    for k in (31, 62):
        run_both(tmp_path, f"err{k}", [f"in={fq}", f"k={k}", "mincount=2"])


def test_branch_stops_equal_jax(tmp_path):
    """test_branch_stops: two scaffolds sharing a 60 bp core."""
    rng = np.random.default_rng(8)
    parts = [ACGT[rng.integers(0, 4, n)].tobytes() for n in (60, 400, 400, 400, 400)]
    core, left1, left2, right1, right2 = parts
    write_fasta(str(tmp_path / "g.fa"),
                [(b"a", left1 + core + right1), (b"b", left2 + core + right2)])
    ref = load_reference(str(tmp_path / "g.fa"))
    write_reads(str(tmp_path / "reads.fq"),
                random_reads(ref, N_READS, read_len=100, snp_rate=0.0, seed=9))
    tool, _, _ = run_both(tmp_path, "branch", [f"in={tmp_path / 'reads.fq'}", "k=31",
                                                "mincontig=100"])
    assert len(tool.contigs) >= 2


def test_ecc_reassemble_only_matches_jax():
    """test_ecc_reassemble_only on the port's engine and table."""
    from bbtools_torch.models.tadpole_ecc import EccConfig, EccEngine
    from bbtools_torch.ops.kmer_count import KmerSpectrum, count_batch_np

    rng = np.random.default_rng(41)
    genome = rng.integers(0, 4, 4000).astype(np.uint8)
    reads = np.stack([genome[s : s + 100] for s in range(0, 3000, 10)])
    v, c = count_batch_np(reads, np.full(len(reads), 100, np.int64), 31)
    spec = KmerSpectrum(31)
    spec.add_batch(v, c * 5)
    spec.flush()
    eng = EccEngine(tt.SpectrumTable(spec, 31), 31,
                    EccConfig(pincer=False, tail=False, reassemble=True, rollback=False))
    codes = genome[500:600].copy()
    codes[50] = (codes[50] + 2) % 4
    assert eng.correct_read(codes, None) >= 1
    assert (codes == genome[500:600]).all()
