"""The port's BBMap against the JAX package's on the CPU, single end:
`python -m bbtools_torch bbmap ... device=cpu` writes every output file
byte-equal to `python -m bbtools_tpu bbmap ...` on the same reference
and reads, but for the program name of the SAM header's @PG line."""

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as tmain
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.io.fasta import load_reference, write_fasta
from bbtools_tpu.utils.synth import random_genome, random_reads, write_reads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU runs: the suite runs several
    test processes on shared cores, where torch's thread pool, woken at
    each of the plain fill's many small ops, stalls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A seeded 150 kb genome of two scaffolds; 300 reads of 151 bp with
    1% substitutions and 1-10 bp indels in 5% of them; 96 reads with
    indels in 60%, for the walk-cap overflow."""
    tmp = tmp_path_factory.mktemp("tbbmap")
    write_fasta(str(tmp / "ref.fa"), random_genome(150_000, n_scaffolds=2, seed=7))
    ref = load_reference(str(tmp / "ref.fa"))
    write_reads(str(tmp / "r.fq"), random_reads(
        ref, 300, read_len=151, snp_rate=0.01, indel_rate=0.05,
        indel_range=(1, 10), seed=3))
    write_reads(str(tmp / "indel.fq"), random_reads(
        ref, 96, read_len=151, snp_rate=0.01, indel_rate=0.6,
        indel_range=(1, 10), seed=4))
    return tmp


def run_both(tmp, tag, args, outs):
    """Run both tools with `args` plus out files named by `outs`; return
    the port's BBMap and its files' bytes, asserting them equal to the
    JAX package's."""
    from bbtools_torch.models import bbmap as tbbmap

    files = {}
    tool = None
    for pkg in ("jax", "torch"):
        paths = {k: tmp / f"{tag}.{pkg}.{ext}" for k, ext in outs.items()}
        argv = [*args, *(f"{k}={p}" for k, p in paths.items())]
        if pkg == "jax":
            jmain(["bbmap", *argv])
        elif tag == "default":
            assert tmain(["bbmap", *argv, "device=cpu"]) == 0
        else:
            # the main the CLI calls, which hands back the tool
            tool = tbbmap.main([*argv, "device=cpu"])
        files[pkg] = {k: p.read_bytes() for k, p in paths.items()}
    for k in outs:
        want = files["jax"][k]
        if outs[k].endswith("sam"):
            assert want.count(b"bbtools_tpu") == 2  # @PG ID and PN
            want = want.replace(b"bbtools_tpu", b"bbtools_torch")
        assert files["torch"][k] == want, k
    return tool, files["torch"]


CASES = {
    "default": ([], {"out": "sam"}),
    "fused_f": (["fused=f"], {"out": "sam"}),
    "local_sam13_intron": (["local=t", "sam=1.3", "intronlen=10"], {"out": "sam"}),
    "outu_outm": ([], {"out": "sam", "outu": "u.fq", "outm": "m.fq"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bbmap_equals_jax(data, case):
    flags, outs = CASES[case]
    args = [f"ref={data / 'ref.fa'}", f"in={data / 'r.fq'}", *flags]
    tool, files = run_both(data, case, args, outs)
    sam = files["out"]
    assert sam.count(b"\n") == 300 + 4  # @HD, two @SQ, @PG
    if tool is not None:
        assert tool.reads_mapped >= 295
        assert tool.fused_overflows == 0
    if case == "default":
        # indel reads align through the fill and the walk
        cigars = [ln.split(b"\t")[5] for ln in sam.splitlines() if not ln.startswith(b"@")]
        assert sum(b"I" in c or b"D" in c for c in cigars) >= 5
    if case == "outu_outm":
        assert files["outm"].count(b"\n") == 4 * tool.reads_mapped
        assert files["outu"].count(b"\n") == 4 * tool.reads_unmapped


def test_bbmap_walk_cap_overflow_equals_jax(data):
    """Batches of 32 reads cap the walked winners at 8; more indel reads
    than that send each batch back through the staged path."""
    args = [f"ref={data / 'ref.fa'}", f"in={data / 'indel.fq'}", "batchreads=32"]
    tool, files = run_both(data, "overflow", args, {"out": "sam"})
    assert tool.fused_overflows >= 2
    assert tool.reads_mapped >= 90
    assert np.sum([b"D" in ln or b"I" in ln for ln in files["out"].splitlines()]) >= 30
