"""The port's BBMap against the JAX package's on the CPU: paired input
with mate rescue, secondary sites, the scaffold blacklist, the match and
identity histograms and BAM output. Every output file is byte-equal but
for the program name of the SAM header's @PG line."""

import gzip
import struct

import numpy as np
import pytest
import torch

from bbtools_torch.models import bbmap as tbbmap
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
    """A seeded 150 kb genome of two scaffolds, the first holding a 3 kb
    repeat; 200 pairs of 151 bp (inserts 200-500) whose every fifth r2
    carries a substitution every 10 bases, so that no 13-mer seeds it
    and only mate rescue maps it; 200 reads."""
    tmp = tmp_path_factory.mktemp("tbbmap_pe")
    (n0, s0), (n1, s1) = random_genome(150_000, n_scaffolds=2, seed=8)
    write_fasta(str(tmp / "ref.fa"), [(n0, s0[:40_000] + s0[10_000:13_000] + s0[40_000:]),
                                      (n1, s1)])
    ref = load_reference(str(tmp / "ref.fa"))
    pairs = random_reads(ref, 200, read_len=151, paired=True, insert_range=(200, 500),
                         snp_rate=0.01, indel_rate=0.05, seed=9)
    sub = bytes.maketrans(b"ACGTN", b"CGTAA")
    r2s = []
    for i, (_, (name, seq, q)) in enumerate(pairs):
        if i % 5 == 0:
            seq = b"".join(seq[j : j + 10][:5] + seq[j + 5 : j + 6].translate(sub)
                           + seq[j + 6 : j + 10] for j in range(0, len(seq), 10))
        r2s.append((name, seq, q))
    write_reads(str(tmp / "p1.fq"), [p[0] for p in pairs])
    write_reads(str(tmp / "p2.fq"), r2s)
    write_reads(str(tmp / "r.fq"), random_reads(
        ref, 200, read_len=151, snp_rate=0.01, indel_rate=0.05, seed=11))
    (tmp / "black.txt").write_bytes(n1 + b"\n")
    return tmp


def _bam_payload(path, rename=False):
    """The decompressed BAM stream; with `rename` the header's program
    name becomes the port's, with l_text adjusted."""
    raw = gzip.decompress(path.read_bytes())
    if not rename:
        return raw
    (l_text,) = struct.unpack_from("<i", raw, 4)
    text = raw[8 : 8 + l_text].replace(b"bbtools_tpu", b"bbtools_torch")
    return raw[:4] + struct.pack("<i", len(text)) + text + raw[8 + l_text :]


CASES = {
    "paired_rescue": (["in=p1.fq", "in2=p2.fq"], {"out": "sam"}),
    "secondary_ambig_all": (["in=r.fq", "secondary=t", "ambig=all"], {"out": "sam"}),
    "blacklist_outb": (["in=r.fq", "blacklist=black.txt"], {"out": "sam", "outb": "b.fq"}),
    "mhist_idhist": (["in=p1.fq", "in2=p2.fq"],
                     {"out": "sam", "mhist": "mh.txt", "idhist": "id.txt"}),
    "bam": (["in=r.fq"], {"out": "bam"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bbmap_equals_jax(data, case):
    flags, outs = CASES[case]
    args = [f"ref={data / 'ref.fa'}"] + [
        f"{f.split('=')[0]}={data / f.split('=')[1]}" if f.endswith((".fq", ".txt")) else f
        for f in flags]
    files = {}
    for pkg in ("jax", "torch"):
        paths = {k: data / f"{case}.{pkg}.{ext}" for k, ext in outs.items()}
        argv = [*args, *(f"{k}={p}" for k, p in paths.items())]
        if pkg == "jax":
            jmain(["bbmap", *argv])
        else:
            tool = tbbmap.main([*argv, "device=cpu"])
        files[pkg] = paths
    for k, ext in outs.items():
        got, want = files["torch"][k], files["jax"][k]
        if ext == "bam":
            assert _bam_payload(got) == _bam_payload(want, rename=True)
            assert got.read_bytes()[:4] == b"\x1f\x8b\x08\x04"  # BGZF
        elif ext == "sam":
            assert got.read_bytes() == want.read_bytes().replace(b"bbtools_tpu", b"bbtools_torch")
        else:
            assert got.read_bytes() == want.read_bytes(), k
    sam = files["torch"]["out"]
    if case == "paired_rescue":
        assert tool.rescued >= 20
        assert sam.read_bytes().count(b"\n") == 400 + 4
    if case == "secondary_ambig_all":
        flags_col = [int(ln.split(b"\t")[1]) for ln in sam.read_bytes().splitlines()
                     if not ln.startswith(b"@")]
        assert sum(f & 0x100 != 0 for f in flags_col) >= 3
    if case == "blacklist_outb":
        assert files["torch"]["outb"].read_bytes().count(b"\n") >= 4 * 40
    if case == "mhist_idhist":
        assert files["torch"]["idhist"].read_bytes().count(b"\n") > 100
