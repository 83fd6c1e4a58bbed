"""DecontaminateByNormalization (`decontaminate`, `crossblock`) and
`summarizecrossblock` on the CPU: the port's pipeline, BBMap
(ambig=random), bbnorm and Tadpole on device=cpu, against the JAX
package's on tests/test_decontaminate.py's libraries. The clean and dirty
FASTA, both passes' covstats and the results log are equal byte for
byte, and the planted contaminant is removed from the library it does
not belong to."""

import os

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as tmain
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.core.dna import CODE_TO_BASE


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(n, seed):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)


def _seq(codes):
    return CODE_TO_BASE[np.minimum(codes, 4)].tobytes()


def _tile_reads(codes, depth, read_len, prefix, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(max(1, int(depth * len(codes) / read_len))):
        start = int(rng.integers(0, len(codes) - read_len + 1))
        out.append(b"@%s_%d\n%s\n+\n%s\n"
                   % (prefix, i, _seq(codes[start: start + read_len]), b"I" * read_len))
    return b"".join(out)


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    """tests/test_decontaminate.py's two libraries: each assembly holds
    its own contig and a contaminant contig that is deep only in B's
    reads."""
    tmp = tmp_path_factory.mktemp("decon")
    a, b, contam = _codes(600, 11), _codes(600, 12), _codes(600, 13)
    (tmp / "libA.fa").write_bytes(b">contigA\n%s\n>contamS\n%s\n" % (_seq(a), _seq(contam)))
    (tmp / "libB.fa").write_bytes(b">contigB\n%s\n>contamS\n%s\n" % (_seq(b), _seq(contam)))
    (tmp / "libA.fq").write_bytes(_tile_reads(a, 50, 100, b"a", 1)
                                  + _tile_reads(contam, 3, 100, b"ac", 2))
    (tmp / "libB.fq").write_bytes(_tile_reads(b, 50, 100, b"b", 3)
                                  + _tile_reads(contam, 50, 100, b"bc", 4))
    return tmp


OUTS = ["libA_clean.fasta", "libA_dirty.fasta", "libB_clean.fasta", "libB_dirty.fasta",
        "libA_covstats0.txt", "libB_covstats0.txt", "libA_covstats1.txt",
        "libB_covstats1.txt", "results.txt"]


@pytest.mark.parametrize("tool,flags", [
    ("decontaminate", []),
    ("crossblock", ["ecct=t", "kt=31"]),
    ("decontaminate", ["mapraw=f", "basesundermin=100", "window=100"]),
], ids=["defaults", "crossblock_ecct", "no_raw_map_window"])
def test_decontaminate_equals_jax(libraries, tmp_path, tool, flags):
    tmp = libraries
    argv = [f"reads={tmp}/libA.fq,{tmp}/libB.fq", f"ref={tmp}/libA.fa,{tmp}/libB.fa",
            "minl=200", "minr=18", "target=20", "mindepth=2", *flags]
    for tag, cli, extra in (("jax", jmain, []), ("torch", tmain, ["device=cpu"])):
        cli([tool, *argv, f"out={tmp_path}/{tag}", *extra])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == names
    assert set(OUTS) - (set() if "mapraw=f" not in flags else
                        {"libA_covstats0.txt", "libB_covstats0.txt"}) <= set(names)
    for name in names:
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    clean = (tmp_path / "torch" / "libA_clean.fasta").read_bytes()
    dirty = (tmp_path / "torch" / "libA_dirty.fasta").read_bytes()
    assert b">contigA" in clean
    if "mapraw=f" not in flags:
        assert b">contamS" in dirty and b">contamS" not in clean
        assert b">contamS" in (tmp_path / "torch" / "libB_clean.fasta").read_bytes()


def test_summarizecrossblock_equals_jax(tmp_path):
    rows = [b"#assembly\tcontig\tcontam\tlength\tavgFold0\tavgFold1\n",
            b"a.fa\tc1\t0\t1200\t10.00\t8.00\n", b"a.fa\tc2\t1\t800\t3.00\t0.10\n"]
    (tmp_path / "r1.txt").write_bytes(b"".join(rows))
    (tmp_path / "r2.txt").write_bytes(b"".join(rows[:2]))
    (tmp_path / "list.txt").write_text(f"{tmp_path}/r1.txt\n{tmp_path}/r2.txt\n"
                                       f"{tmp_path}/missing.txt\n")
    for src in (f"{tmp_path}/r1.txt,{tmp_path}/r2.txt", f"{tmp_path}/list.txt"):
        for tag, cli in (("jax", jmain), ("torch", tmain)):
            cli(["summarizecrossblock", f"in={src}", f"out={tmp_path}/{tag}.txt"])
        got = (tmp_path / "torch.txt").read_bytes()
        assert got == (tmp_path / "jax.txt").read_bytes()
        assert got.splitlines()[1].endswith(b"\t1\t2\t1\t2000\t800")
