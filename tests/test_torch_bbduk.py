"""The slice end to end: `bbduk` of the port on device=cpu against the JAX
package's `bbduk` on the same seeded FASTQ, byte for byte (output FASTQ
and stats file).

On the CPU the JAX package takes the bucket backend for every panel
here, while the port takes the panel's GPU backend (the sorted join for
ref=adapters, the lane table for one adapter), so these runs also hold
the port's join and lane paths against an independent backend."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from bbtools_torch.cli import main as torch_main
from bbtools_torch.models.bbduk import build_index, parse_args
from bbtools_torch.ops.lane_index import LaneKmerIndex
from bbtools_torch.ops.sort_join import SortJoinIndex
from bbtools_tpu.cli import main as jax_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPTER = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
COMMON = ["k=23", "mink=11", "hdist=1", "ktrim=r", "minlen=40"]
LITERAL = [f"literal={ADAPTER.decode()}"]


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """300 reads of 20-151 bp with Ns, low-quality tails, adapter tails
    from random positions and short adapter prefixes at the read end."""
    rng = np.random.default_rng(17)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(300):
        L = int(rng.integers(20, 152))
        seq = acgt[rng.integers(0, 4, L)].copy()
        if i % 3 == 0 and L > 30:
            p = int(rng.integers(10, L - 5))
            ins = np.frombuffer(ADAPTER[: L - p], np.uint8)
            seq[p : p + len(ins)] = ins
        elif i % 3 == 1:
            m = min(L, int(rng.integers(11, 22)))
            seq[L - m :] = np.frombuffer(ADAPTER[:m], np.uint8)
        if i % 4 == 0:
            seq[rng.integers(0, L)] = ord("N")
        q = (33 + rng.integers(2, 41, L)).astype(np.uint8)
        if i % 5 == 0:
            q[-int(rng.integers(1, L)) :] = 35
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), q.tobytes()))
    path = tmp_path_factory.mktemp("reads") / "in.fq.gz"
    with gzip.open(path, "wb") as fh:
        fh.write(b"".join(recs))
    return str(path)


def _outputs(tmp_path, tag, runner, fq, flags):
    out = tmp_path / f"{tag}.fq"
    stats = tmp_path / f"{tag}.stats.txt"
    runner(["bbduk", f"in={fq}", f"out={out}", f"stats={stats}", *flags])
    return out.read_bytes(), stats.read_bytes()


def _torch_cpu(argv):
    torch_main(argv + ["device=cpu"])


def test_config1_cli_matches_jax(tmp_path, reads):
    """Config #1 (ref=adapters ... minlen=40) through `python -m
    bbtools_torch`, the user's entry point."""
    flags = ["ref=adapters"] + COMMON

    def subprocess_cli(argv):
        subprocess.run(
            [sys.executable, "-m", "bbtools_torch", *argv, "device=cpu"],
            cwd=REPO, check=True, capture_output=True,
        )

    want = _outputs(tmp_path, "jax", jax_main, reads, flags)
    got = _outputs(tmp_path, "torch", subprocess_cli, reads, flags)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert b"#Matched\t0\t" not in got[1]


@pytest.mark.parametrize("extra", [
    [],  # the 1-adapter configuration
    ["qtrim=rl", "trimq=12"],
    ["ktrim=n"],  # kmask
    ["ktrim=f", "minkmerhits=2"],  # kfilter
    ["ktrim=l", "mink=0", "entropy=0.6", "maxns=0"],
])
def test_one_adapter_matches_jax(tmp_path, reads, extra):
    flags = LITERAL + COMMON + extra
    want = _outputs(tmp_path, "jax", jax_main, reads, flags)
    got = _outputs(tmp_path, "torch", _torch_cpu, reads, flags)
    assert got[0] == want[0]
    assert got[1] == want[1]
    with gzip.open(reads) as fh:
        assert got[0] != fh.read()  # the stage changed the reads


@pytest.mark.parametrize("flags,backend", [
    (["ref=adapters"] + COMMON, SortJoinIndex),
    (LITERAL + COMMON, LaneKmerIndex),
])
def test_backend_follows_the_panel(flags, backend):
    index, _, _ = build_index(parse_args(flags + ["device=cpu"]))
    assert isinstance(index, backend)


@pytest.mark.parametrize("panel", [
    [ADAPTER],
    [ADAPTER, b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT",
     b"CTGTCTCTTATACACATCTCCGAGCCCACGAGAC"],
])
def test_ktrim_matches_transliterated_oracle(panel):
    """Config #1's ktrim=r, k=23, mink=11, hdist=1 read by read against
    the per-read transliteration of BBDukProcessorS.ktrim
    (bbtools_tpu/models/bbduk_oracle.py)."""
    from bbtools_torch.io.batch import ReadBatch
    from bbtools_torch.models.bbduk import BBDuk
    from bbtools_tpu.core.dna import encode
    from bbtools_tpu.models import bbduk_oracle as oracle
    from bbtools_tpu.ops.kmer_index import build_ref_keys

    rng = np.random.default_rng(len(panel))
    B, L = 120, 100
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    reads[rng.random((B, L)) < 0.01] = 4
    for i in range(0, B, 2):
        a = encode(panel[i % len(panel)])
        frag = a if i % 4 == 0 else a[: int(rng.integers(5, len(a)))]
        pos = L - len(frag) if i % 3 else int(rng.integers(20, L - len(frag)))
        reads[i, pos : pos + len(frag)] = frag
        if i % 6 == 0:  # one mismatch: found through the hdist=1 keys
            reads[i, pos + len(frag) // 2] = (reads[i, pos + len(frag) // 2] + 1) % 4
    lengths = np.full(B, L, np.int32)
    cfg = parse_args(
        ["literal=" + ",".join(s.decode() for s in panel)] + COMMON[:-1]
        + ["minlen=10", "device=cpu"]
    )
    duk = BBDuk(cfg)
    batch = ReadBatch(bases=reads.copy(), quals=np.full((B, L), 30, np.uint8),
                      lengths=lengths.copy(), ids=[b"r%d" % i for i in range(B)])
    b1, _, keep, _, _ = duk.process_pair(batch, None)
    table = dict(zip(*(x.tolist() for x in build_ref_keys(
        [encode(s) for s in panel], 23, mink=11, hdist=1))))
    trimmed = 0
    for i in range(B):
        found, _, a, b = oracle.ktrim(reads[i], table, 23, 11,
                                      ktrim_left=False, ktrim_right=True)
        exp_len = L if found == 0 else b - a + 1
        assert keep[i] == (exp_len >= 10), i
        if keep[i]:
            assert b1.lengths[i] == exp_len, i
        trimmed += exp_len < L
    assert trimmed >= B // 3
