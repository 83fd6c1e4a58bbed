"""The port's Seal (`models/seal.py`) against the JAX package's on the
CPU: `python -m bbtools_torch seal ... device=cpu` writes the same
refstats file, the same per-reference FASTQs and returns the same
counts as `python -m bbtools_tpu seal`, in tests/test_tools.py's cases
(two references, shared k-mers under ambig=all and ambig=toss, 40
reference files) and with 63 reference files (two 62-bit words a
combo); the votes and verdicts of `seal_votes` and `seal_best` equal
the JAX package's host loop."""

import contextlib
import io

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as tmain
from bbtools_torch.models import seal as tseal
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.core.dna import CODE_TO_BASE
from bbtools_tpu.io.fasta import load_reference, write_fasta
from bbtools_tpu.utils.synth import random_genome, random_reads, write_reads


def _run(fn, argv):
    with contextlib.redirect_stderr(io.StringIO()):
        return fn(argv)


def _both(tmp, argv, outs):
    """Run argv through both packages (outputs named {d}), compare the
    returns and every output file's bytes."""
    res = {}
    for d, fn, extra in (("jax", jmain, []), ("torch", tmain, ["device=cpu"])):
        res[d] = _run(fn, ["seal", *[x.format(d=d) for x in argv], *extra])
        res[d + "_files"] = [(tmp / o.format(d=d)).read_bytes() if (tmp / o.format(d=d)).exists()
                             else None for o in outs]
    assert res["jax_files"] == res["torch_files"]
    return res["torch_files"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seal")
    genome = random_genome(30_000, n_scaffolds=2, seed=13)
    write_fasta(str(tmp / "ref.fa"), genome)
    ref = load_reference(str(tmp / "ref.fa"))
    write_reads(str(tmp / "reads.fq"),
                random_reads(ref, 500, read_len=100, snp_rate=0.01, seed=14))
    write_fasta(str(tmp / "refA.fa"), [genome[0]])
    write_fasta(str(tmp / "refB.fa"), [genome[1]])
    return tmp


@pytest.mark.parametrize("flags", [[], ["ambig=toss", "mkh=3"], ["ambig=all"]])
def test_seal_two_refs_equals_jax(data, flags):
    tmp = data
    files = _both(tmp, [f"in={tmp}/reads.fq", f"ref={tmp}/refA.fa,{tmp}/refB.fa",
                        f"stats={tmp}/st.{{d}}.txt", "k=31", f"pattern={tmp}/o_{{d}}_%.fq",
                        *flags],
                  ["st.{d}.txt", "o_{d}_refA.fq", "o_{d}_refB.fq"])
    rows = [ln.split("\t") for ln in files[0].decode().splitlines()[1:]]
    assert int(rows[0][1]) + int(rows[1][1]) >= (490 if not flags else 400)
    assert files[1] and files[2]


def _shared_refs(tmp):
    """tests/test_tools.py's multi-valued case: refs A and B share a
    200 bp region; reads from it, from A only and from B only."""
    rng = np.random.default_rng(41)
    shared, a_only, b_only = (rng.integers(0, 4, 200).astype(np.uint8) for _ in range(3))
    for name, codes in ((b"a", np.concatenate([a_only, shared])),
                        (b"b", np.concatenate([shared, b_only]))):
        (tmp / f"{name.decode()}.fa").write_bytes(
            b">" + name.upper() + b"\n" + CODE_TO_BASE[codes].tobytes() + b"\n")
    with open(tmp / "r.fq", "wb") as fh:
        for n, c in ((b"shared", shared[50:150]), (b"aonly", a_only[50:150]),
                     (b"bonly", b_only[50:150])):
            s = CODE_TO_BASE[c].tobytes()
            fh.write(b"@" + n + b"\n" + s + b"\n+\n" + b"F" * len(s) + b"\n")


@pytest.mark.parametrize("ambig", ["all", "toss", "first"])
def test_seal_shared_kmers_equals_jax(tmp_path, ambig):
    _shared_refs(tmp_path)
    files = _both(tmp_path, [f"in={tmp_path}/r.fq", f"ref={tmp_path}/a.fa,{tmp_path}/b.fa",
                             f"pattern={tmp_path}/s_{{d}}_%.fq", f"ambig={ambig}", "k=31",
                             f"stats={tmp_path}/st.{{d}}.txt"],
                  ["s_{d}_a.fq", "s_{d}_b.fq", "st.{d}.txt"])
    a_out, b_out = (f.splitlines()[::4] if f else [] for f in files[:2])
    if ambig == "all":
        assert b"@shared" in a_out and b"@shared" in b_out
    elif ambig == "toss":
        assert b"@shared" not in a_out + b_out and b"@aonly" in a_out


@pytest.mark.parametrize("n_refs", [40, 63])
def test_seal_many_reference_files_equals_jax(tmp_path, n_refs):
    """40 files (tests/test_tools.py) and 63, whose last reference's bit
    lies in the combo's second word; each read credits its source, and
    some k-mers are shared by a reference of each word."""
    rng = np.random.default_rng(55)
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    seqs = [ACGT[rng.integers(0, 4, 400)].tobytes() for _ in range(n_refs)]
    seqs[-1] = seqs[-1][:200] + seqs[0][:200]  # shared with ref 0
    for r, seq in enumerate(seqs):
        (tmp_path / f"ref{r:02d}.fa").write_bytes(b">r%d\n%s\n" % (r, seq))
    recs = []
    for i in range(3 * n_refs):
        src = i % n_refs
        start = int(rng.integers(0, 300))
        recs.append(b"@q%d_src%d\n%s\n+\n%s\n" % (i, src, seqs[src][start:start + 100],
                                                   b"I" * 100))
    (tmp_path / "reads.fq").write_bytes(b"".join(recs))
    refs = ",".join(str(tmp_path / f"ref{r:02d}.fa") for r in range(n_refs))
    files = _both(tmp_path, [f"in={tmp_path}/reads.fq", f"ref={refs}",
                             f"stats={tmp_path}/st.{{d}}.txt", "k=31"], ["st.{d}.txt"])
    rows = [ln.split(b"\t") for ln in files[0].splitlines()[1:-1]]
    assert len(rows) == n_refs and sum(int(r[1]) for r in rows) >= 3 * n_refs - 3


def test_seal_votes_equal_the_host_loop():
    """seal_votes/seal_best against the JAX package's per-reference host
    loop on random combo ids over 70 references (W = 2)."""
    rng = np.random.default_rng(7)
    nref, W = 70, 2
    combo = rng.integers(0, 1 << 62, (40, W), dtype=np.int64)
    combo[:, 1] &= (1 << (nref - 62)) - 1
    combo[0] = 0
    ids = rng.integers(0, 40, (64, 50)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.5] = 0
    votes = tseal.seal_votes(torch.from_numpy(combo), torch.from_numpy(ids), nref).numpy()
    want = np.zeros((nref + 1, 64), np.int64)
    for rid in range(1, nref + 1):
        w, bit = (rid - 1) // 62, (rid - 1) % 62
        want[rid] = ((combo[ids, w] >> np.int64(bit)) & 1).sum(axis=1)
    np.testing.assert_array_equal(votes, want)
    for mkh, toss in ((1, False), (12, True), (40, False)):
        best_votes = want[1:].max(axis=0)
        best = np.where(best_votes >= mkh, want[1:].argmax(axis=0) + 1, 0)
        if toss:
            n_top = (want[1:] == best_votes[None, :]).sum(axis=0)
            best = np.where((n_top > 1) & (best > 0), 0, best)
        np.testing.assert_array_equal(
            tseal.seal_best(torch.from_numpy(votes), mkh, toss).numpy(), best)
    assert tseal.seal_votes.device_calls == 0
