"""The port's Dedupe (`models/dedupe.py`) against the JAX package's on
the CPU: `python -m bbtools_torch dedupe ... device=cpu` writes the same
kept, duplicate (outd=) and cluster (pattern=) files and returns the
same counts as `python -m bbtools_tpu dedupe`, in tests/test_tools.py's
cases (exact duplicates, s=2 ac=t, e=2, cluster=t) and on planted
near-duplicates over several batches, where the fuzzy pairs against
earlier batches go through the torch banded edit distance; judge_batch
gives the verdicts of sequential judge() calls."""

import contextlib
import functools
import io

import numpy as np
import pytest

from bbtools_torch.cli import main as tmain
from bbtools_torch.models import dedupe as tdd
from bbtools_torch.ops import banded as tbanded
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.core.dna import CODE_TO_BASE
from bbtools_tpu.io.fasta import load_reference, write_fasta
from bbtools_tpu.models import dedupe as jdd
from bbtools_tpu.utils.synth import random_genome, random_reads, write_reads


def _both(tmp, argv, outs, cli=False):
    """Run argv through both packages (outputs named {d}), through the
    CLI or the module's main; compare the returns and every output
    file's bytes; return (result, files)."""
    res = {}
    mains = (((jmain, []), (tmain, ["device=cpu"])) if cli else
             ((jdd.main, []), (tdd.main, ["device=cpu"])))
    for d, (fn, extra) in zip(("jax", "torch"), mains):
        argv_d = ["dedupe", *argv] if cli else argv
        with contextlib.redirect_stderr(io.StringIO()):
            ret = fn([x.format(d=d) for x in argv_d] + extra)
        res[d] = (ret, [(tmp / o.format(d=d)).read_bytes() for o in outs])
    assert res["jax"] == res["torch"]
    return res["torch"]


def _write(path, reads):
    with open(path, "wb") as fh:
        for n, c in reads:
            s = CODE_TO_BASE[c].tobytes()
            fh.write(b"@" + n + b"\n" + s + b"\n+\n" + b"F" * len(s) + b"\n")


def test_dedupe_exact_equals_jax(tmp_path):
    write_fasta(str(tmp_path / "ref.fa"), random_genome(30_000, n_scaffolds=2, seed=13))
    ref = load_reference(str(tmp_path / "ref.fa"))
    write_reads(str(tmp_path / "r.fq"), random_reads(ref, 500, read_len=100,
                                                      snp_rate=0.01, seed=14))
    orig = (tmp_path / "r.fq").read_bytes()
    (tmp_path / "dup.fq").write_bytes(orig + orig)
    argv = [f"in={tmp_path}/dup.fq", f"out={tmp_path}/o.{{d}}.fq", f"outd={tmp_path}/d.{{d}}.fq"]
    (kept, dupes), files = _both(tmp_path, argv, ["o.{d}.fq", "d.{d}.fq"])
    assert (kept, dupes) == (500, 500) and files[0] == orig == files[1]
    (rc, cli_files) = _both(tmp_path, argv, ["o.{d}.fq", "d.{d}.fq"], cli=True)
    assert rc == 0 and cli_files == files


@pytest.mark.parametrize("flags", [["s=2", "ac=t"], ["e=2"], ["e=2", "s=1", "ac=t"],
                                   ["s=2", "rcomp=f"]])
def test_dedupe_fuzzy_containment_equals_jax(tmp_path, flags):
    """tests/test_tools.py's five reads: a base, one substitution, its
    reverse complement, a contained substring, an unrelated read; and
    the 1 bp deletion of the e=2 case."""
    rng = np.random.default_rng(12)
    base = rng.integers(0, 4, 120).astype(np.uint8)
    sub1 = base.copy()
    sub1[60] = (sub1[60] + 1) % 4
    reads = [base, sub1, (3 - base)[::-1].copy(), base[20:90].copy(),
             rng.integers(0, 4, 120).astype(np.uint8), np.delete(base, 50)]
    _write(tmp_path / "in.fq", [(b"r%d" % i, r) for i, r in enumerate(reads)])
    (kept, dupes), _ = _both(tmp_path, [f"in={tmp_path}/in.fq", f"out={tmp_path}/o.{{d}}.fq",
                                        f"outd={tmp_path}/d.{{d}}.fq", *flags],
                             ["o.{d}.fq", "d.{d}.fq"])
    assert kept + dupes == len(reads) and dupes >= 1


@pytest.mark.parametrize("flags", [["s=2"], ["e=1", "ac=t"]])
def test_dedupe_cluster_equals_jax(tmp_path, flags):
    rng = np.random.default_rng(131)
    a = rng.integers(0, 4, 120).astype(np.uint8)
    a_sub = a.copy()
    a_sub[60] = (a_sub[60] + 1) % 4
    b = rng.integers(0, 4, 120).astype(np.uint8)
    _write(tmp_path / "in.fq", [(b"a0", a), (b"a1", a_sub), (b"a2", (3 - a)[::-1].copy()),
                                (b"b0", b), (b"b1", b[10:100].copy())])
    (ncl, nreads), files = _both(
        tmp_path, [f"in={tmp_path}/in.fq", f"pattern={tmp_path}/c_{{d}}_%.fq", "cluster=t",
                   *flags], ["c_{d}_0.fq", "c_{d}_1.fq"])
    assert nreads == 5 and ncl >= 2


def _planted(n_distinct: int, seed: int):
    """Reads of 150 bp: n_distinct random; as many exact duplicates
    again (every other reverse-complemented) and near-duplicates with
    1-2 substitutions or a 1 bp indel, shuffled."""
    rng = np.random.default_rng(seed)
    base = [rng.integers(0, 4, 150).astype(np.uint8) for _ in range(n_distinct)]
    reads = list(base)
    for i in range(n_distinct // 3):
        c = base[i]
        reads.append((3 - c)[::-1].copy() if i % 2 else c.copy())
        r = base[-1 - i].copy()
        kind = i % 4
        p = int(rng.integers(40, 110))
        if kind == 0:
            r[p] = (r[p] + 1) % 4
        elif kind == 1:
            r[p] = (r[p] + 1) % 4
            r[p + 7] = (r[p + 7] + 2) % 4
        elif kind == 2:
            r = np.delete(r, p)
        else:
            r = np.insert(r, p, rng.integers(0, 4))
        reads.append(r)
    order = rng.permutation(len(reads))
    return [(b"p%d" % i, reads[j]) for i, j in enumerate(order)]


@pytest.mark.parametrize("flags", [["s=2", "e=2"], ["e=2", "ac=t"]])
def test_dedupe_batches_on_banded_equal_jax(tmp_path, monkeypatch, flags):
    """Both packages read 64 reads a batch, so that judge_batch sends each
    batch's fuzzy pairs against the earlier batches to the banded edit
    distance (the JAX package's and the port's)."""
    from bbtools_torch.io.fastq import FastqReader as TReader
    from bbtools_tpu.io.fastq import FastqReader as JReader

    monkeypatch.setattr(tdd, "FastqReader", functools.partial(TReader, batch_reads=64))
    monkeypatch.setattr(jdd, "FastqReader", functools.partial(JReader, batch_reads=64))
    reads = _planted(240, 3)
    _write(tmp_path / "in.fq", reads)
    calls = []
    real = tbanded.banded_edits
    monkeypatch.setattr(tbanded, "banded_edits", lambda *a: calls.append(a[0].shape) or real(*a))
    (kept, dupes), _ = _both(tmp_path, [f"in={tmp_path}/in.fq", f"out={tmp_path}/o.{{d}}.fq",
                                        f"outd={tmp_path}/d.{{d}}.fq", *flags],
                             ["o.{d}.fq", "d.{d}.fq"])
    assert len(calls) >= 3 and sum(s[0] for s in calls) >= 20  # pairs on the banded path
    assert kept == 240 and dupes == len(reads) - 240


def test_judge_batch_equals_sequential():
    """tests/test_tools.py's case: batch verdicts equal per-read judge()
    calls across a snapshot boundary, and the JAX package's."""
    rng = np.random.default_rng(77)
    base = rng.integers(0, 4, 120).astype(np.uint8)
    reads = []
    for i in range(60):
        r = base.copy() if i % 3 else rng.integers(0, 4, 120).astype(np.uint8)
        if i % 3 == 1:
            p = int(rng.integers(10, 110))
            r = np.concatenate([r[:p], r[p + 1:], rng.integers(0, 4, 1).astype(np.uint8)])
        if i % 3 == 2:
            r = r.copy()
            r[int(rng.integers(0, 120))] ^= 1
        reads.append(r)
    d1 = tdd.Dedupe(subs=1, edist=2, rcomp=True, device="cpu")
    seq = [d1.judge(r.copy()) for r in reads]
    d2 = tdd.Dedupe(subs=1, edist=2, rcomp=True, device="cpu")
    bat = d2.judge_batch([r.copy() for r in reads[:30]])
    bat += d2.judge_batch([r.copy() for r in reads[30:]])
    j = jdd.Dedupe(subs=1, edist=2, rcomp=True)
    jbat = j.judge_batch([r.copy() for r in reads[:30]])
    jbat += j.judge_batch([r.copy() for r in reads[30:]])
    assert bat == seq == jbat and d1.dupes == d2.dupes == j.dupes
