"""The port's tools on the count-min sketch — kmercoverage
(`models/misctools.py`), bloomfilter (`models/texttools.py`) and
polyfilter (`models/polyfilter.py`) — against the JAX package's on the
CPU: `python -m bbtools_torch <tool> ... device=cpu` writes the JAX
package's files and stderr byte for byte, in the cases of
tests/test_longtail3.py (test_kmercoverage), tests/test_smalltools2.py
(test_sketchblacklist_and_bloomfilter) and tests/test_longtail2.py
(test_polyfilter), and on seeded reads of several batches where the
port's one sketch query a batch (and polyfilter's one add a batch) meets
the JAX package's one a read."""

import functools

import numpy as np
import pytest

from torch_parity import assert_equal, run_both, warm_native_codecs  # noqa: F401

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _write_fq(path, recs):
    with open(path, "wb") as f:
        for name, seq, q in recs:
            f.write(b"@%s\n%s\n+\n%s\n" % (name, seq, q or b"I" * len(seq)))


@pytest.fixture
def small_batches(monkeypatch):
    """Both packages' FastqReader at 64 reads a batch, so a few hundred
    reads make several batches."""
    import bbtools_torch.io.fastq as tfq
    import bbtools_tpu.io.fastq as jfq

    for mod in ("models.misctools", "models.texttools", "models.polyfilter"):
        for pkg, fq in (("bbtools_torch", tfq), ("bbtools_tpu", jfq)):
            m = __import__(f"{pkg}.{mod}", fromlist=["x"])
            if hasattr(m, "FastqReader"):
                monkeypatch.setattr(m, "FastqReader",
                                    functools.partial(fq.FastqReader, batch_reads=64))
    for pkg, fq in (("bbtools_torch", tfq), ("bbtools_tpu", jfq)):
        monkeypatch.setattr(f"{pkg}.io.fastq.FastqReader",
                            functools.partial(fq.FastqReader, batch_reads=64))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """300 reads of 24, 80 or 150 bp from a 3 kb genome (depth ~8), some
    with N, 20 foreign, 30 with poly-G tails of 20-60 bp, varied
    qualities. Three lengths and one N position keep the JAX package's
    one-a-read sketch calls to a few shapes (each new shape compiles)."""
    tmp = tmp_path_factory.mktemp("cms")
    rng = np.random.default_rng(7)
    genome = ACGT[rng.integers(0, 4, 3000)].copy()
    recs = []
    for i in range(300):
        n = (24, 80, 150)[int(rng.integers(0, 3))]
        if i % 15 == 0:
            s = ACGT[rng.integers(0, 4, n)].copy()
        else:
            p = int(rng.integers(0, 3000 - n))
            s = genome[p:p + n].copy()
        if i % 10 == 3:
            t = min(n, int(rng.integers(20, 61)))
            s[n - t:] = ord("G")
        if i % 9 == 4:
            s[n // 2] = ord("N")
        q = (rng.integers(2 if i % 11 == 0 else 20, 41, n) + 33).astype(np.uint8)
        recs.append((b"r%d x" % i, s.tobytes(), q.tobytes()))
    _write_fq(tmp / "r.fq", recs)
    _write_fq(tmp / "extra.fq", recs[::3])
    (tmp / "g.fa").write_bytes(b">g\n" + genome[:1500].tobytes() + b"\n>short\nACGT\n")
    return tmp


def test_kmercoverage_equal_jax(tmp_path):
    """tests/test_longtail3.py::test_kmercoverage: five copies of a read
    and a lone one (min=5, min=1)."""
    rng = np.random.default_rng(2)
    base = ACGT[rng.integers(0, 4, 100)].tobytes()
    recs = [(b"r%d" % i, base, b"") for i in range(5)]
    recs.append((b"lone", ACGT[rng.integers(0, 4, 100)].tobytes(), b""))
    _write_fq(tmp_path / "in.fq", recs)
    outs = [f"{tmp_path}/o.{{d}}.fq", f"{tmp_path}/h.{{d}}.txt"]
    res = run_both("kmercoverage", [f"in={tmp_path}/in.fq", f"out={outs[0]}",
                                    f"hist={outs[1]}", "k=31"], outs)
    assert_equal(res, outs)
    assert b"r0 min=5" in res["torch"][0][0] and b"lone min=1" in res["torch"][0][0]


@pytest.mark.parametrize("flags", [["k=31"], ["k=21", "extra={tmp}/extra.fq"],
                                   ["k=25", "hashes=3"]])
def test_kmercoverage_batches_equal_jax(reads, small_batches, flags):
    outs = [f"{reads}/kc.{{d}}.fq", f"{reads}/kch.{{d}}.txt"]
    res = run_both("kmercoverage", [f"in={reads}/r.fq", f"out={outs[0]}",
                                    f"hist={outs[1]}", *(f.format(tmp=reads) for f in flags)],
                   outs)
    assert_equal(res, outs)
    assert b" min=0 avg=0.00\n" in res["torch"][0][0]  # a read shorter than k


def test_bloomfilter_equal_jax(tmp_path):
    """tests/test_smalltools2.py: every odd read is cut from the
    contaminant; minhits=1 keeps the 20 even ones."""
    rng = np.random.default_rng(29)
    contam = ACGT[rng.integers(0, 4, 300)].tobytes()
    (tmp_path / "contam.fa").write_bytes(b">c\n" + contam + b"\n")
    recs = [(b"r%d" % i, contam[50:150] if i % 2 else ACGT[rng.integers(0, 4, 100)].tobytes(),
             b"") for i in range(40)]
    _write_fq(tmp_path / "reads.fq", recs)
    outs = [f"{tmp_path}/clean.{{d}}.fq"]
    res = run_both("bloomfilter", [f"in={tmp_path}/reads.fq", f"ref={tmp_path}/contam.fa",
                                   f"out={outs[0]}", "minhits=1"], outs)
    assert_equal(res, outs)
    assert res["torch"][0][0].count(b"\n+\n") == 20


@pytest.mark.parametrize("flags", [[], ["include=t", "minhits=3"], ["k=21"]])
def test_bloomfilter_batches_equal_jax(reads, small_batches, flags):
    outs = [f"{reads}/bf.{{d}}.fq", f"{reads}/bfm.{{d}}.fq"]
    res = run_both("bloomfilter", [f"in={reads}/r.fq", f"ref={reads}/g.fa", f"out={outs[0]}",
                                   f"outm={outs[1]}", *flags], outs)
    assert_equal(res, outs)
    assert res["torch"][0][0] and res["torch"][0][1]


def test_polyfilter_equal_jax(tmp_path):
    """tests/test_longtail2.py::test_polyfilter: a 35 bp poly-G read goes
    to outb=, depth off (ldf=2 ldf2=2)."""
    good = b"ACGTTGCAGTACCGATAGGCTAACGGTCAGT" * 4
    polyg = b"ACGTTGCAGTACCGATAGG" + b"G" * 35 + b"ACGTTGCAGTACCGATAG" * 4
    _write_fq(tmp_path / "in.fq", [(b"good", good, b""), (b"polyg", polyg, b"")])
    outs = [f"{tmp_path}/o.{{d}}.fq", f"{tmp_path}/b.{{d}}.fq"]
    res = run_both("polyfilter", [f"in={tmp_path}/in.fq", f"out={outs[0]}",
                                  f"outb={outs[1]}", "ldf=2", "ldf2=2"], outs)
    assert_equal(res, outs)
    assert res["torch"][0][1].startswith(b"@polyg\n")


@pytest.mark.parametrize("flags", [["extra={tmp}/r.fq"], ["extra={tmp}/extra.fq", "k=21",
                                                         "mincount=3", "ldf2=0.9"],
                                   ["polymers=GC", "minpolymer=12", "purity=0.9"]])
def test_polyfilter_batches_equal_jax(reads, small_batches, flags):
    outs = [f"{reads}/pf.{{d}}.fq", f"{reads}/pfb.{{d}}.fq"]
    res = run_both("polyfilter", [f"in={reads}/r.fq", f"out={outs[0]}", f"outb={outs[1]}",
                                  *(f.format(tmp=reads) for f in flags)], outs)
    assert_equal(res, outs)
    assert res["torch"][0][1]


def test_polyfilter_paired_equal_jax(reads, small_batches):
    """Twin files: a pair goes to outb= when either read fails; out= and
    out2=, then one interleaved out=."""
    for o2 in (True, False):
        outs = [f"{reads}/pp1.{o2}.{{d}}.fq", f"{reads}/ppb.{o2}.{{d}}.fq"]
        if o2:
            outs.append(f"{reads}/pp2.{o2}.{{d}}.fq")
        res = run_both("polyfilter", [f"in={reads}/r.fq", f"in2={reads}/r.fq",
                                      f"out={outs[0]}", f"outb={outs[1]}",
                                      *([f"out2={outs[2]}"] if o2 else []),
                                      f"extra={reads}/extra.fq"], outs)
        assert_equal(res, outs)
