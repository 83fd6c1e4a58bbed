"""RQCFilter2 (`rqcfilter`) end to end on the CPU: the port's pipeline,
every stage's tool on device=cpu, against the JAX package's on the same
seeded inputs. The cases are tests/test_smalltools2.py's five rqcfilter
cases and the flags of chip_smoke.py's phase (clumpify, filterbytile,
removeribo, polyfilter, removeref, merge, khist on tiled pairs). Every
file of the output directory is equal byte for byte, reproduce.sh once
the run's directory is replaced, and so are the stage rows.

The JAX package's filterbytile reads only in=, so its rqcfilter fails on
paired input with filterbytile=t; the port's takes in2=/out2= and judges
the pairs as the interleaved stream. The JAX side of the paired case
runs the JAX filterbytile on the interleaved pairs (`jax_paired_fbt`,
tools/a8b_dryrun.py's).

The JAX package's BBMerge writes into its module-level PRESETS, so each
test runs against a fresh copy of them (`pristine_jax_presets`, as in
tests/test_torch_bbmerge.py)."""

import copy
import gzip
import importlib.util
import os

import numpy as np
import pytest
import torch

from bbtools_torch.models import rqcfilter as port_rqc
from bbtools_tpu.io.fasta import iter_fasta
from bbtools_tpu.models import bbmerge as jax_bbmerge
from bbtools_tpu.models import filterbytile as jax_fbt
from bbtools_tpu.models import rqcfilter as jax_rqc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(REPO, "bbtools_tpu", "resources")
ACGT = np.frombuffer(b"ACGT", np.uint8)
ADAPTER = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
ADAPTER2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
JAX_PRESETS = copy.deepcopy(jax_bbmerge.PRESETS)
_spec = importlib.util.spec_from_file_location(
    "a8b_dryrun", os.path.join(REPO, "tools", "a8b_dryrun.py"))
a8b_dryrun = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(a8b_dryrun)
jax_paired_fbt = a8b_dryrun.jax_paired_fbt


@pytest.fixture(autouse=True)
def pristine_jax_presets(monkeypatch):
    monkeypatch.setattr(jax_bbmerge, "PRESETS", copy.deepcopy(JAX_PRESETS))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _phix():
    return next(iter_fasta(os.path.join(RES, "phix2.fa.gz"))).seq


def _gz(path, recs):
    with gzip.open(path, "wb") as f:
        f.write(b"".join(recs))


def case_pipeline(tmp):
    rng = np.random.default_rng(3)
    phix = _phix()
    recs = []
    for i in range(300):
        L = 120
        seq = ACGT[rng.integers(0, 4, L)].copy()
        if i % 4 == 0:
            seq[70: 70 + len(ADAPTER)] = np.frombuffer(ADAPTER, np.uint8)
        if i % 10 == 0:
            p = int(rng.integers(0, len(phix) - L))
            seq = np.frombuffer(phix[p: p + L], np.uint8)
        q = np.full(L, 33 + 35, np.uint8)
        if i % 7 == 0:
            q[60:] = 33 + 2
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), q.tobytes()))
    _gz(tmp / "in.fq.gz", recs)
    return [f"in={tmp}/in.fq.gz", "trimq=10"]


def case_optional_stages(tmp):
    rng = np.random.default_rng(8)
    reads = ["".join("ACGT"[c] for c in rng.integers(0, 4, 100)) for _ in range(60)]
    reads += reads[:10]
    reads.append("AT" * 50)
    reads.append("".join("ACGT"[c] for c in rng.integers(0, 4, 60)) + "G" * 40)
    with open(tmp / "in.fq", "w") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i} 1:N:0\n{seq}\n+\n{'F' * len(seq)}\n")
    return [f"in={tmp}/in.fq", "dedupe=t", "entropy=0.3", "polyfilter=1", "khist=t",
            "ch=t", "minlength=30"]


def case_paired(tmp):
    rng = np.random.default_rng(5)
    phix = _phix()
    r1s, r2s = [], []
    for i in range(240):
        L = 120
        s1 = ACGT[rng.integers(0, 4, L)].copy()
        s2 = ACGT[rng.integers(0, 4, L)].copy()
        if i % 10 == 0:
            p = int(rng.integers(0, len(phix) - L))
            s2 = np.frombuffer(phix[p: p + L], np.uint8)
        q = np.full(L, 33 + 35, np.uint8)
        r1s.append(b"@p%d /1\n%s\n+\n%s\n" % (i, s1.tobytes(), q.tobytes()))
        r2s.append(b"@p%d /2\n%s\n+\n%s\n" % (i, s2.tobytes(), q.tobytes()))
    _gz(tmp / "r1.fq.gz", r1s)
    _gz(tmp / "r2.fq.gz", r2s)
    return [f"in={tmp}/r1.fq.gz", f"in2={tmp}/r2.fq.gz", "trimq=10"]


def case_optional_stages_paired(tmp):
    rng = np.random.default_rng(15)
    spike = ACGT[rng.integers(0, 4, 400)].tobytes()
    (tmp / "spike.fa").write_bytes(b">spikein1\n" + spike + b"\n")
    genome = rng.integers(0, 4, 5000).astype(np.uint8)
    r1s, r2s = [], []
    for i in range(120):
        if i % 6 == 0:
            p = int(rng.integers(0, 400 - 120))
            s1 = s2 = spike[p: p + 120]
        else:
            p = int(rng.integers(0, 5000 - 150))
            frag = genome[p: p + 150]
            s1 = ACGT[frag[:120]].tobytes()
            s2 = ACGT[(3 - frag[::-1])[:120]].tobytes()
        r1s.append(b"@s%d /1\n%s\n+\n%s\n" % (i, s1, b"F" * 120))
        r2s.append(b"@s%d /2\n%s\n+\n%s\n" % (i, s2, b"F" * 120))
    _gz(tmp / "r1.fq.gz", r1s)
    _gz(tmp / "r2.fq.gz", r2s)
    return [f"in={tmp}/r1.fq.gz", f"in2={tmp}/r2.fq.gz", f"spikein={tmp}/spike.fa",
            "merge=t", "khist=t", "phix=f", "filterk=f", "ktrim=f"]


def case_poly_and_vector(tmp):
    g = np.random.default_rng(8)
    with open(os.path.join(RES, "pJET1.2.fa"), "rb") as fh:
        pjet = b"".join(ln for ln in fh.read().splitlines() if not ln.startswith(b">"))[:80]
    with open(tmp / "in.fq", "wb") as f:
        for i in range(60):
            seq = ACGT[g.integers(0, 4, 100)].tobytes()
            if i % 5 == 0:
                seq = b"G" * 25 + seq[25:]
            if i % 7 == 0:
                seq = pjet + seq[80:]
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"F" * len(seq)))
    return [f"in={tmp}/in.fq", "phix=f", "artifacts=f"]


def case_smoke_flags(tmp):
    """chip_smoke.py's flags on tiled pairs at a small size: 200 pairs of
    2x100 bp of a 20 kb genome (inserts 80-300, adapters past short
    inserts), with phiX, rRNA, second-genome, poly-G and duplicate
    pairs planted."""
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    other = rng.integers(0, 4, 8_000).astype(np.uint8)
    with open(tmp / "other.fa", "wb") as fh:
        fh.write(b">other\n" + ACGT[other].tobytes() + b"\n")
    phix = np.frombuffer(_phix(), np.uint8)
    code = np.full(256, 0, np.uint8)
    code[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    phix = code[phix]
    ribo = code[np.frombuffer(next(iter_fasta(
        os.path.join(RES, "16S_consensus_sequence.fa"))).seq.upper(), np.uint8)]
    L = 100
    r1s, r2s = [], []
    for i in range(200):
        src = (phix if i % 20 == 1 else ribo if i % 25 == 2 else
               other if i % 20 == 3 else genome)
        ins = int(rng.integers(80, 300))
        p = int(rng.integers(0, len(src) - ins))
        frag = src[p: p + ins]
        if rng.random() < 0.5:
            frag = (3 - frag[::-1])
        a = ACGT[frag[:L]].tobytes() + ADAPTER[: max(0, L - ins)]
        rc = (3 - frag[::-1])
        b = ACGT[rc[:L]].tobytes() + ADAPTER2[: max(0, L - ins)]
        a, b = (a + b"A" * L)[:L], (b + b"A" * L)[:L]
        if i % 40 == 5:
            t = int(rng.integers(20, 61))
            a = a[: L - t] + b"G" * t
        tile = 1101 + i % 4
        h = b"M0:7:FC1:1:%d:%d:%d" % (tile, rng.integers(0, 2000), rng.integers(0, 2000))
        recs = [(h, a, b)]
        if i % 50 == 7:
            recs.append((h + b"0", a, b))
        for hh, x, y in recs:
            r1s.append(b"@%s 1:N:0:ACGT\n%s\n+\n%s\n" % (hh, x, b"F" * L))
            r2s.append(b"@%s 2:N:0:ACGT\n%s\n+\n%s\n" % (hh, y, b"F" * L))
    _gz(tmp / "r1.fq.gz", r1s)
    _gz(tmp / "r2.fq.gz", r2s)
    return [f"in={tmp}/r1.fq.gz", f"in2={tmp}/r2.fq.gz", "clumpify=t", "filterbytile=t",
            "removeribo=t", "polyfilter=1", f"removeref={tmp}/other.fa", "merge=t",
            "khist=t"]


CASES = {
    "pipeline": case_pipeline,
    "optional_stages": case_optional_stages,
    "paired": case_paired,
    "optional_stages_paired": case_optional_stages_paired,
    "poly_and_vector": case_poly_and_vector,
    "smoke_flags": case_smoke_flags,
}


def run_both(tmp, argv, monkeypatch):
    monkeypatch.setattr(jax_fbt, "main", jax_paired_fbt)
    outs = {}
    for tag, fn, extra in (("jax", jax_rqc.main, []), ("torch", port_rqc.main, ["device=cpu"])):
        d = tmp / tag
        stats, final = fn([*argv, f"path={d}", *extra])
        files = {}
        for name in sorted(os.listdir(d)):
            data = (d / name).read_bytes()
            files[name] = data.replace(str(d).encode(), b"DIR")
        outs[tag] = (stats, os.path.basename(final), files)
    return outs


@pytest.mark.parametrize("case", list(CASES))
def test_rqcfilter_equals_jax(tmp_path, case, monkeypatch):
    argv = CASES[case](tmp_path)
    outs = run_both(tmp_path, argv, monkeypatch)
    (js, jf, jfiles), (ts, tf, tfiles) = outs["jax"], outs["torch"]
    assert ts == js and tf == jf
    assert sorted(tfiles) == sorted(jfiles)
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name
    assert {"filterstats.txt", "file-list.txt", "reproduce.sh"} <= set(jfiles)
    assert b"device=" not in tfiles["reproduce.sh"]
    assert js[-1][1] > 0 and any(n.endswith(".fastq.gz") for n in jfiles)
    if case == "smoke_flags":
        tags = [t for t, _, _ in js]
        for want in ("dedupe", "filterbytile", "ktrim", "filter", "polyfilter", "ribo",
                     "removal_other"):
            assert want in tags, tags
        d = dict((t, r) for t, r, _ in js)
        assert d["input"] - d["dedupe"] == 2 * 4  # the planted duplicate pairs
        assert d["qtrim"] > d["filter"] > d["polyfilter"] - 1 >= d["ribo"]
        assert d["ribo"] > d["removal_other"]
        assert "r1.ihist_merge.txt" in jfiles and "r1.khist.txt" in jfiles


def test_filterbytile_pairs_equal_the_interleaved_stream(tmp_path):
    """The port's paired filterbytile keeps exactly the pairs that the JAX
    package's filterbytile keeps of the interleaved file, with a tile of
    poor quality flagged."""
    from bbtools_torch.cli import main as tmain

    rng = np.random.default_rng(4)
    r1s, r2s = [], []
    for i in range(2000):
        tile = 1101 + i % 8
        x, y = int(rng.integers(0, 3000)), int(rng.integers(0, 3000))
        q = b"F" * 100
        if tile == 1103 and x < 500 and y < 1500:
            q = b"+" * 100
        h = b"M0:7:FC1:1:%d:%d:%d" % (tile, x, y)
        for rs, m in ((r1s, 1), (r2s, 2)):
            rs.append(b"@%s %d:N:0:ACGT\n%s\n+\n%s\n"
                      % (h, m, ACGT[rng.integers(0, 4, 100)].tobytes(), q))
    (tmp_path / "r1.fq").write_bytes(b"".join(r1s))
    (tmp_path / "r2.fq").write_bytes(b"".join(r2s))
    argv = [f"in={tmp_path}/r1.fq", f"in2={tmp_path}/r2.fq"]
    res = jax_paired_fbt([*argv, f"out={tmp_path}/j1.fq", f"out2={tmp_path}/j2.fq"])
    tmain(["filterbytile", *argv, f"out={tmp_path}/t1.fq", f"out2={tmp_path}/t2.fq"])
    assert res.reads_discarded > 0
    for m in (1, 2):
        got = (tmp_path / f"t{m}.fq").read_bytes()
        assert got == (tmp_path / f"j{m}.fq").read_bytes()
        assert len(got.splitlines()) == 4 * (2000 - res.reads_discarded // 2)
