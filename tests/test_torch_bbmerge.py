"""The slice end to end on the CPU: the port's `bbmerge` and its BBDuk
`tbo tpe` against the JAX package's on the same seeded pairs, byte for
byte (merged, unmerged and ihist files; BBDuk output and stats).

On the CPU the JAX package runs its host path (XLA insert scan, numpy
mate selection, efilter and pfilter), while the port runs its device
path on the CPU (the kernels' plain versions and the torch loops), so
these runs hold the port's device path against an independent one.

The JAX package's `BBMerge` writes into the preset it takes from its
module-level `PRESETS` table (`nn=t` sets max_ratio 0.7 on it,
`mininsert=` its min_insert): one such run anywhere earlier in the same
process changes every later default-mode JAX run. So each test here runs
against a fresh copy of the published presets (`pristine_jax_presets`)."""

import copy
import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as torch_main
from bbtools_torch.models import bbmerge as port_bbmerge
from bbtools_tpu.cli import main as jax_main
from bbtools_tpu.models import bbmerge as jax_bbmerge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPTER1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
ADAPTER2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
COMP = bytes.maketrans(b"ACGTN", b"TGCAN")
#: the JAX package's presets as published, copied at import (collection
#: runs before any test, so nothing has written into them yet)
JAX_PRESETS = copy.deepcopy(jax_bbmerge.PRESETS)


@pytest.fixture(autouse=True)
def pristine_jax_presets(monkeypatch):
    """Every test sees a fresh copy of the JAX package's published
    BBMerge presets, whatever ran earlier in this process."""
    monkeypatch.setattr(jax_bbmerge, "PRESETS", copy.deepcopy(JAX_PRESETS))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU runs: the suite runs several
    test processes on shared cores, where torch's thread pool, woken at
    each of the many small ops of the mate selection and the fills,
    stalls (as in tests/test_torch_bbmap.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_pairs(n, seed, L, lo, hi):
    """n pairs of L bp from inserts of lo..hi bp, adapters past the insert
    end, phred 2-40 (mostly high), errors drawn at each base's phred
    rate, an N in every 25th r1."""
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        ins = int(rng.integers(lo, hi + 1))
        frag = bytes(b"ACGT"[x] for x in rng.integers(0, 4, ins))
        r1 = (frag + ADAPTER1 + b"A" * L)[:L]
        r2 = (frag[::-1].translate(COMP) + ADAPTER2 + b"A" * L)[:L]
        recs = []
        for r in (r1, r2):
            q = np.clip(41 - rng.exponential(7, L), 2, 40).astype(np.uint8)
            s = np.frombuffer(r, np.uint8).copy()
            err = rng.random(L) < 10.0 ** (-q.astype(np.float64) / 10)
            s[err] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, err.sum())]
            recs.append((s, q))
        if i % 25 == 0:
            recs[0][0][rng.integers(0, L)] = ord("N")
        pairs.append([(b"@p%d %d:N:0" % (i, m + 1), s.tobytes(), (q + 33).tobytes())
                      for m, (s, q) in enumerate(recs)])
    return pairs


def _write(path, records):
    with gzip.open(path, "wb") as fh:
        fh.write(b"".join(b"%s\n%s\n+\n%s\n" % r for r in records))
    return str(path)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pairs")
    recs = make_pairs(400, 11, L=100, lo=60, hi=260)
    return {
        "r1": _write(d / "r1.fq.gz", [p[0] for p in recs]),
        "r2": _write(d / "r2.fq.gz", [p[1] for p in recs]),
        "int": _write(d / "int.fq.gz", [r for p in recs for r in p]),
    }


def _bbmerge(runner, tmp_path, tag, inputs, extra):
    outs = [tmp_path / f"{tag}.{x}" for x in ("merged.fq", "u1.fq", "u2.fq", "ihist.txt")]
    runner(["bbmerge", *inputs, f"out={outs[0]}", f"outu1={outs[1]}",
            f"outu2={outs[2]}", f"ihist={outs[3]}", *extra])
    return [o.read_bytes() for o in outs]


def test_bbmerge_cli_matches_jax(tmp_path, pairs):
    """The default (quality) mode through `python -m bbtools_torch`."""
    inputs = [f"in1={pairs['r1']}", f"in2={pairs['r2']}"]

    def subprocess_cli(argv):
        subprocess.run([sys.executable, "-m", "bbtools_torch", *argv, "device=cpu"],
                       cwd=REPO, check=True, capture_output=True)

    want = _bbmerge(jax_main, tmp_path, "jax", inputs, [])
    got = _bbmerge(subprocess_cli, tmp_path, "torch", inputs, [])
    assert got == want
    n_merged = got[0].count(b"\n+\n")
    assert 100 < n_merged < 400  # some pairs merge, some do not
    assert b"#InsertCount\t%d\n" % n_merged in got[3]


@pytest.mark.parametrize("extra", [
    ["usequality=f"],  # the non-quality ratio mode (B6 on the increment tables)
    ["strict=t"],
    ["entropy=f", "loose=t"],
])
def test_bbmerge_modes_match_jax(tmp_path, pairs, extra):
    inputs = [f"in1={pairs['r1']}", f"in2={pairs['r2']}"]
    tools = {}

    def run(tag, main):
        def runner(argv):
            tools[tag] = main(argv[1:] + (["device=cpu"] if tag == "torch" else []))
        return _bbmerge(runner, tmp_path, tag, inputs, extra)

    assert run("torch", port_bbmerge.main) == run("jax", jax_bbmerge.main)
    for stat in ("pairs", "merged", "ambiguous", "no_solution", "too_short",
                 "insert_sum"):
        assert getattr(tools["torch"], stat) == getattr(tools["jax"], stat), stat
    assert tools["torch"].merged > 0 and tools["torch"].no_solution > 0


def test_bbmerge_interleaved_matches_jax(tmp_path, pairs):
    want = _bbmerge(jax_main, tmp_path, "jax", [f"in={pairs['int']}"], [])
    got = _bbmerge(lambda a: torch_main(a + ["device=cpu"]), tmp_path, "torch",
                   [f"in={pairs['int']}"], [])
    assert got == want
    two_files = _bbmerge(lambda a: torch_main(a + ["device=cpu"]), tmp_path,
                         "torch2", [f"in1={pairs['r1']}", f"in2={pairs['r2']}"], [])
    assert got[0] == two_files[0] and got[3] == two_files[3]


@pytest.fixture(scope="module")
def jax_presets_after_nn_run(pairs):
    """The JAX module's presets as a test process holds them after a JAX
    `BBMerge` built with `nn=t` (as tests/test_cellnet.py builds one): a
    copy that build wrote into, in the module's place until this test
    module ends, so nothing outside it sees the write."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bbmerge, "PRESETS", copy.deepcopy(JAX_PRESETS))
        jax_bbmerge.BBMerge(jax_bbmerge.parse_args(
            [f"in1={pairs['r1']}", f"in2={pairs['r2']}", "nn=t"]))
        yield jax_bbmerge.PRESETS


def test_bbmerge_default_matches_jax_after_a_jax_nn_run(
        tmp_path, pairs, jax_presets_after_nn_run):
    """The order that failed in a shared test process: a JAX `BBMerge`
    with `nn=t`, then the default-mode comparison. The pinned presets
    keep both packages equal byte for byte and on every count."""
    assert jax_presets_after_nn_run["default"].max_ratio == 0.7
    inputs = [f"in1={pairs['r1']}", f"in2={pairs['r2']}"]
    tools = {}

    def run(tag, main, dev):
        def runner(argv):
            tools[tag] = main(argv[1:] + dev)
        return _bbmerge(runner, tmp_path, tag, inputs, [])

    assert run("torch", port_bbmerge.main, ["device=cpu"]) == run("jax", jax_bbmerge.main, [])
    for stat in ("merged", "ambiguous", "no_solution"):
        assert getattr(tools["torch"], stat) == getattr(tools["jax"], stat), stat
    assert tools["jax"].no_solution > tools["jax"].ambiguous  # not the polluted run's split


@pytest.mark.parametrize("extra", [[], ["ktrim=f", "minkmerhits=2"]])
def test_bbduk_tbo_matches_jax(tmp_path, extra):
    """BBDuk `tbo tpe` on the 1-adapter flags over interleaved pairs with
    inserts of 60-180 bp (reads of 120 bp run into the adapters)."""
    recs = make_pairs(300, 13, L=120, lo=60, hi=180)
    fin = _write(tmp_path / "int.fq.gz", [r for p in recs for r in p])
    flags = [f"literal={ADAPTER1.decode()}", "k=23", "mink=11", "hdist=1",
             "ktrim=r", "minlen=40", "tbo", "tpe", *extra]
    res = {}
    for tag, main, dev in (("jax", jax_main, []), ("torch", torch_main, ["device=cpu"])):
        out, stats = tmp_path / f"{tag}.fq", tmp_path / f"{tag}.stats.txt"
        main(["bbduk", f"in={fin}", f"out={out}", f"stats={stats}", *flags, *dev])
        res[tag] = (out.read_bytes(), stats.read_bytes())
    assert res["torch"] == res["jax"]
    # tbo trimmed reads that the k-mer scan alone leaves long
    no_tbo = tmp_path / "no_tbo.fq"
    torch_main(["bbduk", f"in={fin}", f"out={no_tbo}", "device=cpu",
                *[f for f in flags if f != "tbo"]])
    assert no_tbo.read_bytes() != res["torch"][0]
