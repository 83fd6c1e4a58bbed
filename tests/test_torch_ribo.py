"""The port's splitribo, mergeribo and keepbestcopy (`models/ribo.py`,
on ROADMAP L5) against the JAX package's on the CPU: `python -m
bbtools_torch splitribo ... device=cpu` routes every read to the JAX
package's files byte for byte, in tests/test_longtail7.py's cases (a
16S fragment, a 5S, noise) and on mutated fragments of every type at
the default panel (the clade refinement and p16S's included), over
batches of a few reads; mergeribo keeps the same copy a taxon."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as tmain
from bbtools_tpu.cli import main as jmain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(REPO, "bbtools_tpu", "resources")
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU runs: the suite runs several
    test processes on shared cores, where torch's thread pool, woken at
    each of the many small ops of a glocal row, stalls (as in
    tests/test_torch_cms.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(t):
    """The records of a bundled consensus file, as sequences."""
    seqs, cur = [], None
    for ln in open(os.path.join(RES, f"{t}_consensus_sequence.fa"), "rb"):
        ln = ln.strip()
        if ln.startswith(b">"):
            cur = []
            seqs.append(cur)
        elif ln:
            cur.append(ln)
    return [b"".join(s) for s in seqs]


def _both(tool, argv, outs):
    """Run argv through both CLIs (outputs named {d}); compare each
    output file that either wrote, and stderr; return the port's files."""
    res = {}
    for d, cli, extra in (("jax", jmain, []), ("torch", tmain, ["device=cpu"])):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert cli([tool, *(x.format(d=d) for x in argv), *extra]) == 0
        res[d] = ({o: open(o.format(d=d), "rb").read() for o in outs
                   if os.path.exists(o.format(d=d))}, err.getvalue())
    assert res["jax"] == res["torch"]
    return res["torch"][0]


def _mutate(rng, s, rate):
    a = np.frombuffer(s, np.uint8).copy()
    idx = rng.choice(len(a), int(rate * len(a)), replace=False)
    a[idx] = ACGT[rng.integers(0, 4, len(idx))]
    return a.tobytes()


def test_splitribo_longtail_case(tmp_path):
    rng = np.random.default_rng(21)
    s16 = _records("16S")[0][100:900]
    s5 = _records("5S")[0][:100]
    junk = bytes(b"ACGT"[c] for c in rng.integers(0, 4, 400))
    (tmp_path / "in.fa").write_bytes(b">a16\n" + s16 + b"\n>b5\n" + s5 + b"\n>noise\n"
                                     + junk + b"\n")
    outs = [f"{tmp_path}/o.{{d}}_{t}.fa" for t in ("16S", "5S", "23S", "junk")]
    files = _both("splitribo", [f"in={tmp_path}/in.fa", f"out={tmp_path}/o.{{d}}_#.fa",
                                "types=16S,5S,23S"], outs)
    assert b">a16" in files[outs[0]] and b">b5" in files[outs[1]]
    assert b">noise" in files[outs[3]]


@pytest.mark.parametrize("batch", [6, 64])
def test_splitribo_every_type_equals_jax(tmp_path, batch):
    """Mutated fragments (5-10% substitutions) of the clade records of
    every type, whole 5S records and noise, at the default panel of seven
    types: the universal pass, then the clade refinement of low or p16S
    hits, in batches of `batch` reads."""
    rng = np.random.default_rng(batch)
    types = ("16S", "18S", "5S", "23S", "m16S", "m18S", "p16S")
    recs = []
    for t in types:
        for j, s in enumerate(_records(t)[:2]):
            frag = s if t == "5S" else s[int(rng.integers(0, 200)):][:int(rng.integers(150, 300))]
            recs.append((b"%s_%d" % (t.encode(), j), _mutate(rng, frag, rng.uniform(0.05, 0.1))))
    recs.append((b"noise", ACGT[rng.integers(0, 4, 200)].tobytes()))
    (tmp_path / "in.fa").write_bytes(b"".join(b">%s\n%s\n" % r for r in recs))
    outs = [f"{tmp_path}/o.{{d}}_{t}.fa" for t in (*types, "junk")]
    files = _both("splitribo", [f"in={tmp_path}/in.fa", f"out={tmp_path}/o.{{d}}_#.fa",
                                f"batch={batch}"], outs)
    assert sum(v.count(b">") for v in files.values()) == len(recs)


@pytest.mark.parametrize("tool", ["mergeribo", "keepbestcopy"])
def test_mergeribo_equals_jax(tmp_path, tool):
    """tests/test_longtail7.py's case: a full copy beats a fragment of
    the same taxon; a lone mutated copy stays; names without a taxid."""
    s16 = _records("16S")[0]
    rng = np.random.default_rng(22)
    full, frag = s16[:1500], s16[200:600]
    other = _mutate(rng, s16[:1200], 0.05)
    s18 = _mutate(rng, _records("18S")[1][:900], 0.08)
    (tmp_path / "a.fa").write_bytes(
        b">tid|7|full\n" + full + b"\n>tid|7|frag\n" + frag + b"\n>tid|9|only\n" + other
        + b"\n>tid_11_x\n" + s18 + b"\n>plain\n" + frag + b"\n")
    types = ["types=16S"] if tool == "mergeribo" else []
    out = f"{tmp_path}/best.{{d}}.fa"
    files = _both(tool, [f"in={tmp_path}/a.fa", f"out={out}", *types], [out])
    best = files[out]
    assert b">tid|7|full" in best and b">tid|7|frag" not in best and b">tid|9|only" in best
