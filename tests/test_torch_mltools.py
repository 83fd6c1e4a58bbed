"""The port's CellNet training (`ml/cellnet.py` `CellNet.fit`) and the
ML tool family (`models/mltools.py`) against the JAX package's on the
CPU, in the cases of tests/test_cellnet.py (test_train_xor) and
tests/test_mltools.py (test_ml_pipeline_end_to_end,
test_vectorutils_and_reducecolumns).

Training cannot be bit-equal: float32 products differ between XLA and
torch (ROADMAP C4), and Adam compounds that over the epochs. Both fits
start from the same `CellNet.create(dims, seed)` weights and must end
within FIT_WEIGHT_TOL of each other in every weight and bias and
within FIT_LOSS_TOL in the final loss. The bounds come from a CPU dry
run (`tools/a8c_dryrun.py --only fit`): on these inputs and on the
chip smoke's training sets the largest weight difference was 2.2e-06
and the largest loss difference 4.3e-12; the bounds leave ~20x and
~200x.
Every other tool writes the JAX package's bytes: seqtovec, netconvert,
reducecolumns, vectorutils, balancevectors, and scoresequence and
netfilter given one .bbnet (none of whose reads scores within NN_NEAR
of the cutoff, counted)."""

import re

import numpy as np
import pytest

from bbtools_torch.ml.cellnet import CellNet as TNet
from bbtools_torch.ml.cellnet import parse_bbnet as t_parse
from bbtools_tpu.ml.cellnet import CellNet as JNet
from bbtools_tpu.ml.cellnet import parse_bbnet as j_parse
from torch_parity import assert_equal, run_both, warm_native_codecs  # noqa: F401

#: the largest weight or bias difference of two fits from one start
FIT_WEIGHT_TOL = 5e-5
#: the largest difference of their final losses
FIT_LOSS_TOL = 1e-9
#: a read scoring this close to the cutoff may be decided either way
NN_NEAR = 1e-5


def _fit_both(dims, x, y, epochs, lr, hidden="SIG", seed=1):
    j = JNet.create(dims, seed=seed, hidden=hidden)
    t = TNet.create(dims, seed=seed, hidden=hidden)
    t.device = "cpu"
    for a, b in zip(j.weights + j.biases, t.weights + t.biases):
        np.testing.assert_array_equal(a, b)  # the same start
    lj = j.fit(x, y, epochs=epochs, lr=lr)
    lt = t.fit(x, y, epochs=epochs, lr=lr)
    for a, b in zip(j.weights + j.biases, t.weights + t.biases):
        assert b.dtype == np.float32 and b.shape == a.shape
        assert float(np.abs(a - b).max()) <= FIT_WEIGHT_TOL
    assert abs(lj - lt) <= FIT_LOSS_TOL, (lj, lt)
    return t, lt


def test_fit_xor_within_tolerance_of_jax():
    """tests/test_cellnet.py::test_train_xor: [2, 8, 1], TANH hidden,
    1,500 epochs."""
    x = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
    y = np.array([[0], [1], [1], [0]], np.float32)
    net, loss = _fit_both([2, 8, 1], x, y, 1500, 0.05, hidden="TANH")
    assert loss < 0.02
    assert (net.apply(x)[:, 0].round() == y[:, 0]).all()


def test_fit_returns_the_last_steps_loss_before_its_update():
    """One epoch: the loss of the starting weights, which then move."""
    rng = np.random.default_rng(4)
    x = rng.random((32, 6)).astype(np.float32)
    y = (x[:, :1] > 0.5).astype(np.float32)
    t = TNet.create([6, 3, 1], seed=2)
    t.device = "cpu"
    start = [w.copy() for w in t.weights]
    want = float(np.mean((t.apply(x) - y) ** 2))
    loss = t.fit(x, y, epochs=1, lr=0.05)
    assert abs(loss - want) < 1e-7
    assert all(np.abs(a - b).max() > 0 for a, b in zip(start, t.weights))
    _fit_both([6, 3, 1], x, y, 1, 0.05, seed=2)


def _write_fq(path, seqs, prefix=b"r"):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@%s%d\n%s\n+\n%s\n" % (prefix, i, s, b"I" * len(s)))


@pytest.fixture(scope="module")
def ml_inputs(tmp_path_factory):
    """tests/test_mltools.py's pipeline input: 80 GC-rich and 80 AT-rich
    reads of 60 bp; the vector TSVs of both packages' seqtovec (k=2)."""
    tmp = tmp_path_factory.mktemp("ml")
    rng = np.random.default_rng(1)
    gc = [bytes(rng.choice(list(b"GCGCGCAT"), 60).astype(np.uint8)) for _ in range(80)]
    at = [bytes(rng.choice(list(b"ATATATGC"), 60).astype(np.uint8)) for _ in range(80)]
    _write_fq(tmp / "p.fq", gc, b"p")
    _write_fq(tmp / "n.fq", at, b"n")
    _write_fq(tmp / "both.fq", gc[:40] + at[:40], b"b")
    return tmp


@pytest.mark.parametrize("flags", [["k=2", "result=1"], ["k=0", "width=30"],
                                   ["k=3", "rcomp=t", "result=0.25"]])
def test_seqtovec_equal_jax(ml_inputs, flags):
    outs = [f"{ml_inputs}/v.{{d}}.tsv"]
    res = run_both("seqtovec", [f"in={ml_inputs}/p.fq", f"out={outs[0]}", *flags], outs)
    assert_equal(res, outs)


@pytest.fixture(scope="module")
def vectors(ml_inputs):
    """The pipeline's training TSV (seqtovec k=2 of both classes)."""
    from bbtools_torch.cli import main

    for name, res in (("p", 1), ("n", 0)):
        main(["seqtovec", f"in={ml_inputs}/{name}.fq", f"out={ml_inputs}/{name}.tsv", "k=2",
              f"result={res}"])
    body = (ml_inputs / "n.tsv").read_bytes().split(b"\n", 1)[1]
    (ml_inputs / "all.tsv").write_bytes((ml_inputs / "p.tsv").read_bytes() + body)
    return ml_inputs / "all.tsv"


def _train_line(err):
    m = re.search(r"Trained (\[.*\]) on (\d+) samples: mse=(\S+) acc=(\S+)", err)
    return m.group(1), int(m.group(2)), float(m.group(3)), float(m.group(4))


@pytest.mark.parametrize("tool,flags", [("train", ["epochs=600", "lr=0.1"]),
                                        ("train", ["dims=14,6,1", "epochs=300", "seed=3"]),
                                        ("regressiontrainer", ["epochs=200"])])
def test_train_within_tolerance_of_jax(ml_inputs, vectors, tool, flags):
    """The nets the two CLIs write (six decimals) within FIT_WEIGHT_TOL;
    the reported mse within FIT_WEIGHT_TOL, the accuracy equal."""
    outs = [f"{ml_inputs}/net.{tool}.{len(flags)}.{{d}}.bbnet"]
    res = run_both(tool, [f"data={vectors}", f"out={outs[0]}", *flags], outs)
    nets = {d: (j_parse if d == "jax" else t_parse)(outs[0].format(d=d)) for d in res}
    assert nets["jax"].dims == nets["torch"].dims
    for a, b in zip(nets["jax"].weights + nets["jax"].biases,
                    nets["torch"].weights + nets["torch"].biases):
        assert float(np.abs(a - b).max()) <= FIT_WEIGHT_TOL
    lj, lt = (_train_line(res[d][1]) for d in ("jax", "torch"))
    assert lj[:2] == lt[:2] and lj[3] == lt[3] and abs(lj[2] - lt[2]) <= FIT_WEIGHT_TOL
    assert lt[3] == 1.0


def test_pipeline_tools_equal_jax(ml_inputs, vectors):
    """netconvert, scoresequence and netfilter on one .bbnet (the JAX
    package's trained net): the JAX package's bytes."""
    from bbtools_tpu.cli import main as jmain

    net = ml_inputs / "pipe.bbnet"
    jmain(["train", f"data={vectors}", f"out={net}", "epochs=600", "lr=0.1"])
    outs = [f"{ml_inputs}/conv.{{d}}.bbnet"]
    assert_equal(run_both("netconvert", [f"in={net}", f"out={outs[0]}"], outs), outs)
    tnet = t_parse(str(net))
    tnet.device = "cpu"
    scores = np.concatenate([tnet.apply(v)[:, 0] for v in _vectors_of(ml_inputs / "both.fq")])
    near = int((np.abs(scores - 0.5) < NN_NEAR).sum())
    assert near == 0, f"{near} reads within {NN_NEAR} of the cutoff"
    for tool, flags, files in (
            ("scoresequence", ["k=2", "out={o}/s.{{d}}.fq", "hist={o}/h.{{d}}.txt"],
             ["s", "h"]),
            ("scoresequence", ["k=2", "out={o}/sf.{{d}}.fq", "filter=t", "highpass=f",
                               "annotate=f", "cutoff=0.3"], ["sf"]),
            ("netfilter", ["k=2", "out={o}/nf.{{d}}.fq", "outu={o}/nu.{{d}}.fq"],
             ["nf", "nu"]),
            ("netfilter", ["k=2", "in2={o}/both.fq", "out={o}/pf.{{d}}.fq",
                           "out2={o}/pf2.{{d}}.fq", "pairmode=and", "rcomp=f"],
             ["pf", "pf2"])):
        outs = [f"{ml_inputs}/{f}.{{d}}.{'txt' if f == 'h' else 'fq'}" for f in files]
        res = run_both(tool, [f"in={ml_inputs}/both.fq", f"net={net}",
                              *(f.format(o=ml_inputs) for f in flags)], outs)
        assert_equal(res, outs)


def _vectors_of(fq):
    """Forward and reverse-complement k=2 vectors of a FASTQ's reads."""
    from bbtools_torch.io.fastq import FastqReader
    from bbtools_torch.models.mltools import _rc_batch, vectorize_batch

    for b in FastqReader(str(fq)):
        yield vectorize_batch(b.bases, b.lengths, 55, 2)
        yield vectorize_batch(_rc_batch(b.bases, b.lengths), b.lengths, 55, 2)


def test_vector_tools_equal_jax(tmp_path):
    """tests/test_mltools.py::test_vectorutils_and_reducecolumns's TSV:
    balancevectors, reducecolumns and vectorutils (dedupe, balance,
    samplerate, shuffle) write the JAX package's bytes."""
    rows = [b"#dims\t3\t1"] + [b"%d\t%d\t%d\t%d" % (i, i * 2, i * 3, i % 2) for i in range(50)]
    rows += rows[5:9]
    src = tmp_path / "v.tsv"
    src.write_bytes(b"\n".join(rows) + b"\n")
    for tool, argv in (
            ("balancevectors", [f"in={src}", "out={o}"]),
            ("reducecolumns", [str(src), "{o}", "0", "2-3"]),
            ("reducecolumns", [str(src), "{o}", "1+"]),
            ("vectorutils", [f"in={src}", "out={o}", "dedupe=t", "balance=t"]),
            ("vectorutils", [f"in={src}", "out={o}", "samplerate=0.5", "seed=3",
                             "shuffle=f"])):
        o = f"{tmp_path}/{tool}.{len(argv)}.{{d}}.tsv"
        res = run_both(tool, [a.replace("{o}", o) for a in argv], [o])
        assert_equal(res, [o])
