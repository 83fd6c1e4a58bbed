"""The port's reformat, reformat2 and reformat3 (`models/reformat.py`)
against the JAX package's on the CPU: `python -m bbtools_torch reformat
... device=cpu` writes the JAX package's files byte for byte and prints
the same counts, in the cases of tests/test_smalltools2.py (FASTA in
with qfake, srt sampling, twin files with rcompmate, quantize),
tests/test_tools.py (samplerate, FASTA out, reads=, the flag matrix,
SAM, scarf, padding and barcode filters) and quality trimming
(qtrim=rl/r/l, trimq=10, minlen=40, reads with N and low-quality
tails), whose trim runs `optimal_trim` on the run's device."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as tmain
from bbtools_tpu.cli import main as jmain

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


def _both(tool, argv, outs):
    """Run argv through both CLIs (outputs named {d}); compare the output
    files and stderr (its seconds masked); return the port's files."""
    res = {}
    for d, cli, extra in (("jax", jmain, []), ("torch", tmain, ["device=cpu"])):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert cli([tool, *(x.format(d=d) for x in argv), *extra]) == 0
        res[d] = ([open(o.format(d=d), "rb").read() for o in outs],
                  re.sub(r"Time:\s+\S+", "Time: T", err.getvalue()))
    assert res["jax"] == res["torch"]
    return res["torch"][0]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reformat")
    rng = np.random.default_rng(1)
    with open(tmp / "mx.fq", "w") as f:  # the flag matrix's input
        for i in range(100):
            pool = "GC" if i % 2 else "AT"
            seq = "".join(pool[int(x)] for x in rng.integers(0, 2, 60))
            q = chr(33 + 20 + (i % 3)) * 60
            f.write(f"@r{i} {'1:Y:0' if i % 10 == 0 else '1:N:0'} extra\n{seq}\n+\n{q}\n")
    with open(tmp / "q.fq", "wb") as f:  # quality trimming: tails, N, junk heads
        for i in range(300):
            n = int(rng.integers(30, 151))
            s = ACGT[rng.integers(0, 4, n)].copy()
            q = rng.integers(25, 41, n)
            if i % 3 == 0:
                q[-int(rng.integers(1, n // 2)):] = rng.integers(0, 12, 1)
            if i % 4 == 1:
                q[: int(rng.integers(1, 20))] = rng.integers(0, 8, 1)
            if i % 7 == 2:
                s[rng.integers(0, n, 3)] = ord("N")
            if i % 29 == 5:
                q[:] = 3
            f.write(b"@q%d\n%s\n+\n%s\n" % (i, s.tobytes(), (q + 33).astype(np.uint8).tobytes()))
    (tmp / "in.fa").write_bytes(b"".join(
        b">s%d desc\n%s\n" % (i, ACGT[rng.integers(0, 4, 80)].tobytes()) for i in range(50)))
    seq = ACGT[rng.integers(0, 4, 60)].tobytes()
    for m in (1, 2):
        (tmp / f"r{m}.fq").write_bytes(b"".join(
            b"@p%d\n%s\n+\n%s\n" % (i, seq[i:] + seq[:i], b"F" * 60) for i in range(5)))
    (tmp / "qin.fq").write_bytes(b"@q\nACGTACGT\n+\n" + bytes(
        [33 + q for q in (5, 11, 20, 30, 36, 37, 2, 0)]) + b"\n")
    (tmp / "in.sam").write_text(
        "@HD\tVN:1.4\n@SQ\tSN:chr\tLN:1000\n"
        "r0\t0\tchr\t1\t40\t4=\t*\t0\t0\tACGT\tFFFF\n"
        "r1\t16\tchr\t5\t40\t4=\t*\t0\t0\tACGT\tFFIB\n"
        "r2\t4\t*\t0\t0\t*\t*\t0\t0\tGGGG\tFFFF\n"
        "r3\t256\tchr\t9\t40\t4=\t*\t0\t0\tTTTT\tFFFF\n")
    (tmp / "in.scarf").write_text("HWI:1:X:8#0/1:ACGTAC:" + chr(64 + 30) * 6 + "\n")
    (tmp / "p.fq").write_text("@a\nACGT\n+\nFFFF\n@e\n\n+\n\n")
    (tmp / "b.fq").write_text("@r0 1:N:0:ACGT\nAAAA\n+\nFFFF\n@r1 1:N:0:ACNT\nCCCC\n+\nFFFF\n"
                              "@r2 1:N:0:TTTT\nGGGG\n+\nFFFF\n")
    (tmp / "iupac.fq").write_text("@x\nACGRYSWB\n+\nFFFFFFFF\n")
    return tmp


CASES = {
    # quality trimming, on the device
    "qtrim_rl": ("q.fq", "fq", ["qtrim=rl", "trimq=10", "minlen=40"]),
    "qtrim_r": ("q.fq", "fq", ["qtrim=r", "trimq=6"]),
    "qtrim_l": ("q.fq", "fq", ["qtrim=l", "trimq=15", "ml=20"]),
    "qtrim_fa": ("q.fq", "fa", ["qtrim=t", "trimq=10", "fastawrap=50"]),
    # tests/test_smalltools2.py
    "fasta_qfake": ("in.fa", "fq", ["qfake=25", "underscore=t"]),
    "srt": ("mx.fq", "fq", ["samplereadstarget=20", "sampleseed=5"]),
    "quantize": ("qin.fq", "fq", ["quantize=0,8,13,22,27,32,37"]),
    # tests/test_tools.py
    "samplerate": ("q.fq", "fq", ["samplerate=0.5", "sampleseed=7"]),
    "to_fasta": ("q.fq", "fa", []),
    "reads": ("q.fq", "fq", ["reads=100"]),
    "ftr": ("mx.fq", "fq", ["ftr=39", "ftl=3"]),
    "ftm_ftr2": ("q.fq", "fq", ["ftm=5", "ftr2=2"]),
    "gc": ("mx.fq", "fq", ["mingc=0.9"]),
    "invert": ("mx.fq", "fq", ["mingc=0.9", "invert=t"]),
    "chastity_trd": ("mx.fq", "fq", ["ch=t", "trd=t"]),
    "skip": ("mx.fq", "fq", ["skipreads=95"]),
    "qout64": ("mx.fq", "fq", ["qout=64", "rcomp=t"]),
    "t2u_tuc": ("mx.fq", "fq", ["t2u=t", "tuc=t", "uniquenames=t", "addslash=t"]),
    "mbq_maq_maxns": ("q.fq", "fq", ["mbq=5", "maq=20", "maxns=1", "maxlength=140"]),
    "iupacton": ("iupac.fq", "fq", ["iupacton=t"]),
    "sam": ("in.sam", "fq", []),
    "sam_mapped": ("in.sam", "fq", ["mappedonly", "primaryonly"]),
    "scarf": ("in.scarf", "fq", []),
    "pad": ("p.fq", "fq", ["padleft=3", "padright=2"]),
    "pad_symbol": ("p.fq", "fq", ["pad=2", "padsymbol=A"]),
    "barcodefilter": ("b.fq", "fq", ["barcodefilter=t"]),
    "barcodes": ("b.fq", "fq", ["barcodes=ACGT"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reformat_equals_jax(inputs, case):
    src, ext, flags = CASES[case]
    tool = {"qtrim_r": "reformat2", "qtrim_l": "reformat3"}.get(case, "reformat")
    out = f"{inputs}/{case}.{{d}}.{ext}"
    files = _both(tool, [f"in={inputs}/{src}", f"out={out}", *flags], [out])
    assert files[0] or case in ("sam_mapped",)


def test_reformat_histograms_equal_jax(inputs):
    outs = [f"{inputs}/h.{{d}}.{x}.txt" for x in ("l", "q", "gc", "aq", "b")]
    _both("reformat", [f"in={inputs}/q.fq", f"out={inputs}/h.{{d}}.fq", "qtrim=rl", "trimq=10",
                       *(f"{k}hist={o}" for k, o in zip(("l", "q", "gc", "aq", "b"), outs))],
          outs)


@pytest.mark.parametrize("flags", [["rcompmate=t"], ["int=f"]])
def test_reformat_twin_files_equal_jax(inputs, flags):
    """Twin files to twin files, and to one interleaved file."""
    outs = [f"{inputs}/t1.{{d}}.fq", f"{inputs}/t2.{{d}}.fq"]
    if flags == ["int=f"]:
        outs = outs[:1]
    _both("reformat", [f"in={inputs}/r1.fq", f"in2={inputs}/r2.fq", f"out={outs[0]}",
                       *(f"out2={o}" for o in outs[1:]), *flags, "qtrim=rl"], outs)
