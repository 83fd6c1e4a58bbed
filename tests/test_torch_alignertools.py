"""The port's aligner launchers (`models/alignertools.py`, the 24 names
from glocalaligner to microalign) against the JAX package's on the CPU:
each `python -m bbtools_torch <name> ... device=cpu` prints (and writes)
what `python -m bbtools_tpu <name>` does, byte for byte but for the
seconds it times, in tests/test_alignertools.py's cases: every
per-engine launcher and the panel on literal sequences and on files,
the validation ladder, the ANI and length ladders on both device routes
(exact glocal, and the banded edit distance past 2^22 cells),
alignrandom, alignerbenchmark on truth-tagged reads, the visualizers
and microalign's SAM."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as tmain
from bbtools_tpu.cli import main as jmain

ACGT = np.frombuffer(b"ACGT", np.uint8)
SECONDS = re.compile(r"(Time: |time=)[0-9.]+")


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


def _both(tool, argv, outs=(), strip_pg=False):
    """Run argv through both CLIs (outputs named {d}); compare stdout,
    stderr (times masked), the exception raised if any and the output
    files; return the port's."""
    res = {}
    for d, cli, extra in (("jax", jmain, []), ("torch", tmain, ["device=cpu"])):
        out, err = io.TextIOWrapper(io.BytesIO()), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                cli([tool, *(x.format(d=d) for x in argv), *extra])
            except AssertionError as e:  # the validation ladder's verdict
                print(f"raised: {e}", file=err)
        out.flush()
        files = [open(o.format(d=d), "rb").read() for o in outs]
        if strip_pg:
            files = [b"".join(ln for ln in f.splitlines(True) if not ln.startswith(b"@PG"))
                     for f in files]
        res[d] = (out.buffer.getvalue(), SECONDS.sub(r"\1T", err.getvalue()), files)
    assert res["jax"] == res["torch"]
    return res["torch"]


LAUNCHERS = ["glocalaligner", "bandedaligner", "bandedplusaligner", "driftingaligner",
             "driftingplusaligner", "wavefrontaligner", "quantumaligner", "quabblealigner",
             "scrabblealigner", "wobblealigner", "wobbleplusaligner", "crosscutaligner",
             "xdrophaligner", "parallelogram", "smithwaterman", "testaligners"]


@pytest.mark.parametrize("tool", LAUNCHERS)
def test_engine_launchers_equal_jax(tmp_path, tool):
    rng = np.random.default_rng(len(tool))
    r = ACGT[rng.integers(0, 4, 160)].tobytes()
    q = bytearray(r[20:140])
    for p in rng.integers(0, len(q), 6):
        q[p] = ACGT[int(rng.integers(0, 4))]
    del q[50:52]
    (tmp_path / "q.fa").write_bytes(b">q\n" + bytes(q[:60]) + b"\n" + bytes(q[60:]) + b"\n>x\nAC\n")
    (tmp_path / "r.fq").write_bytes(b"@r\n" + r + b"\n+\n" + b"F" * len(r) + b"\n")
    _, err, _ = _both(tool, [f"{tmp_path}/q.fa", f"{tmp_path}/r.fq", "3"])
    assert "id=" in err and "coords=(" in err
    _both(tool, ["AAGAATTACA", "AAGATTACCA"])
    _, err, _ = _both(tool, ["validate=t"])
    assert "validated" in err or "raised: " in err


def test_validation_suite_equals_jax():
    _, err, _ = _both("testaligners2", [])
    assert "All aligners validated." in err


@pytest.mark.parametrize("tool,argv", [
    ("testalignersbatch", ["length=300", "samples=3", "ani=1,0.95,0.85,0.75"]),
    ("testalignersbatch", ["length=200", "samples=2", "subsonly=t", "seed=5"]),
    ("testalignerslength", ["lengths=100,300", "samples=3", "ani=85"]),
    # 2,100 bp: the padded product passes 2^22 cells, the banded route
    ("testalignerslength", ["lengths=2100", "samples=3", "subsonly=t"]),
    ("alignrandom", ["10", "2", "3", "5", "10", "2g", "{d}.hist"]),
])
def test_ladders_equal_jax(tmp_path, tool, argv):
    argv = [a.replace("{d}.hist", f"{tmp_path}/{{d}}.hist") for a in argv]
    outs = [a for a in argv if a.endswith(".hist")]
    out, _, files = _both(tool, argv, outs)
    assert out.count(b"\n") >= 2 or files[0].count(b"\n") == 4


def test_alignerbenchmark_equals_jax(tmp_path):
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.utils.synth import random_genome

    write_fasta(str(tmp_path / "ref.fa"), random_genome(4_000, n_scaffolds=1, seed=4))
    codes = load_reference(str(tmp_path / "ref.fa")).scaffold_codes(0)
    rng = np.random.default_rng(9)
    with open(tmp_path / "reads.fq", "w") as fh:
        for i in range(8):
            start = int(rng.integers(0, len(codes) - 90))
            r = codes[start : start + 90].copy()
            pos = rng.choice(90, i % 4, replace=False)
            r[pos] = (r[pos] + 1) % 4
            seq = "".join("ACGT"[c] for c in r)
            fh.write(f"@r{i}_scaf0_pos{start}_strand{i % 2}_insert0\n{seq}\n+\n{'F' * 90}\n")
        fh.write("@untagged\nACGTACGT\n+\nFFFFFFFF\n")
    out, _, _ = _both("alignerbenchmark", [f"ref={tmp_path}/ref.fa", f"in={tmp_path}/reads.fq",
                                           "pad=5", "aligners=glocal,banded,quantum,wobble"])
    assert out.count(b"\n") == 9


@pytest.mark.parametrize("tool", ["visualizealignment", "wavefrontalignerviz"])
def test_visualizers_equal_jax(tmp_path, tool):
    _, _, files = _both(tool, ["ACGTTAGCATCAGGA", "TTACGTAGCATCAGCAGG", "width=7",
                               f"out={tmp_path}/v.{{d}}.txt"], [f"{tmp_path}/v.{{d}}.txt"])
    assert b"id=" in files[0]
    _both(tool, ["ACGTTAGCA", "ACGTAGCA"])


def test_microalign_equals_jax(tmp_path):
    """Reads of phiX (a few substitutions, both strands) and random reads,
    against the bundled phiX: the SAM but for its @PG line, the unmapped
    reads and the summary."""
    import gzip
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with gzip.open(os.path.join(repo, "bbtools_tpu", "resources", "phix2.fa.gz"), "rb") as fh:
        phix = b"".join(ln.strip() for ln in fh.read().splitlines()[1:])
    rng = np.random.default_rng(11)
    with open(tmp_path / "r.fq", "wb") as fh:
        for i in range(40):
            p = int(rng.integers(0, len(phix) - 100))
            s = bytearray(phix[p:p + 100])
            for q in rng.integers(0, 100, i % 3):
                s[q] = ACGT[int(rng.integers(0, 4))]
            if i % 2:
                s = bytearray(bytes(s[::-1]).translate(bytes.maketrans(b"ACGT", b"TGCA")))
            if i % 10 == 9:
                s = bytearray(ACGT[rng.integers(0, 4, 100)].tobytes())
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, bytes(s), b"F" * 100))
    _, err, files = _both("microalign", [f"in={tmp_path}/r.fq", "ref=phix",
                                         f"out={tmp_path}/o.{{d}}.sam",
                                         f"outu={tmp_path}/u.{{d}}.fq"],
                          [f"{tmp_path}/o.{{d}}.sam", f"{tmp_path}/u.{{d}}.fq"], strip_pg=True)
    assert "Mapped: 36/40" in err or files[1].count(b"\n@") + 1 >= 4


def test_length_ladder_pads_the_banded_route():
    """Past 2^22 cells with indels, the padded queries and references
    differ in width: the JAX package's banded route raises (ROADMAP C5),
    the port pads both to one width (at one width, subsonly=t, the two
    packages agree: test_ladders_equal_jax)."""
    with contextlib.redirect_stderr(io.StringIO()), pytest.raises(ValueError, match="broadcast"):
        jmain(["testalignerslength", "lengths=2100", "samples=3", "ani=0.9"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert tmain(["testalignerslength", "lengths=2100", "samples=3", "ani=0.9",
                      "device=cpu"]) == 0
    row = out.getvalue().splitlines()[1].split("\t")
    assert row[0] == "2100" and row[3] == "3" and 0.85 < float(row[1]) <= 1.0
