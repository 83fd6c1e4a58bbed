"""The port's alltoall and idmatrix (`models/alltoall.py`, on ROADMAP L5)
against the JAX package's on the CPU: `python -m bbtools_torch alltoall
... device=cpu` writes the JAX package's matrix byte for byte, in
tests/test_longtail4.py's case (three sequences, three substitutions),
on a set past one batch of 512 pairs (two glocal calls), FASTQ input,
`percent=f` and the matrix on stdout."""

import contextlib
import io

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as tmain
from bbtools_torch.models import alltoall as tat
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


def _both(tool, argv, out=None):
    """Run argv through both CLIs; compare the matrix file (or the bytes
    on stdout) and return the port's."""
    res = {}
    for d, cli, extra in (("jax", jmain, []), ("torch", tmain, ["device=cpu"])):
        args = [x.format(d=d) for x in argv] + extra
        text = io.TextIOWrapper(io.BytesIO())
        with contextlib.redirect_stdout(text), contextlib.redirect_stderr(io.StringIO()):
            assert cli([tool, *args]) == 0
        text.flush()
        res[d] = open(out.format(d=d), "rb").read() if out else text.buffer.getvalue()
    assert res["jax"] == res["torch"]
    return res["torch"]


def _variants(rng, n, L):
    """n variants of one random sequence of L bp: substitutions and 1-3
    bp indels at rates up to 20%, and one unrelated sequence."""
    base = ACGT[rng.integers(0, 4, L)]
    out = [base.tobytes()]
    for i in range(1, n - 1):
        s = bytearray(base.tobytes())
        for _ in range(int(rng.integers(0, L // 5))):
            s[int(rng.integers(0, len(s)))] = ACGT[int(rng.integers(0, 4))]
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, len(s) - 3))
            k = int(rng.integers(1, 4))
            s[p:p + k] = b"" if i % 2 else ACGT[rng.integers(0, 4, 2 * k)].tobytes()
        out.append(bytes(s))
    out.append(ACGT[rng.integers(0, 4, L)].tobytes())
    return out


def test_alltoall_longtail_case(tmp_path):
    rng = np.random.default_rng(1)
    s1 = rng.choice(ACGT, 80).tobytes()
    s2 = bytearray(s1)
    for p in (10, 30, 50):
        s2[p] = ord("A") if s2[p] != ord("A") else ord("C")
    s3 = rng.choice(ACGT, 80).tobytes()
    (tmp_path / "in.fa").write_bytes(
        b">a\n" + s1 + b"\n>b\n" + bytes(s2) + b"\n>c\n" + s3 + b"\n")
    txt = _both("alltoall", [f"in={tmp_path}/in.fa", f"out={tmp_path}/m.{{d}}.txt"],
                f"{tmp_path}/m.{{d}}.txt")
    assert txt.startswith(b"#name\ta\tb\tc")
    ident = tat.main([f"in={tmp_path}/in.fa", f"out={tmp_path}/m2.txt", "device=cpu"])
    assert ident[0, 1] > 0.9 and ident[0, 2] < ident[0, 1]


@pytest.mark.parametrize("tool,n,fmt,flags", [
    ("alltoall", 34, "fa", []),          # 561 pairs: two calls
    ("idmatrix", 12, "fq", ["percent=f"]),
    ("idmatrix", 9, "fa", ["stdout"]),
])
def test_alltoall_equals_jax(tmp_path, tool, n, fmt, flags):
    rng = np.random.default_rng(n)
    seqs = _variants(rng, n, 90)
    with open(tmp_path / f"in.{fmt}", "wb") as fh:
        for i, s in enumerate(seqs):
            fh.write(b">s%d desc\n%s\n" % (i, s) if fmt == "fa" else
                     b"@s%d\n%s\n+\n%s\n" % (i, s, b"F" * len(s)))
    if flags == ["stdout"]:
        txt = _both(tool, [f"in={tmp_path}/in.{fmt}"])
    else:
        txt = _both(tool, [f"in={tmp_path}/in.{fmt}", f"out={tmp_path}/m.{{d}}.txt", *flags],
                    f"{tmp_path}/m.{{d}}.txt")
    rows = txt.splitlines()
    assert len(rows) == n + 1 and rows[1].split(b"\t")[1] in (b"100.00", b"1.00")
