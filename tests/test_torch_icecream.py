"""The port's icecream, icecreamfinder and reformatpb
(`models/icecream.py`, on ROADMAP L5) against the JAX package's on the
CPU: `python -m bbtools_torch icecream ... device=cpu` writes the JAX
package's good and bad files byte for byte and prints the same counts,
in tests/test_longtail4.py's kzt case, with trim=t and on subreads with
planted missed adapters at several junctions; the batched check (tip
alignments in one glocal_identity call, junction refinements in one
glocal_counts call) gives the verdicts of the per-read host check and of
the JAX package's check_batch (tests/test_tools.py's case); reformatpb
in tests/test_longtail9.py's cases."""

import contextlib
import io

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as tmain
from bbtools_torch.models import icecream as tic
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.models import icecream as jic

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


def _rc(c):
    return np.where(c < 4, 3 - c, 4)[::-1]


def _both(tool, argv, outs):
    """Run argv through both CLIs (outputs named {d}); compare the output
    files and stderr; return the port's files."""
    res = {}
    for d, cli, extra in (("jax", jmain, []), ("torch", tmain, ["device=cpu"])):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert cli([tool, *(x.format(d=d) for x in argv), *extra]) == 0
        res[d] = ([open(o.format(d=d), "rb").read() for o in outs], err.getvalue())
    assert res["jax"] == res["torch"]
    return res["torch"]


def _subreads(path, rng, zmws, per, lo, hi, every):
    """PacBio-named subreads movie/zmw/start_end; every `every`-th one a
    missed adapter (the subread's first part, then its reverse
    complement, joined at 35-65% of its length)."""
    n_planted = 0
    with open(path, "wb") as fh:
        k = 0
        for z in range(zmws):
            pos = 0
            for _ in range(per):
                n = int(rng.integers(lo, hi))
                c = rng.integers(0, 4, n).astype(np.uint8)
                if k % every == every - 1:
                    j = int(n * rng.uniform(0.35, 0.65))
                    c[j:] = _rc(c[:j])[: n - j] if j >= n - j else np.concatenate(
                        [_rc(c[:j]), rng.integers(0, 4, n - 2 * j)])[: n - j]
                    n_planted += 1
                s = ACGT[c].tobytes()
                fh.write(b"@m1/%d/%d_%d\n%s\n+\n%s\n" % (z, pos, pos + n, s, b"F" * n))
                pos += n + 50
                k += 1
    return n_planted


def test_icecream_kzt_longtail_case(tmp_path):
    rng = np.random.default_rng(13)
    clean = rng.integers(0, 4, 1600).astype(np.uint8)
    half = rng.integers(0, 4, 800).astype(np.uint8)
    tri = np.concatenate([half, _rc(half)])
    reads = [(b"m1/7/0_1600", clean), (b"m1/7/1700_3300", tri),
             (b"m1/9/0_1600", rng.integers(0, 4, 1600).astype(np.uint8))]
    with open(tmp_path / "in.fq", "wb") as fh:
        for n, c in reads:
            s = ACGT[c].tobytes()
            fh.write(b"@" + n + b"\n" + s + b"\n+\n" + b"F" * len(s) + b"\n")
    (good, bad), _ = _both("icecream", [f"in={tmp_path}/in.fq", f"outg={tmp_path}/g.{{d}}.fq",
                                        f"outb={tmp_path}/b.{{d}}.fq", "kzt=t"],
                           [f"{tmp_path}/g.{{d}}.fq", f"{tmp_path}/b.{{d}}.fq"])
    assert good.splitlines()[::4] == [b"@m1/9/0_1600"]
    assert sorted(bad.splitlines()[::4]) == [b"@m1/7/0_1600", b"@m1/7/1700_3300"]


@pytest.mark.parametrize("tool,flags", [("icecream", ["trim=t"]), ("icecreamfinder", ["kzt=t"]),
                                        ("icecream", ["minratio1=0.55", "minratio2=0.6"])])
def test_icecream_equals_jax(tmp_path, tool, flags):
    rng = np.random.default_rng(len(flags[0]))
    planted = _subreads(tmp_path / "in.fq", rng, 6, 3, 700, 1400, 3)
    (good, bad), err = _both(tool, [f"in={tmp_path}/in.fq", f"outg={tmp_path}/g.{{d}}.fq",
                                    f"outb={tmp_path}/b.{{d}}.fq", *flags],
                             [f"{tmp_path}/g.{{d}}.fq", f"{tmp_path}/b.{{d}}.fq"])
    flagged = int(err.split("Ice cream flagged:")[1].split()[0])
    assert planted == 6 and flagged >= 1
    assert (good + bad).count(b"\n@m1/") + 1 == 18 or "trim=t" in flags


def test_check_batch_equals_host_and_jax():
    """tests/test_tools.py's case (inverted repeats at mid-read in every
    other read) and junctions off-centre, on both sides."""
    rng = np.random.default_rng(21)
    reads = []
    for i in range(10):
        n = int(rng.integers(700, 1300))
        r = rng.integers(0, 4, n).astype(np.uint8)
        if i % 2 == 0:
            half = n // 2 + (i % 5 - 2) * 40
            r[half:] = _rc(r[: n - half])
        reads.append(r)
    reads.append(rng.integers(0, 4, 150).astype(np.uint8))  # too short to check
    got = tic.check_batch(reads, tic.ICConfig(device="cpu"))
    assert got == [jic.check_read(r, jic.ICConfig()) for r in reads]
    assert got == jic.check_batch(reads, jic.ICConfig())
    assert any(v[0] for v in got)


def _pb(path, recs):
    path.write_bytes(b"".join(b"@%s\n%s\n+\n%s\n" % (n, s, b"I" * len(s)) for n, s in recs))


@pytest.mark.parametrize("case", ["trimpolya", "kzt", "bestpass"])
def test_reformatpb_equals_jax(tmp_path, case):
    recs = [(b"m1/5/0_100", b"ACGT" * 25), (b"m1/5/150_170", b"ACGTACGTACGTACGTACGT"),
            (b"m1/9/0_80", b"CCGA" * 20), (b"m1/11/0_60", b"GGCA" * 10 + b"A" * 12),
            (b"m1/11/100_180", b"T" * 9 + b"GATC" * 18), (b"m1/11/200_260", b"AC" * 30),
            (b"m1/11/300_330", b"GT" * 15)]
    _pb(tmp_path / "in.fq", recs)
    flags = {"trimpolya": ["minlen=30", "trimpolya=t", "blacklist=9",
                           f"schist={tmp_path}/sc.{{d}}.txt"],
             "kzt": ["minlen=40", "kzt=t", "whitelist=5,11"],
             "bestpass": ["bestpass=t", "reads=4", f"schist={tmp_path}/sc.{{d}}.txt"]}[case]
    outs = [f"{tmp_path}/good.{{d}}.fq", f"{tmp_path}/bad.{{d}}.fq"]
    if "schist" in flags[-1]:
        outs.append(f"{tmp_path}/sc.{{d}}.txt")
    files, _ = _both("reformatpb", [f"in={tmp_path}/in.fq", f"out={outs[0]}", f"outb={outs[1]}",
                                    *flags], outs)
    if case == "trimpolya":
        lines = files[0].splitlines()
        assert lines[lines.index(b"@m1/11/0_60") + 1] == b"GGCA" * 9 + b"GGC"
