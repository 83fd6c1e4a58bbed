"""The port's Clumpify (`models/clumpify.py`, ROADMAP L7) against the JAX
package's on the CPU: `python -m bbtools_torch clumpify ... device=cpu`
writes the same clumped files and returns the same counts as
`python -m bbtools_tpu clumpify`, in tests/test_tools.py's cases (k=21
to gzip, groups=4 against groups=1, optical dedupe) and
tests/test_smalltools2.py's paired dedupe, on batches on each side of
the B*L >= 2^16 switch; the torch pivot equals `_pivot_kmers_jnp` and
`_pivot_kmers_np` element for element, ties (repeated k-mers) and reads
without a valid k-mer included."""

import contextlib
import gzip
import io

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as tmain
from bbtools_torch.models import clumpify as tcl
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.models import clumpify as jcl

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _both(tmp, argv, outs, gz=False):
    """Run argv through both CLIs (outputs named {d}); compare every
    output file's bytes (decompressed with gz) and the module mains'
    returns; return the torch files."""
    res = {}
    for d, cli, mod, extra in (("jax", jmain, jcl, []), ("torch", tmain, tcl, ["device=cpu"])):
        args = [x.format(d=d) for x in argv] + extra
        with contextlib.redirect_stderr(io.StringIO()):
            assert cli(["clumpify", *args]) == 0
            files = [(tmp / o.format(d=d)).read_bytes() for o in outs]
            ret = mod.main(args)
        res[d] = (ret, [gzip.decompress(f) if gz else f for f in files])
    assert res["jax"] == res["torch"]
    return res["torch"]


def _reads(path, n, L, seed, repeats=False):
    """n random reads of L bp (a few N bases); with repeats, every third
    a tandem repeat, whose canonical k-mers repeat (argmin ties), and
    one read too short for a k-mer."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as fh:
        for i in range(n):
            s = ACGT[rng.integers(0, 4, L)].copy()
            if repeats and i % 3 == 0:
                unit = ACGT[rng.integers(0, 4, int(rng.integers(1, 7)))]
                s = np.resize(unit, L).copy()
            if i % 11 == 0:
                s[rng.integers(0, L, 3)] = ord("N")
            if repeats and i == 5:
                s = s[:15]
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"F" * len(s)))


@pytest.mark.parametrize("n,flags", [(300, ["k=21"]), (600, ["k=21"]),
                                     (600, ["k=31", "dedupe=t"])])
def test_clumpify_equals_jax(tmp_path, n, flags):
    """n reads of 100 bp and a copy of their first third: 400 reads lie
    under the switch (numpy pivot), 800 above it (torch pivot)."""
    _reads(tmp_path / "in.fq", n, 100, 9, repeats=True)
    lines = (tmp_path / "in.fq").read_bytes().splitlines(keepends=True)
    (tmp_path / "in.fq").write_bytes(b"".join(lines + lines[: n // 3 * 4]))  # duplicates
    ret, files = _both(tmp_path, [f"in={tmp_path}/in.fq", f"out={tmp_path}/o.{{d}}.fq.gz",
                                  *flags], ["o.{d}.fq.gz"], gz=True)
    assert ret[0] == (tmp_path / "in.fq").read_bytes().count(b"\n") // 4
    assert sorted(files[0].splitlines()) == sorted((tmp_path / "in.fq").read_bytes().splitlines()) \
        or "dedupe=t" in flags


@pytest.mark.parametrize("n", [300, 700])
def test_clumpify_groups_equal_jax(tmp_path, n):
    _reads(tmp_path / "in.fq", n, 100, 51)
    _, g1 = _both(tmp_path, [f"in={tmp_path}/in.fq", f"out={tmp_path}/g1.{{d}}.fq", "groups=1"],
                  ["g1.{d}.fq"])
    _, g4 = _both(tmp_path, [f"in={tmp_path}/in.fq", f"out={tmp_path}/g4.{{d}}.fq", "groups=4"],
                  ["g4.{d}.fq"])
    assert g1 == g4


@pytest.mark.parametrize("flags", [["dedupe=t", "optical=t", "dupedist=40"], ["dedupe=t"]])
def test_clumpify_optical_equals_jax(tmp_path, flags):
    seq = b"ACGTAGGCTACGATCGTAGCTAACGGATCGAT" * 3
    with open(tmp_path / "in.fq", "wb") as fh:
        for name in (b"M:1:FC:1:1101:1000:2000", b"M:1:FC:1:1101:1010:2015",
                     b"M:1:FC:1:1101:9000:9000", b"M:1:FC:1:2203:1000:2000"):
            fh.write(b"@" + name + b"\n" + seq + b"\n+\n" + b"F" * len(seq) + b"\n")
    (n, d), _ = _both(tmp_path, [f"in={tmp_path}/in.fq", f"out={tmp_path}/o.{{d}}.fq", *flags],
                      ["o.{d}.fq"])
    assert (n, d) == ((4, 1) if "optical=t" in flags else (4, 3))


@pytest.mark.parametrize("n_uniq", [50, 250])
def test_clumpify_paired_dedupe_equals_jax(tmp_path, n_uniq):
    """tests/test_smalltools2.py's pairs (every fifth three times, the
    third copy's mate differing); 250 pairs' worth lies past the switch."""
    rng = np.random.default_rng(8)
    r1s, r2s = [], []
    for i in range(n_uniq):
        s1, s2 = (ACGT[rng.integers(0, 4, 100)].tobytes() for _ in range(2))
        for c in range(3 if i % 5 == 0 else 1):
            t2 = s2 if c < 2 else ACGT[rng.integers(0, 4, 100)].tobytes()
            r1s.append(b"@d%d_%d\n%s\n+\n%s\n" % (i, c, s1, b"F" * 100))
            r2s.append(b"@d%d_%d\n%s\n+\n%s\n" % (i, c, t2, b"F" * 100))
    (tmp_path / "r1.fq").write_bytes(b"".join(r1s))
    (tmp_path / "r2.fq").write_bytes(b"".join(r2s))
    (total, dupes), files = _both(
        tmp_path, [f"in={tmp_path}/r1.fq", f"in2={tmp_path}/r2.fq", f"out={tmp_path}/o1.{{d}}.fq",
                   f"out2={tmp_path}/o2.{{d}}.fq", "dedupe=t"], ["o1.{d}.fq", "o2.{d}.fq"])
    assert total == 2 * len(r1s) and dupes == 2 * (n_uniq // 5)
    assert files[0].splitlines()[0::4] == files[1].splitlines()[0::4]


@pytest.mark.parametrize("B,L,k", [(64, 90, 31), (40, 60, 21), (700, 100, 31), (16, 1, 5)])
def test_pivot_equals_jax_and_host(B, L, k):
    """tests/test_tools.py's case and more: random codes with 2% N, tandem
    repeats (ties: the first position wins), reads with no valid k-mer
    (all-ones pivot at position 0), rows shorter than k (host only)."""
    rng = np.random.default_rng(B)
    bases = rng.integers(0, 4, (B, L)).astype(np.uint8)
    bases[rng.random((B, L)) < 0.02] = 4
    bases[::4] = np.resize(np.array([0, 1, 1, 3], np.uint8), L)
    bases[1] = 4
    lengths = rng.integers(0, L + 1, B).astype(np.int64)
    lengths[::4] = L
    piv, pos = tcl._pivot_kmers_t(torch.from_numpy(bases), torch.from_numpy(lengths), k)
    pn, on = jcl._pivot_kmers_np(bases, lengths, k)
    np.testing.assert_array_equal(piv.numpy().view(np.uint64), pn)
    np.testing.assert_array_equal(pos.numpy(), on)
    if L >= k:  # the JAX package's rolling registers need a row of k
        pj, oj = jcl._pivot_kmers_jnp(bases, lengths, k)
        np.testing.assert_array_equal(piv.numpy().view(np.uint64),
                                      np.asarray(pj).astype(np.uint64))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(oj))
    assert pn[1] == np.uint64(0xFFFFFFFFFFFFFFFF) and pos[1] == 0
    got = tcl.pivot_kmers(bases, lengths, k, torch.device("cpu"))
    np.testing.assert_array_equal(got[0], pn)
    np.testing.assert_array_equal(got[1], on)
    assert tcl._pivot_kmers_t.device_calls == 0
