"""The port's findprimers/msa (`models/findprimers.py`) against the JAX
package's on the CPU: `best_sites` gives the same offsets and mismatch
counts on the same seeded inputs (an argmin tie taken at its first
offset, a read N against a primer's N or IUPAC base, primers longer than
a read), and `python -m bbtools_torch msa ... device=cpu` writes the JAX
package's SAM and stderr, in the case of tests/test_smalltools2.py
(test_findprimers_msa) and on mixed-length reads with planted sites."""

import numpy as np
import pytest

from bbtools_torch.models.findprimers import best_sites as t_best_sites
from bbtools_tpu.models.findprimers import best_sites as j_best_sites
from torch_parity import assert_equal, run_both, warm_native_codecs  # noqa: F401

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _both_sites(bases, lengths, prim, plens):
    j = j_best_sites(bases, lengths, prim, plens)
    t = t_best_sites(bases, lengths, prim, plens, device="cpu")
    for a, b in zip(j, t):
        assert b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    return t


def test_best_sites_random_equal_jax():
    rng = np.random.default_rng(3)
    B, L, P, Lp = 64, 90, 5, 18
    bases = rng.integers(0, 5, (B, L)).astype(np.uint8)
    lengths = rng.integers(10, L + 1, B).astype(np.int32)
    prim = rng.integers(0, 5, (P, Lp)).astype(np.uint8)
    plens = rng.integers(8, Lp + 1, P).astype(np.int32)
    for p in range(P):
        prim[p, plens[p]:] = 4
    for i in range(0, B, 3):  # plant primer p with a substitution or two
        p = i % P
        if lengths[i] >= plens[p] + 5:
            d = int(rng.integers(0, lengths[i] - plens[p] + 1))
            bases[i, d:d + plens[p]] = prim[p, :plens[p]]
            bases[i, d + int(rng.integers(0, plens[p]))] = int(rng.integers(0, 4))
    off, mm = _both_sites(bases, lengths, prim, plens)
    assert (mm <= 1).sum() >= B // 3 // 2


def test_best_sites_first_minimum_on_a_tie():
    """Two exact sites in one read: both packages report the first."""
    bases = np.full((1, 40), 0, np.uint8)
    site = np.array([1, 2, 3, 1, 2, 3], np.uint8)
    bases[0, 5:11] = site
    bases[0, 25:31] = site
    prim = site[None, :]
    off, mm = _both_sites(bases, np.array([40], np.int32), prim, np.array([6], np.int32))
    assert off[0, 0] == 5 and mm[0, 0] == 0


def test_best_sites_n_matches_iupac_and_overrun():
    """A read N (code 4) equals a primer's N or IUPAC base (code 4); a
    primer longer than the read overruns every offset (1 << 20)."""
    bases = np.full((2, 30), 0, np.uint8)
    bases[0, :12] = [0, 1, 4, 3, 0, 1, 2, 3, 0, 1, 2, 3]
    lengths = np.array([12, 5], np.int32)
    prim = np.array([[0, 1, 4, 3, 0, 1]], np.uint8)  # 4: the primer's IUPAC R
    off, mm = _both_sites(bases, lengths, prim, np.array([6], np.int32))
    assert (off[0, 0], mm[0, 0]) == (0, 0)
    assert mm[0, 1] == 1 << 20


def _write_fq(path, recs):
    with open(path, "wb") as f:
        for name, seq in recs:
            f.write(b"@%s\n%s\n+\n%s\n" % (name, seq, b"I" * len(seq)))


def test_msa_equal_jax(tmp_path):
    """tests/test_smalltools2.py::test_findprimers_msa's input: one
    primer planted at 10 + 7i, cutoff=0.9."""
    rng = np.random.default_rng(17)
    primer = ACGT[rng.integers(0, 4, 20)].tobytes()
    reads = []
    for i in range(10):
        r = ACGT[rng.integers(0, 4, 120)].copy()
        p = 10 + 7 * i
        r[p:p + 20] = np.frombuffer(primer, np.uint8)
        reads.append((b"r%d" % i, r.tobytes()))
    _write_fq(tmp_path / "in.fq", reads)
    out = f"{tmp_path}/s1.{{d}}.sam"
    res = run_both("msa", [f"in={tmp_path}/in.fq", f"out={out}",
                           f"literal={primer.decode()}", "cutoff=0.9"], [out])
    assert_equal(res, [out])
    body = [ln.split(b"\t") for ln in res["torch"][0][0].splitlines()
            if ln and not ln.startswith(b"@")]
    by_read = {r[2]: int(r[3]) for r in body if not r[0].startswith(b"r_")}
    assert by_read == {b"r%d" % i: 10 + 7 * i + 1 for i in range(10)}


@pytest.mark.parametrize("flags", [[], ["rcomp=f"], ["cutoff=0.85"]])
def test_findprimers_planted_equal_jax(tmp_path, flags):
    """Reads of 25-160 bp (some shorter than a primer, some with N) with
    two primers of a FASTA ref= (one with an IUPAC base) planted with 0-2
    substitutions on either strand."""
    rng = np.random.default_rng(11)
    p1 = ACGT[rng.integers(0, 4, 19)].copy()
    p2 = ACGT[rng.integers(0, 4, 20)].copy()
    p2[7] = ord("R")
    (tmp_path / "primers.fa").write_bytes(b">p1 fwd\n%s\n>p2\n%s\n" % (p1.tobytes(),
                                                                      p2.tobytes()))
    comp = bytes.maketrans(b"ACGTR", b"TGCAY")
    reads = []
    for i in range(120):
        n = int(rng.integers(25, 161))
        r = ACGT[rng.integers(0, 4, n)].copy()
        if i % 5 == 0:
            r[rng.integers(0, n, 2)] = ord("N")
        p = (p1, p2)[i % 2].copy()
        if i % 3 and n > 30:
            p[p == ord("R")] = ord("A")
            for j in rng.integers(0, len(p), int(rng.integers(0, 3))):
                p[j] = ACGT[int(rng.integers(0, 4))]
            s = p.tobytes() if i % 4 < 2 else p.tobytes().translate(comp)[::-1]
            d = int(rng.integers(0, n - len(s) + 1))
            r[d:d + len(s)] = np.frombuffer(s, np.uint8)
        reads.append((b"q%d extra" % i, r.tobytes()))
    _write_fq(tmp_path / "in.fq", reads)
    out = f"{tmp_path}/o.{{d}}.sam"
    res = run_both("findprimers", [f"in={tmp_path}/in.fq", f"ref={tmp_path}/primers.fa",
                                   f"out={out}", *flags], [out])
    assert_equal(res, [out])
    assert res["torch"][0][0].count(b"\tNM:i:0") >= 10
