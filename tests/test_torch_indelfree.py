"""The port's indelfree/indelfreealigner (`models/indelfree.py`) against
the JAX package's on the CPU: `python -m bbtools_torch indelfree ...
device=cpu` writes the JAX package's SAM and stderr (seconds masked) in
the case of tests/test_smalltools2.py (test_indelfree_aligner), on a
reference longer than one chunk (65,536 bp) with plantings across the
chunk edge and past the last base, and with the query rows tiled at
budgets down to one row a tile (the same SAM at every budget)."""

import numpy as np
import pytest

from bbtools_torch.models import indelfree as tif
from torch_parity import assert_equal, run_both, warm_native_codecs  # noqa: F401

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def test_indelfree_equal_jax(tmp_path):
    """test_smalltools2's plantings: exact at 1000, two substitutions at
    2500, the reverse complement at 4000; subs=3 minid=0."""
    rng = np.random.default_rng(13)
    contig = ACGT[rng.integers(0, 4, 5000)].copy()
    spacer = ACGT[rng.integers(0, 4, 30)].tobytes()
    contig[1000:1030] = np.frombuffer(spacer, np.uint8)
    two = bytearray(spacer)
    two[5] = ord("A") if two[5] != ord("A") else ord("C")
    two[20] = ord("G") if two[20] != ord("G") else ord("T")
    contig[2500:2530] = np.frombuffer(bytes(two), np.uint8)
    contig[4000:4030] = np.frombuffer(spacer.translate(COMP)[::-1], np.uint8)
    (tmp_path / "ref.fa").write_bytes(b">c1\n" + contig.tobytes() + b"\n")
    (tmp_path / "q.fa").write_bytes(b">sp1\n" + spacer + b"\n")
    out = f"{tmp_path}/o.{{d}}.sam"
    res = run_both("indelfree", [f"in={tmp_path}/q.fa", f"ref={tmp_path}/ref.fa",
                                 f"out={out}", "subs=3", "minid=0"], [out])
    assert_equal(res, [out])
    sam = res["torch"][0][0]
    assert sam.count(b"\nsp1\t") == 3 and b"NM:i:2" in sam


@pytest.fixture(scope="module")
def long_ref(tmp_path_factory):
    """Two scaffolds, the first of 70,000 bp (two chunks); 12 queries of
    18-40 bp (one with an N), planted with 0-3 substitutions on either
    strand, one across the chunk edge at 65,536, two beside it and one
    cut by the scaffold's end; FASTQ queries too."""
    tmp = tmp_path_factory.mktemp("ifa")
    rng = np.random.default_rng(5)
    scafs = [ACGT[rng.integers(0, 4, 70_000)].copy(), ACGT[rng.integers(0, 4, 3_000)].copy()]
    queries = []
    for i in range(12):
        q = ACGT[rng.integers(0, 4, int(rng.integers(18, 41)))].copy()
        if i == 7:
            q[3] = ord("N")
        queries.append(q)
    edge = 1 << 16
    sites = [(0, edge - 10), (0, edge - 100), (0, edge + 50), (0, 70_000 - 20), (0, 12),
             (1, 100), (1, 2_960), (0, 40_000), (0, 5_000), (1, 1_500)]
    for i, (s, pos) in enumerate(sites):
        q = queries[i].copy()
        for j in rng.integers(0, len(q), i % 4):
            q[j] = ACGT[(ACGT.tolist().index(q[j]) + 1) % 4] if q[j] != ord("N") else q[j]
        seq = q.tobytes() if i % 2 else q.tobytes().translate(COMP)[::-1]
        seq = seq[: len(scafs[s]) - pos]
        scafs[s][pos:pos + len(seq)] = np.frombuffer(seq, np.uint8)
    (tmp / "ref.fa").write_bytes(b"".join(
        b">s%d desc\n%s\n" % (i, s.tobytes()) for i, s in enumerate(scafs)))
    (tmp / "q.fa").write_bytes(b"".join(
        b">q%d\n%s\n" % (i, q.tobytes()) for i, q in enumerate(queries)))
    (tmp / "q.fq").write_bytes(b"".join(
        b"@q%d x\n%s\n+\n%s\n" % (i, q.tobytes(), b"I" * len(q))
        for i, q in enumerate(queries)))
    return tmp


@pytest.mark.parametrize("flags", [["subs=3", "minid=0"], [], ["subs=2", "minid=0.9"]])
def test_indelfree_long_ref_equal_jax(long_ref, flags):
    out = f"{long_ref}/l.{{d}}.sam"
    res = run_both("indelfree", [f"in={long_ref}/q.fa", f"ref={long_ref}/ref.fa",
                                 f"out={out}", *flags], [out])
    assert_equal(res, [out])
    if flags == ["subs=3", "minid=0"]:
        body = [ln.split(b"\t") for ln in res["torch"][0][0].splitlines()
                if not ln.startswith(b"@")]
        pos = {(r[0], int(r[3])) for r in body}
        edge = 1 << 16
        assert {(b"q0", edge - 9), (b"q1", edge - 99), (b"q2", edge + 51)} <= pos


def test_indelfreealigner_fastq_queries_equal_jax(long_ref):
    out = f"{long_ref}/f.{{d}}.sam"
    res = run_both("indelfreealigner", [f"in={long_ref}/q.fq", f"ref={long_ref}/ref.fa",
                                        f"out={out}", "subs=3", "minid=0", "minqlen=20"],
                   [out])
    assert_equal(res, [out])


@pytest.mark.parametrize("budget", [1, 14_000_000, 1 << 40])
def test_indelfree_tiles_give_the_same_sam(long_ref, monkeypatch, budget):
    """One row a tile (a budget of one byte), two rows, all rows: the
    port's SAM is the JAX package's at every budget."""
    Q, C, L = 24, 1 << 16, 40
    rows = tif.tile_rows(Q, C, L, budget)
    assert rows == {1: 1, 14_000_000: 2, 1 << 40: Q}[budget]
    assert rows == 1 or tif.search_bytes(Q, C, L, rows) <= budget
    assert rows == Q or tif.search_bytes(Q, C, L, rows + 1) > budget
    assert tif.search_bytes(2, 10, 300, 1) == 5 * 2 * 10 + 10 * 5 * 300  # int32 sums
    monkeypatch.setattr(tif, "SEARCH_BUDGET", budget)
    out = f"{long_ref}/b{budget}.{{d}}.sam"
    res = run_both("indelfree", [f"in={long_ref}/q.fa", f"ref={long_ref}/ref.fa",
                                 f"out={out}", "subs=3", "minid=0"], [out])
    assert_equal(res, [out])
