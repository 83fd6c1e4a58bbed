"""The port's glocal identity aligner (`ops/idalign.py`, ROADMAP L5)
against the JAX package's on the CPU: `glocal_identity` equals
`glocal_identity_jnp` exactly (the identity's float32 bits, rstart,
rstop) on random ragged batches, rows built to tie in G (homopolymers,
tandem repeats, a two-letter alphabet), qlen 0, qlen past rlen, rlen 0
and all-N columns; `glocal_counts` gives glocal_align_np's identity and
coordinates task by task; the host engines of `make_id_aligner` equal
the JAX package's; `BandedIDAligner.align_batch` equals the JAX
package's where the JAX one runs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbtools_torch.ops import idalign as tid
from bbtools_tpu.ops import idalign as jid


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


def _jax(qs, ql, rs, rl):
    return [np.asarray(x) for x in jid.glocal_identity_jnp(
        jnp.asarray(qs), jnp.asarray(ql), jnp.asarray(rs), jnp.asarray(rl))]


def _assert_exact(qs, ql, rs, rl):
    """glocal_identity against glocal_identity_jnp, bit for bit, and
    glocal_counts against glocal_align_np on every task."""
    got = [x.numpy() for x in tid.glocal_identity(qs, ql, rs, rl, "cpu")]
    want = _jax(qs, ql, rs, rl)
    assert got[0].dtype == np.float32 and got[1].dtype == got[2].dtype == np.int32
    np.testing.assert_array_equal(got[0].view(np.int32), want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    m, c, s0, s1 = (x.numpy() for x in tid.glocal_counts(qs, ql, rs, rl, "cpu"))
    for t in range(len(qs)):
        host = jid.glocal_align_np(qs[t, : ql[t]], rs[t, : rl[t]])
        if ql[t] and rl[t]:
            assert (m[t] / c[t], int(s0[t]), int(s1[t])) == host, t
        else:
            assert (float(got[0][t]), int(got[1][t]), int(got[2][t])) == host, t
    return got


def _ragged(rng, T, M, N, alphabet=4, fill=4):
    qs = np.full((T, M), fill, np.uint8)
    rs = np.full((T, N), fill, np.uint8)
    ql = rng.integers(1, M + 1, T).astype(np.int32)
    rl = rng.integers(1, N + 1, T).astype(np.int32)
    for t in range(T):
        qs[t, : ql[t]] = rng.integers(0, alphabet, ql[t])
        rs[t, : rl[t]] = rng.integers(0, alphabet, rl[t])
    return qs, ql, rs, rl


@pytest.mark.parametrize("seed,alphabet", [(0, 4), (1, 4), (2, 2), (3, 1)])
def test_glocal_identity_equals_jax_on_ragged_batches(seed, alphabet):
    """Random ragged batches; queries that are mutated copies of a window
    of their reference (substitutions and 1-3 bp indels) beside unrelated
    pairs. Alphabets of 2 and 1 letter make most cells tie."""
    rng = np.random.default_rng(seed)
    qs, ql, rs, rl = _ragged(rng, 48, 40, 70, alphabet)
    for t in range(0, 48, 2):  # related pairs
        s = int(rng.integers(0, max(1, rl[t] - 30)))
        q = list(rs[t, s : s + int(rng.integers(10, 41))])
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, len(q)))
            kind = int(rng.integers(0, 3))
            if kind == 0:
                q[p] = int(rng.integers(0, alphabet))
            elif kind == 1:
                q.insert(p, int(rng.integers(0, alphabet)))
            elif len(q) > 1:
                del q[p]
        q = q[:40]
        ql[t] = len(q)
        qs[t] = 4
        qs[t, : len(q)] = q
    _assert_exact(qs, ql, rs, rl)


def test_glocal_identity_ties_go_to_the_latest_column():
    """Rows built to tie in G: homopolymer queries in longer homopolymers
    and tandem repeats (every placement scores alike), queries one base
    off a repeat, and the reference tie of align(AA, AGA) = 2/3."""
    cases = [("AAAA", "AAAAAAAAAA"), ("ACAC", "ACACACACACAC"), ("AA", "AGA"),
             ("AGA", "AA"), ("ACGACG", "ACGTACGACGT"), ("TTTT", "AAAA"),
             ("A", "AAAAAAAA"), ("CACA", "ACACACACA"), ("AAT", "AATAATAAT"),
             ("GGGGG", "GGGAGGGAGGG")]
    from bbtools_tpu.core.dna import encode

    M = max(len(q) for q, _ in cases)
    N = max(len(r) for _, r in cases)
    qs = np.full((len(cases), M), 4, np.uint8)
    rs = np.full((len(cases), N), 4, np.uint8)
    ql = np.array([len(q) for q, _ in cases], np.int32)
    rl = np.array([len(r) for _, r in cases], np.int32)
    for t, (q, r) in enumerate(cases):
        qs[t, : len(q)] = encode(q.encode())
        rs[t, : len(r)] = encode(r.encode())
    ident, rstart, rstop = _assert_exact(qs, ql, rs, rl)
    assert abs(float(ident[2]) - 2 / 3) < 1e-6
    # every placement of AAAA in A*10 scores 4: the final row's argmax
    # takes the first end, and the left gaps before it the latest entry
    assert (int(rstart[0]), int(rstop[0])) == (0, 3)


def test_glocal_identity_edge_lengths_and_all_n_columns():
    """qlen 0 (the output is row 0), qlen past rlen, rlen 0, queries and
    references of N only, and rows past a task's qlen in a batch whose
    longest query is much longer."""
    rng = np.random.default_rng(7)
    qs, ql, rs, rl = _ragged(rng, 24, 30, 20)
    ql[0:4] = 0
    ql[4:10] = np.minimum(rl[4:10] + rng.integers(1, 8, 6), 30)  # qlen > rlen
    rl[10:13] = 0
    rs[13:17] = 4  # all-N references
    qs[15:19] = 4  # all-N queries (N matches N, as in the JAX package)
    ql[19] = 30
    ql[20:] = 1
    _assert_exact(qs, ql, rs, rl)


def test_glocal_identity_key_holds_wide_references():
    """The t field at icecream's width: N = 10,001 columns need 14 bits,
    and the packed key stays within int64 with G at its extremes."""
    rng = np.random.default_rng(11)
    T, M, N = 4, 24, 10_001
    qs = rng.integers(0, 4, (T, M)).astype(np.uint8)
    rs = rng.integers(0, 4, (T, N)).astype(np.uint8)
    rs[0, -M:] = qs[0]  # the best placement at the far end
    ql = np.array([M, M, 7, 0], np.int32)
    rl = np.array([N, N - 3, 9, N], np.int32)
    ident, rstart, rstop = _assert_exact(qs, ql, rs, rl)
    assert float(ident[0]) == 1.0 and int(rstop[0]) == N - 1


def test_glocal_identity_takes_tensors_and_counts_no_cpu_call():
    rng = np.random.default_rng(5)
    qs, ql, rs, rl = _ragged(rng, 6, 12, 20)
    before = tid.glocal_identity.device_calls
    a = tid.glocal_identity(*(torch.from_numpy(x) for x in (qs, ql, rs, rl)), "cpu")
    b = tid.glocal_identity(qs, ql, rs, rl, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert tid.glocal_identity.device_calls == before


ENGINES = ["glocal", "glocalplus", "ssa2", "ssa3", "parallelogram", "quantum",
           "quantumplus", "quabble", "wobble", "wobbleplus", "scrabble", "crosscut",
           "diagonal", "xdrop", "xdroph", "wave", "wavefront", "drifting",
           "driftingplus", "banded", "bandedplus"]


@pytest.mark.parametrize("name", ENGINES)
def test_host_engines_equal_jax(name):
    """Each engine name of make_id_aligner gives the JAX package's
    identity and coordinates on related and unrelated pairs."""
    rng = np.random.default_rng(len(name))
    pairs = []
    for i in range(6):
        r = rng.integers(0, 4, int(rng.integers(60, 140))).astype(np.uint8)
        q = r[10:90].copy()
        q[rng.integers(0, len(q), i * 3)] = rng.integers(0, 4, i * 3)
        if i % 2:
            q = np.delete(q, int(rng.integers(0, len(q))))
        pairs.append((q, r if i < 5 else rng.integers(0, 4, 100).astype(np.uint8)))
    a, b = tid.make_id_aligner(name), jid.make_id_aligner(name)
    assert a.name() == b.name()
    for q, r in pairs:
        pa, pb = [0, 0], [0, 0]
        assert a.align(q, r, pa) == b.align(q, r, pb)
        assert pa == pb
    with pytest.raises(ValueError):
        tid.make_id_aligner("nosuch")


@pytest.mark.parametrize("L,max_edits", [(120, 40), (300, 75)])
def test_banded_align_batch_equals_jax(L, max_edits):
    """BandedIDAligner.align_batch (width 81) against the JAX package's
    on equal-width arrays; on arrays of two widths, against the JAX
    package's on both padded to the wider (the JAX version needs one
    width)."""
    rng = np.random.default_rng(L)
    B = 16
    q = rng.integers(0, 4, (B, L)).astype(np.uint8)
    r = q.copy()
    r[:, rng.integers(0, L, 10)] = rng.integers(0, 4, 10)
    r[::3, 5:] = q[::3, :-5]  # a 5 bp shift
    r[::5] = rng.integers(0, 4, (len(r[::5]), L))
    ql = rng.integers(L // 2, L + 1, B).astype(np.int32)
    rl = np.minimum(ql + rng.integers(-6, 7, B), L).astype(np.int32)
    got = tid.BandedIDAligner(max_edits).align_batch(q, ql, r, rl, "cpu")
    want = jid.BandedIDAligner(max_edits).align_batch(q, ql, r, rl)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    wide = np.pad(r, ((0, 0), (0, 9)))
    got = tid.BandedIDAligner(max_edits).align_batch(q, ql, wide, rl, "cpu")
    want = jid.BandedIDAligner(max_edits).align_batch(np.pad(q, ((0, 0), (0, 9))), ql,
                                                      wide, rl)
    np.testing.assert_array_equal(got, want)
