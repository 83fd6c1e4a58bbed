"""The port's sorted and hash k-mer indexes (ops/kmer_index.py
SortedKmerIndex, HashKmerIndex) and the host k-mer helpers `kmer_mask`
and `rc_kmer` against the JAX package's, on the CPU: the torch lookups
equal `lookup_jnp` and `lookup_np` on tests/test_kmers.py's cases, and
on keys whose low 32 bits are 2^31 or more (the lo lane wraps negative
as numpy's astype(int32) wraps it)."""

import jax
import numpy as np
import pytest
import torch

from bbtools_torch.ops import kmer_index as tki
from bbtools_torch.ops import kmers as tk
from bbtools_tpu.ops import kmer_index as jki
from bbtools_tpu.ops import kmers as jk

K = 23


def _panel_and_queries(case):
    """(keys, ids, queries) int64/int32: test_kmers.py's panel of three
    random 500 bp scaffolds at k=23 with every hundredth key and 200
    random 47-bit queries; "lo_lane" adds keys and queries whose low 32
    bits have bit 31 set (and some with bit 63 set)."""
    rng = np.random.default_rng(42)
    seqs = [rng.integers(0, 4, 500).astype(np.uint8) for _ in range(3)]
    keys, ids = jki.build_ref_keys(seqs, K, hdist=0)
    queries = np.concatenate(
        [keys[:: max(1, len(keys) // 100)], rng.integers(0, 1 << 47, 200)]
    ).astype(np.int64) | np.int64(jk.length_mask(K))
    if case == "lo_lane":
        extra = (rng.integers(0, 1 << 30, 300).astype(np.int64) << 32) \
            | rng.integers(1 << 31, 1 << 32, 300).astype(np.int64)
        extra[:20] |= np.int64(-(1 << 63))
        keys = np.concatenate([keys, extra[:200]])
        ids = np.concatenate([ids, np.arange(1, 201, dtype=ids.dtype)])
        order = np.argsort(keys, kind="stable")
        keys, ids = keys[order], ids[order]
        queries = np.concatenate([queries, extra, extra[:50] ^ 1])
        assert ((keys & 0xFFFFFFFF) >= 1 << 31).sum() >= 200
    return keys, ids.astype(np.int32), queries


@pytest.mark.parametrize("case", ["test_kmers", "lo_lane"])
@pytest.mark.parametrize("builder", ["sorted", "hash"])
def test_index_lookup_equals_jax(builder, case):
    keys, ids, queries = _panel_and_queries(case)
    want = jki.SortedKmerIndex(keys, ids).lookup_np(queries)
    assert (want > 0).sum() >= 100 and (want == 0).sum() >= 100
    q = torch.from_numpy(queries)
    if builder == "sorted":
        tidx = tki.SortedKmerIndex(keys, ids)
        jidx = jki.SortedKmerIndex(keys, ids)
        jax_got = np.asarray(jki.SortedKmerIndex.lookup_jnp(*jidx.device_arrays(), queries))
        got = tki.SortedKmerIndex.lookup(*tidx.device_arrays("cpu"), q)
        assert tidx.n == jidx.n
    else:
        tidx = tki.HashKmerIndex.build(keys, ids)
        jidx = jki.HashKmerIndex.build(keys, ids)
        for a, b in zip(tidx.device_arrays("cpu"), jidx.device_arrays()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert (tidx.cap, tidx.max_probe, tidx.n) == (jidx.cap, jidx.max_probe, jidx.n)
        f = jax.jit(lambda x: jki.HashKmerIndex.lookup_jnp(
            *jidx.device_arrays(), jidx.cap, jidx.max_probe, x))
        jax_got = np.asarray(f(queries))
        got = tki.HashKmerIndex.lookup(*tidx.device_arrays("cpu"), tidx.cap,
                                       tidx.max_probe, q)
    np.testing.assert_array_equal(tidx.lookup_np(queries), want)
    assert got.dtype == torch.int32 and got.shape == q.shape
    np.testing.assert_array_equal(got.numpy(), jax_got)
    np.testing.assert_array_equal(got.numpy(), want)
    # a [rows, cols] query plane gives the same ids in its shape
    plane = q[: (len(q) // 4) * 4].reshape(4, -1)
    if builder == "sorted":
        got2 = tki.SortedKmerIndex.lookup(*tidx.device_arrays("cpu"), plane)
    else:
        got2 = tki.HashKmerIndex.lookup(*tidx.device_arrays("cpu"), tidx.cap,
                                        tidx.max_probe, plane)
    np.testing.assert_array_equal(got2.numpy().reshape(-1), want[: plane.numel()])


def test_empty_sorted_index_misses():
    idx = tki.SortedKmerIndex(np.zeros(0, np.int64), np.zeros(0, np.int32))
    q = np.array([1, 5, 1 << 40], np.int64)
    assert not idx.lookup_np(q).any()
    assert not tki.SortedKmerIndex.lookup(*idx.device_arrays("cpu"), torch.from_numpy(q)).any()


@pytest.mark.parametrize("k", [1, 13, 23, 31])
def test_kmer_mask_and_rc_kmer_equal_jax(k):
    rng = np.random.default_rng(k)
    assert tk.kmer_mask(k) == jk.kmer_mask(k)
    for kmer in [0, jk.kmer_mask(k), *rng.integers(0, 1 << (2 * k), 20).tolist()]:
        assert tk.rc_kmer(int(kmer), k) == jk.rc_kmer(int(kmer), k)
        assert tk.rc_kmer(tk.rc_kmer(int(kmer), k), k) == int(kmer)
