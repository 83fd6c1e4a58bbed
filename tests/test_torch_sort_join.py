"""The sorted join of the port against bbtools_tpu's join_lookup_jnp over
one shared index (SortJoinIndex.from_arrays), including a query stream
past 1.5 * CHUNK that takes the chunked path."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bbtools_torch.ops import sort_join as ts
from bbtools_tpu.ops.sort_join import CHUNK, SortJoinIndex, join_lookup_jnp


def _index(rng, V):
    keys = np.unique(rng.choice(1 << 47, V, replace=False).astype(np.int64))
    ids = rng.integers(1, 1 << 16, len(keys)).astype(np.int32)
    jidx = SortJoinIndex.build(keys, ids)
    return jidx, ts.SortJoinIndex.from_arrays(jidx.keys, jidx.pay)


def _queries(rng, keys, nq):
    q = rng.integers(0, 1 << 47, nq, dtype=np.int64)
    hit = rng.random(nq) < 0.05
    q[hit] = keys[rng.integers(0, len(keys), int(hit.sum()))]
    return q


@pytest.mark.parametrize("nq", [1, 5000, CHUNK + CHUNK // 2 + 1])
def test_join_matches_jax(nq):
    rng = np.random.default_rng(nq)
    jidx, pidx = _index(rng, 3000)
    q = _queries(rng, jidx.keys, nq)
    want = np.asarray(join_lookup_jnp(*jidx.device_arrays(), jnp.asarray(q)))
    got = ts.join_lookup(*pidx.device_arrays("cpu"), torch.from_numpy(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), jidx.lookup_np(q))


def test_join_shapes_and_edge_cases():
    keys = np.array([5, 9, 100], np.int64)
    ids = np.array([3, 1, 7], np.int32)
    pidx = ts.SortJoinIndex.build(keys, ids)
    tbl = pidx.device_arrays("cpu")
    q = torch.tensor([[5, 6], [100, 0], [9, 9]], dtype=torch.int64)
    assert ts.join_lookup(*tbl, q).tolist() == [[3, 0], [7, 0], [1, 1]]
    # duplicate query keys, all-miss batch, boundary keys, -1 pad keys
    q2 = torch.tensor([4, 101, 5, 5, 5, -1], dtype=torch.int64)
    assert ts.join_lookup(*tbl, q2).tolist() == [0, 0, 3, 3, 3, 0]


def test_join_port_build_equals_jax_build():
    rng = np.random.default_rng(4)
    jidx, _ = _index(rng, 1000)
    p = ts.SortJoinIndex.build(jidx.keys, (jidx.pay & 0xFFFF).astype(np.int32))
    np.testing.assert_array_equal(p.keys, jidx.keys)
    np.testing.assert_array_equal(p.pay, jidx.pay)
