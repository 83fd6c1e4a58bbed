"""B1, the lane-table lookup: the port's plain version against the JAX
package's Pallas kernel (interpret mode) and its XLA emulation, packed
and unpacked, over tables the JAX package built (shared through
LaneKmerIndex.from_arrays)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bbtools_torch.ops import lane_index as tl
from bbtools_tpu.ops.lane_index import LaneKmerIndex, _lookup_pallas, _lookup_xla


def _mk_keys(rng, n, hi_bits=False, big_ids=False):
    # kmer-like keys: payload bits plus a length-tag bit above them;
    # hi_bits (keys up to 2**62) and big ids drive the unpacked layout
    top = 62 if hi_bits else 44
    keys = rng.integers(0, 1 << top, size=4 * n, dtype=np.int64) | (
        np.int64(1) << top
    )
    keys = np.unique(keys)[:n]
    lo = 1 << 17 if big_ids else 1
    ids = rng.integers(lo, lo + 1000, size=len(keys), dtype=np.int32)
    return keys, ids


def _queries(rng, keys, n_absent, top):
    q = np.concatenate(
        [keys[::2], rng.integers(0, 1 << top, size=n_absent, dtype=np.int64),
         np.zeros(3, np.int64), np.full(2, -1, np.int64)]
    )
    rng.shuffle(q)
    return q


def _port_index(jidx):
    return tl.LaneKmerIndex.from_arrays(
        jidx.tlo, jidx.thi, jidx.tid, *jidx.static_params()
    )


@pytest.mark.parametrize("hi_bits,big_ids", [(False, False), (True, True)])
def test_lane_plain_matches_jax_kernel(hi_bits, big_ids):
    rng = np.random.default_rng(11 + hi_bits)
    keys, ids = _mk_keys(rng, 2000, hi_bits, big_ids)
    jidx = LaneKmerIndex.build(keys, ids)
    assert jidx is not None and jidx.packed == (not hi_bits)
    q = _queries(rng, keys, 2000, 63 if hi_bits else 45)
    q2 = q[: len(q) // 2 * 2].reshape(2, -1)  # 2-D shape: pad/reshape path
    tlo, thi, tid = jidx.device_arrays()
    params = jidx.static_params()
    want_xla = np.asarray(_lookup_xla(tlo, thi, tid, *params, jnp.asarray(q2)))
    want_pallas = np.asarray(
        _lookup_pallas(tlo, thi, tid, *params, jnp.asarray(q2), interpret=True)
    )
    np.testing.assert_array_equal(want_xla, want_pallas)
    pidx = _port_index(jidx)
    got = tl.lane_lookup(*pidx.device_arrays("cpu"), *pidx.static_params(),
                         torch.from_numpy(q2))
    assert got.dtype == torch.int32 and got.shape == q2.shape
    np.testing.assert_array_equal(got.numpy(), want_xla)
    assert (got.numpy() > 0).sum() == len(keys[::2])


def test_lane_packed_and_unpacked_layouts_agree():
    """The same table in both layouts (the unpacked one derived from the
    packed), as the GPU smoke run compares them."""
    rng = np.random.default_rng(3)
    keys, ids = _mk_keys(rng, 1500)
    jidx = LaneKmerIndex.build(keys, ids)
    assert jidx.packed
    q = torch.from_numpy(_queries(rng, keys, 1500, 45))
    packed = _port_index(jidx)
    unpacked = tl.LaneKmerIndex.from_arrays(
        jidx.tlo, jidx.thi >> 16, jidx.thi & 0xFFFF, jidx.nb, jidx.groups,
        jidx.slots, jidx.rows, jidx.salt, False)
    outs = [
        tl.lookup_plain(*i.device_arrays("cpu"), *i.static_params(), q)
        for i in (packed, unpacked)
    ]
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())
    np.testing.assert_array_equal(outs[0].numpy(), jidx.lookup_np(q.numpy()))


def test_lane_port_build_equals_jax_build():
    rng = np.random.default_rng(9)
    keys, ids = _mk_keys(rng, 3000)
    j = LaneKmerIndex.build(keys, ids)
    p = tl.LaneKmerIndex.build(keys, ids)
    assert p.static_params() == j.static_params()
    for a in ("tlo", "thi", "tid"):
        np.testing.assert_array_equal(getattr(p, a), getattr(j, a))


def test_lane_hash_matches_host_hash():
    """The overflow-free int64 hash of the plain version equals the int32
    wraparound hash of the host builder."""
    rng = np.random.default_rng(21)
    q = rng.integers(-(1 << 62), 1 << 62, 5000, dtype=np.int64)
    lo = (q & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi = (q >> 32).astype(np.int32)
    qt = torch.from_numpy(q)
    for nb, salt in ((128, 0), (1024, 5), (128 << 10, 7)):
        want = tl._hash32_np(lo, hi, salt, nb)
        h = (tl._mul32(qt & tl._M32, int(tl.C1))
             + tl._mul32((qt >> 32) & tl._M32, int(tl.C2)) + salt) & tl._M32
        h = tl._mul32(h ^ ((h >> 15) & 0x1FFFF), int(tl.C3))
        got = (h >> (33 - nb.bit_length())) & (nb - 1)
        np.testing.assert_array_equal(got.numpy(), want)


def test_lane_plain_on_a_table_at_the_cost_cap_matches_jax():
    """The largest layout LaneKmerIndex.build makes: 70,000 keys at groups x
    slots = MAX_COST (1,280), 768 KB a plane, past any block's shared
    memory (the table the L2-probe kernel serves), against the JAX
    package's host lookup on a table the JAX package's build made."""
    rng = np.random.default_rng(70)
    keys, ids = _mk_keys(rng, 70_000)
    jidx = LaneKmerIndex.build(keys, ids)
    assert jidx is not None
    assert jidx.groups * jidx.slots == tl.LaneKmerIndex.MAX_COST
    assert jidx.tlo.nbytes > 227 * 1024
    q = _queries(rng, keys, 60_000, 45)
    pidx = _port_index(jidx)
    got = tl.lane_lookup(*pidx.device_arrays("cpu"), *pidx.static_params(),
                         torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), jidx.lookup_np(q))
    assert (got.numpy() > 0).sum() == len(keys[::2])
