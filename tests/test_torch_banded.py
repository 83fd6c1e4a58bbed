"""The port's banded edit distance (`ops/banded.py`, ROADMAP L6) and its
splitmix64 on int64 tensors (`ops/kmer_index.mix64_t`) against the JAX
package's on the CPU: `banded_edits` element for element equal to
`banded_edits_jnp` and held to `banded_edits_np` as the reference's own
test holds the JAX version (equal within max_edits, above it where the
band broke), on random pairs with band-exceeded pairs and lengths 0 and
1; `mix64_t` bit for bit equal to `_mix64` on keys with the sign bit
set."""

import numpy as np
import pytest
import torch

from bbtools_torch.ops import banded as tb
from bbtools_torch.ops.kmer_index import _bucket_of, mix64_t
from bbtools_tpu.ops import banded as jb
from bbtools_tpu.ops.kmer_index import _mix64


def _pairs(seed: int, P: int, L: int):
    """P (query, ref) pairs padded to L, the query the shorter: copies,
    1-3 substitutions and indels, unrelated pairs (past any band), N
    bases, and every length from 0 up, 0 and 1 among them."""
    rng = np.random.default_rng(seed)
    qs = np.full((P, L), 4, np.uint8)
    rs = np.full((P, L), 4, np.uint8)
    ql = np.zeros(P, np.int32)
    rl = np.zeros(P, np.int32)
    for t in range(P):
        n = t % 3 if t < 6 else int(rng.integers(0, L + 1))
        a = rng.integers(0, 5 if t % 7 == 0 else 4, n).astype(np.uint8)
        b = a.copy()
        for _ in range(int(rng.integers(0, 4))):
            if not len(b):
                break
            p = int(rng.integers(0, len(b)))
            op = int(rng.integers(0, 3))
            if op == 0:
                b[p] = (b[p] + 1) % 4
            elif op == 1:
                b = np.delete(b, p)
            else:
                b = np.insert(b, p, rng.integers(0, 4))
        b = b[:L]
        if t % 5 == 4:
            b = rng.integers(0, 4, int(rng.integers(0, L + 1))).astype(np.uint8)
        q, r = (a, b) if len(a) <= len(b) else (b, a)
        qs[t, :len(q)], rs[t, :len(r)] = q, r
        ql[t], rl[t] = len(q), len(r)
    return qs, ql, rs, rl


@pytest.mark.parametrize("max_edits", [0, 1, 2, 4, 6])
@pytest.mark.parametrize("exact", [True, False])
def test_banded_edits_equals_jax_and_host(max_edits, exact):
    import jax.numpy as jnp

    qs, ql, rs, rl = _pairs(max_edits, 160, 36)
    got = tb.banded_edits(*map(torch.from_numpy, (qs, ql, rs, rl)), max_edits, exact)
    assert got.dtype == torch.int32
    got = got.numpy()
    want = np.asarray(jb.banded_edits_jnp(*map(jnp.asarray, (qs, ql, rs, rl)),
                                          max_edits, exact))
    np.testing.assert_array_equal(got, want)
    host = np.array([jb.banded_edits_np(qs[t, :ql[t]], rs[t, :rl[t]], max_edits, exact)
                     for t in range(len(qs))])
    within = host <= max_edits
    np.testing.assert_array_equal(got[within], host[within])
    assert (got[~within] > max_edits).all()
    assert within.any() and (~within).any()  # both sides of the band
    assert (got[(ql == 0)] == 0).all() and (ql <= 1).sum() >= 4


def test_align_pairs_swaps_like_jax():
    import jax.numpy as jnp

    qs, ql, rs, rl = _pairs(11, 96, 30)
    swap = np.arange(96) % 2 == 1  # hand every other pair over longer-first
    a, b = np.where(swap[:, None], rs, qs), np.where(swap[:, None], qs, rs)
    al, bl = np.where(swap, rl, ql), np.where(swap, ql, rl)
    got = tb.align_pairs(*map(torch.from_numpy, (a, al, b, bl)), 3).numpy()
    want = np.asarray(jb.align_pairs_jnp(*map(jnp.asarray, (a, al, b, bl)), 3))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tb.banded_edits(*map(torch.from_numpy, (qs, ql, rs, rl)), 3).numpy())


def test_banded_edits_counts_no_cpu_call():
    tb.banded_edits.device_calls = 0
    qs, ql, rs, rl = _pairs(3, 8, 12)
    tb.banded_edits(*map(torch.from_numpy, (qs, ql, rs, rl)), 2)
    assert tb.banded_edits.device_calls == 0


def test_mix64_t_is_the_host_mix_bit_for_bit():
    rng = np.random.default_rng(5)
    keys = rng.integers(-(1 << 63), (1 << 63) - 1, 20_000, dtype=np.int64)
    keys[:6] = [0, 1, -1, -(1 << 63), (1 << 63) - 1, (1 << 62)]
    assert (keys < 0).sum() > 9_000  # the sign bit set in about half
    got = mix64_t(torch.from_numpy(keys)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, _mix64(keys.view(np.uint64)))
    for nb in (64, 1 << 20):
        np.testing.assert_array_equal(
            _bucket_of(torch.from_numpy(keys), nb).numpy(),
            (_mix64(keys.view(np.uint64)) & np.uint64(nb - 1)).astype(np.int64))
