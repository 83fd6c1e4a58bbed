"""bbtools_torch.ops.kmers against bbtools_tpu.ops.kmers: the rolling
k-mer registers of the port equal the JAX package's, exactly (int64
bit patterns), on codes with undefined bases."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bbtools_torch.ops import kmers as tk
from bbtools_tpu.ops import kmers as jk


def _codes(seed, B=24, L=67, n_prob=0.04):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, (B, L)).astype(np.uint8)
    c[rng.random((B, L)) < n_prob] = 4
    c[0, :] = 4  # all undefined
    c[1, 5] = 4  # one early N
    c[2, -1] = 4
    return c


@pytest.mark.parametrize("k", [1, 11, 23, 31])
def test_rolling_kmers_match_jax(k):
    codes = _codes(k)
    want = jk.rolling_kmers_jnp(jnp.asarray(codes), k)
    got = tk.rolling_kmers(torch.from_numpy(codes), k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int64 and got[2].dtype == torch.int32


@pytest.mark.parametrize("k", [13, 23, 27])
def test_rolling_kmers_plain_match_jax(k):
    codes = _codes(100 + k)
    want = jk.rolling_kmers_plain_jnp(jnp.asarray(codes), k)
    got = tk.rolling_kmers_plain(torch.from_numpy(codes), k)
    assert len(got) == len(want) == 4
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rolling_kmers_match_host_oracle():
    codes = _codes(5)
    fwd, rkm, runlen = tk.rolling_kmers(torch.from_numpy(codes), 23)
    ofwd, orkm, orun = tk.rolling_kmers_np(codes, 23)
    np.testing.assert_array_equal(fwd.numpy(), ofwd)
    np.testing.assert_array_equal(rkm.numpy(), orkm)
    np.testing.assert_array_equal(runlen.numpy(), orun)
