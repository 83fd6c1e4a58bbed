"""B2, the int64 cummax: the port's plain version and CPU wrapper against
jax.lax.cummax, the JAX package's own CPU path for the scan
(bbtools_tpu/ops/sort_join.py `_cummax_i64`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bbtools_torch.ops.scan import VARIANTS, cummax_i64, cummax_i64_variant, cummax_plain

I64_MIN = np.iinfo(np.int64).min


@pytest.mark.parametrize("n", [1, 7, 4096, 4097, 50_003])
def test_cummax_matches_lax_cummax(n):
    rng = np.random.default_rng(n)
    v = rng.integers(I64_MIN, np.iinfo(np.int64).max, n, dtype=np.int64)
    v[::13] = I64_MIN
    v[1::17] = -1
    want = np.asarray(jax.lax.cummax(jnp.asarray(v)))
    got = cummax_plain(torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(cummax_i64(torch.from_numpy(v)).numpy(), want)


def test_cummax_join_shaped_words():
    """Segment-start words (row << 17 | is_idx << 16 | id) with -1 between
    them, as the sorted join feeds the scan."""
    rng = np.random.default_rng(2)
    n = 30_000
    row = np.arange(n, dtype=np.int64)
    start = rng.random(n) < 0.2
    v = np.where(
        start, (row << 17) | (rng.integers(0, 2, n) << 16) | rng.integers(0, 1 << 16, n), -1
    )
    want = np.asarray(jax.lax.cummax(jnp.asarray(v)))
    np.testing.assert_array_equal(cummax_i64(torch.from_numpy(v)).numpy(), want)


def test_cummax_empty():
    assert cummax_i64(torch.zeros(0, dtype=torch.int64)).shape == (0,)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cummax_variants_run_only_on_the_card(variant):
    """The kernel's measurement variants have no plain version: a CPU
    tensor raises and counts no launch."""
    before = cummax_i64.launches
    with pytest.raises(ValueError, match="CUDA"):
        cummax_i64_variant(variant, torch.zeros(8, dtype=torch.int64))
    assert cummax_i64.launches == before
