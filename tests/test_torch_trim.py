"""optimal_trim (float32 Kadane, column order) against the JAX package's
optimal_trim_jnp and the host loop oracle, exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bbtools_torch.core.qualtools import phred_to_prob_error
from bbtools_torch.ops.trim import optimal_trim, optimal_trim_np
from bbtools_tpu.ops.trim import optimal_trim_jnp


@pytest.mark.parametrize("trimq", [6.0, 10.0, 20.0, 0.5])
def test_optimal_trim_matches_jax(trimq):
    rng = np.random.default_rng(int(trimq * 10))
    B, L = 64, 97
    quals = rng.integers(0, 42, (B, L)).astype(np.uint8)
    quals[::5, :10] = 2  # low-quality heads
    quals[1::7, -15:] = 1  # low-quality tails
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    is_n = rng.random((B, L)) < 0.03
    avg = float(np.float32(phred_to_prob_error(trimq)))
    wl, wr = optimal_trim_jnp(
        jnp.asarray(quals), jnp.asarray(lengths), jnp.asarray(is_n), avg
    )
    gl, gr = optimal_trim(
        torch.from_numpy(quals), torch.from_numpy(lengths),
        torch.from_numpy(is_n), avg,
    )
    assert gl.dtype == torch.int32 and gr.dtype == torch.int32
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    ol, orr = optimal_trim_np(quals, lengths, is_n, avg)
    np.testing.assert_array_equal(gl.numpy(), ol)
    np.testing.assert_array_equal(gr.numpy(), orr)
