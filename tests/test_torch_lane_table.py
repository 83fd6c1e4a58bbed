"""Kernel B6's plain version (`bbtools_torch.ops.lane_table`) against the
JAX package's Pallas kernel, run in interpret mode on the CPU, on the
same tables and indices: equal to the bit (f32 compared as int32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbtools_torch.ops import lane_table as tl
from bbtools_tpu.ops import lane_table as jl
from bbtools_tpu.ops.overlap import PROB_CORRECT4, incr_table


def _tables():
    rng = np.random.default_rng(3)
    odd = rng.standard_normal(2048).astype(np.float32)
    # bit patterns a value copy could disturb: -0, subnormals, inf, NaN
    odd[:6] = np.array([0x80000000, 0x00000001, 0x007FFFFF, 0x7F800000,
                        0xFF800000, 0x7FC00001], np.uint32).view(np.float32)
    return {
        "incr_0.95": incr_table(0.95),  # 1,025 entries, 9 rows
        "pc4": PROB_CORRECT4,  # 60 entries, 1 row
        "full_2048": odd,  # 16 rows
    }


@pytest.mark.parametrize("name", sorted(_tables()))
@pytest.mark.parametrize("shape", [(1,), (7, 33), (64, 290)])
def test_plain_matches_pallas_interpret(name, shape):
    table = _tables()[name]
    packed = jl.pack_table(table)
    np.testing.assert_array_equal(tl.pack_table(table), packed)
    rng = np.random.default_rng(len(shape))
    idx = rng.integers(0, len(table), shape).astype(np.int32)
    want = np.asarray(jl._lookup_pallas(jnp.asarray(packed), jnp.asarray(idx),
                                        interpret=True))
    before = tl.lookup.launches
    got = tl.lookup(torch.from_numpy(packed), torch.from_numpy(idx)).numpy()
    assert tl.lookup.launches == before  # a CPU tensor never launches
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_out_of_range_reads_zero_as_the_tpu_kernel():
    """The TPU kernel selects by row; an index past the table's padded
    rows, or a negative one, matches no row and reads 0."""
    packed = jl.pack_table(PROB_CORRECT4)  # 1 row of 128
    idx = np.array([[-1, 0, 59, 127, 128, 5000, -129]], np.int32)
    want = np.asarray(jl._lookup_pallas(jnp.asarray(packed), jnp.asarray(idx),
                                        interpret=True))
    got = tl.lookup(torch.from_numpy(packed), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[0, 0] == 0 and got[0, 4] == 0 and got[0, 2] == PROB_CORRECT4[59]


@pytest.mark.parametrize("n", [1, 3, 4, 5, 1029])
@pytest.mark.parametrize("offset", [0, 3])
def test_ragged_lengths_and_offset_views_match_pallas(n, offset):
    """Lengths around the kernel's 4-element vectors, and index views at
    an element offset, on the plain version against the TPU kernel."""
    packed = jl.pack_table(PROB_CORRECT4)
    rng = np.random.default_rng(n + offset)
    base = rng.integers(-2, 131, n + offset).astype(np.int32)
    want = np.asarray(jl._lookup_pallas(jnp.asarray(packed),
                                        jnp.asarray(base[offset:]), interpret=True))
    view = torch.from_numpy(base)[offset:]
    assert view.is_contiguous() and view.storage_offset() == offset
    got = tl.lookup(torch.from_numpy(packed), view).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_variants_run_only_on_the_card():
    """The kernel's measurement variants have no plain version: a CPU
    tensor raises and counts no launch."""
    packed = torch.from_numpy(jl.pack_table(PROB_CORRECT4))
    before = tl.lookup.launches
    for name in tl.VARIANTS:
        with pytest.raises(ValueError, match="CUDA"):
            tl.lookup_variant(name, packed, torch.zeros(8, dtype=torch.int32))
    assert tl.lookup.launches == before
