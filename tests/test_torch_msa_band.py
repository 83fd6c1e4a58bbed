"""B4's band route on the CPU: how the wrapper cuts a call's tasks into
bands for the band kernel (`band_plan`, `band_k`), which kernel takes a
call too small for the warp kernel (`few_task_route`), the memory it counts
for the band kernel's boundary records (`task_bytes`, `fill_groups`), and
the plain fill, which the kernel is held to on the card, against the JAX
package's XLA wavefront at the lengths where bands meet. The kernel
itself runs only on the card (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbtools_torch.ops import msa_fill as tfill
from bbtools_torch.ops.msa_fill import (BAND_K, BAND_RESIDENT_WARPS_PER_SM, BLOCK_BUSY_ROWS,
                                        BLOCK_MAX_ROWS, band_edge_bytes, band_k, band_plan,
                                        few_task_route, fill_groups, msa_fill_plain,
                                        task_bytes)
from bbtools_tpu.ops import msa as jmsa
from bbtools_tpu.ops import msa_constants as C

H100_SMS = 132


def _live_rows(lens, Rp):
    return [max(0, min(int(n), Rp) + 1) for n in lens]


@pytest.mark.parametrize("lens,Rp,k", [
    ([31, 32, 33, 63, 64, 65], 65, None),  # 32K-1, 32K, 32K+1 rows at K = 1, 2
    ([0, 1, 6000, 1000, 5999], 6000, None),  # mapPacBio's widest class
    ([151] * 28, 151, None),  # class 3 of a BBMap batch
    ([255, 256, 257, 400, 300], 400, 8),  # a partial last band at K = 8
    ([20, 2000], 2000, 4),  # a task under one band beside one of many
    ([5, 0, 7], 9, 2),
    (list(range(257, 402)) * 11, 401, None),  # the long-read set's band tasks
])
def test_band_plan_covers_every_live_row_once(lens, Rp, k):
    lens_t = torch.tensor(lens, dtype=torch.int32)
    K, starts = band_plan(lens_t, Rp + 1, H100_SMS, k)
    assert K in BAND_K and (k is None or K == k)
    assert starts.dtype == torch.int32 and starts.shape == (len(lens) + 1,)
    assert int(starts[0]) == 0 and bool((starts[1:] > starts[:-1]).all())
    for s, nrows in enumerate(_live_rows(lens, Rp)):
        bands = range(int(starts[s + 1] - starts[s]))
        rows = [r for b in bands for r in range(32 * K * b, min(32 * K * (b + 1), nrows))]
        assert rows == list(range(nrows))  # each live row once, in order
        assert all(32 * K * b < nrows for b in bands)  # no band past the length
    # the kernel launches n_tasks * ceil(rows / 32K) warps: every band fits
    assert int(starts[-1]) <= len(lens) * -(-(Rp + 1) // (32 * K))


@pytest.mark.parametrize("rows,n,want", [
    (6001, 4, 1),  # mapPacBio's widest class: the most bands
    (152, 28, 1),
    (2001, 28, 1),
    (401, 1600, 2),  # the long-read set's tasks past 256 rows
    (401, 4096, 2),
    (1001, 132, 1),  # 4,224 bands of 32 rows: the card's resident warps
    (1001, 133, 2),
])
def test_band_k_takes_one_row_a_lane_while_the_bands_stay_resident(rows, n, want):
    K = band_k(rows, n, H100_SMS)
    assert K == want and K in BAND_K
    fits = n * -(-rows // 32) <= BAND_RESIDENT_WARPS_PER_SM * H100_SMS
    assert (K == 1) == fits


@pytest.mark.parametrize("rows,n,want", [
    (152, 28, "block"),  # class 3 of a BBMap batch
    (152, 1, "block"),
    (BLOCK_MAX_ROWS, 4, "block"),
    (BLOCK_MAX_ROWS + 1, 4, "band"),
    (601, 28, "band"),
    (601, 128, "block"),  # a task for every SM, one row a thread
    (BLOCK_BUSY_ROWS, 66, "block"),
    (BLOCK_BUSY_ROWS, 65, "band"),
    (BLOCK_BUSY_ROWS + 1, 128, "band"),
    (6001, 4, "band"),  # mapPacBio's widest class
])
def test_few_task_route_by_shape(rows, n, want):
    assert few_task_route(rows, n, H100_SMS) == want


@pytest.mark.parametrize("R,Cc", [(151, 175), (256, 2328), (6000, 13640), (1, 1)])
def test_task_bytes_counts_the_band_scratch(R, Cc):
    planes = (R + Cc - 1) * (R + 1)
    walk = 3 * (R + Cc)
    edges = band_edge_bytes(R, Cc)
    assert task_bytes(R, Cc) == planes + edges + walk
    # the most the band kernel allocates for one task: a record a column
    # for each of its bands at any K the plan may pick
    for K in BAND_K:
        assert -(-(R + 1) // (32 * K)) * (Cc + 1) * tfill.EDGE_BYTES <= edges


@pytest.mark.parametrize("n,R,Cc,per_budget", [(1536, 6000, 13640, 40.5), (50, 151, 175, 7.2),
                                               (9, 2000, 9640, 1.0)])
def test_fill_groups_stay_under_the_budget_with_the_scratch(n, R, Cc, per_budget):
    per = task_bytes(R, Cc)
    budget = int(per_budget * per)
    groups = fill_groups(n, R, Cc, budget)
    assert [i for g in groups for i in range(g.start, g.stop)] == list(range(n))
    for g in groups:
        assert (g.stop - g.start) * per <= max(budget, per)
        # planes and boundary records of the group under the budget
        assert (g.stop - g.start) * ((R + Cc - 1) * (R + 1) + band_edge_bytes(R, Cc)) \
            <= max(budget, per)


def _tasks(seed, lens, R, Cc):
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 4, (len(lens), Cc)).astype(np.uint8)
    refs[rng.random(refs.shape) < 0.02] = 4
    reads = np.full((len(lens), R), 4, np.uint8)
    for b, n in enumerate(lens):
        start = int(rng.integers(0, max(Cc - n, 1)))
        src = np.resize(refs[b, start : start + n + 3].copy(), n)
        if n > 12 and b % 2:  # a deletion of 3 reference bases
            src = np.resize(np.concatenate([src[: n // 2], src[n // 2 + 3 :]]), n)
        m = rng.random(n) < 0.06
        src[m] = (src[m] + 1) % 4
        reads[b, :n] = src
    return reads, np.asarray(lens, np.int32), refs


@pytest.mark.parametrize("lens,Cc", [([31, 32, 33, 0, 1, 66], 90), ([63, 64, 65, 20], 40)])
def test_fill_plain_at_band_edges_equals_jax(lens, Cc):
    """The plain fill, the card's yardstick for the band kernel, at the
    lengths where bands of 32 and 64 rows meet (and Cc < R'), against the
    JAX package's XLA wavefront: every output and every plane byte."""
    R = max(lens)
    reads, lens, refs = _tasks(R + Cc, lens, R, Cc)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = [x.numpy() for x in msa_fill_plain(
            torch.from_numpy(reads), torch.from_numpy(lens), torch.from_numpy(refs))]
    finally:
        torch.set_num_threads(n)
    B = len(lens)
    clens = np.full(B, Cc, np.int32)
    maxgain = (lens.astype(np.int64) - 1) * C.POINTS_MATCH2 + C.POINTS_MATCH
    vert, horiz, floor, _ = jmsa.prepare_limits_np(reads, lens, refs, clens,
                                                   np.zeros(B, np.int64))
    want = jmsa.msa_fill(
        R, Cc, False, True, jnp.asarray(reads), jnp.asarray(lens), jnp.asarray(refs),
        jnp.asarray(clens), jnp.asarray(vert.astype(np.int32)),
        jnp.asarray(horiz.astype(np.int32)), jnp.asarray(floor.astype(np.int32)),
        jnp.asarray((-2 * maxgain).astype(np.int32)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert (got[1][lens > 0] >= 0).all()
