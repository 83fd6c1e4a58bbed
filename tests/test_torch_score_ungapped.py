"""The port's ungapped scoreNoIndels (ops/score_ungapped.py, torch)
against the JAX package's and against the host oracle, on the CPU: the
fixed-offset scan of the fused and staged map phases and the sliding
scan of mate rescue. Integer scores: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbtools_torch.ops import score_ungapped as T
from bbtools_tpu.ops import score_ungapped as J


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU runs: the suite runs several
    test processes on shared cores, where torch's thread pool, woken at
    each of the plain fill's many small ops, stalls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sites(seed, B, R, W):
    """Reads planted in their windows at offsets that run off either
    end, with substitutions, N in reads and windows, mixed lengths."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (B, R)).astype(np.uint8)
    refs = rng.integers(0, 4, (B, W)).astype(np.uint8)
    starts = rng.integers(-R // 3, W - 2 * R // 3, B).astype(np.int32)
    for b in range(0, B, 2):
        s = int(starts[b])
        lo, hi = max(s, 0), min(s + R, W)
        refs[b, lo:hi] = reads[b, lo - s : hi - s]
        m = rng.random(R) < 0.05
        reads[b][m] = (reads[b][m] + 1) % 4
    reads[rng.random((B, R)) < 0.02] = 4
    refs[rng.random((B, W)) < 0.02] = 4
    lens = rng.integers(R // 2, R + 1, B).astype(np.int32)
    lens[:4] = R
    for b in range(B):
        reads[b, lens[b]:] = 4
    ref_lens = np.where(np.arange(B) % 5 == 0, W - rng.integers(0, R, B), W)
    return reads, lens, refs, starts, ref_lens.astype(np.int32)


@pytest.mark.parametrize("R,W", [(60, 90), (151, 311), (37, 37)])
def test_score_no_indels_equals_jax_and_oracle(R, W):
    reads, lens, refs, starts, ref_lens = _sites(R + W, 40, R, W)
    got = T.score_no_indels(R, *(torch.from_numpy(x) for x in
                                 (reads, lens, refs, starts, ref_lens)))
    want = J.score_no_indels(R, *(jnp.asarray(x) for x in
                                  (reads, lens, refs, starts, ref_lens)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for b in range(40):
        n = int(lens[b])
        if n == R and ref_lens[b] == W:
            assert got[b] == T.score_no_indels_np(reads[b], refs[b], int(starts[b]))
            assert got[b] == J.score_no_indels_np(reads[b], refs[b], int(starts[b]))


@pytest.mark.parametrize("R,NOFF", [(40, 1), (40, 77), (151, 300)])
def test_score_no_indels_offsets_equals_jax(R, NOFF):
    rng = np.random.default_rng(R * NOFF)
    Cn = 12
    reads = rng.integers(0, 4, (Cn, R)).astype(np.uint8)
    wins = np.full((Cn, NOFF + R - 1), 4, np.uint8)
    wins[:, 3 : NOFF + R - 5] = rng.integers(0, 4, (Cn, NOFF + R - 8))
    for c in range(Cn):
        o = int(rng.integers(0, NOFF))
        seg = wins[c, o : o + R]
        seg[seg < 4] = reads[c][: len(seg)][seg < 4]
    reads[rng.random((Cn, R)) < 0.02] = 4
    lens = rng.integers(R // 2, R + 1, Cn).astype(np.int32)
    got = T.score_no_indels_offsets(R, NOFF, *(torch.from_numpy(x) for x in
                                               (reads, lens, wins)))
    want = J.score_no_indels_offsets(R, NOFF, *(jnp.asarray(x) for x in
                                                (reads, lens, wins)))
    assert got.shape == (Cn, NOFF) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.max(1).values > 20 * R).all()  # each read found its offset
