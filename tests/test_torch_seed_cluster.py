"""BBMap's device seed-and-cluster (ops/seed_cluster.py) against the JAX
package's `seed_candidates_jnp` and the host `candidates_for_batch` of
both packages, on the CPU: tests/test_bbmap_modes.py's 300,000 bp genome
and 64 reads. All nine outputs compare exactly, the padding rows too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbtools_torch.io.fasta import load_reference, write_fasta
from bbtools_torch.models.bbmap import BBMap, BBMapConfig
from bbtools_torch.models.bbmap_index import SeedIndex
from bbtools_torch.ops import seed_cluster
from bbtools_torch.utils.synth import random_genome
from bbtools_tpu.models.bbmap import BBMap as JBBMap
from bbtools_tpu.models.bbmap import BBMapConfig as JBBMapConfig
from bbtools_tpu.ops.seed_cluster import seed_candidates_jnp

NAMES = ("read", "diag", "strand", "votes", "spread", "modal", "n_out", "ok", "nclusters")


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """The genome's index, the port's and the JAX package's BBMap on it,
    and 64 reads of 60-151 bp (odd ones reverse-complemented, 2% errors,
    an N in every seventh)."""
    tmp = tmp_path_factory.mktemp("seed")
    rng = np.random.default_rng(6)
    write_fasta(str(tmp / "ref.fa"), random_genome(300_000, n_scaffolds=2, seed=14))
    ref = load_reference(str(tmp / "ref.fa"))
    idx = SeedIndex.build(ref, k=13)
    B, L = 64, 151
    bases = np.full((B, L), 4, np.uint8)
    lengths = np.zeros(B, np.int64)
    for i in range(B):
        ln = int(rng.integers(60, L + 1))
        codes = ref.scaffold_codes(int(rng.integers(0, 2)))
        p = int(rng.integers(0, len(codes) - ln))
        r = codes[p : p + ln].copy()
        if i & 1:
            r = (3 - r[::-1]).astype(np.uint8)
        e = rng.random(ln) < 0.02
        r[e] = (r[e] + 1) % 4
        if i % 7 == 0:
            r[ln // 2] = 4  # an N
        bases[i, :ln] = r
        lengths[i] = ln
    tool = BBMap(BBMapConfig(device="cpu"), index=idx)
    return tool, JBBMap(JBBMapConfig(), index=idx), idx, bases, lengths


def _args(tool, idx, bases, lengths, t_cap=None):
    keys, vmask, offs, K = tool._seed_slots(bases, lengths)
    cfg = tool.cfg
    B = bases.shape[0]
    bridge = min(cfg.max_indel, cfg.window_extras[-1] - 2 * cfg.pad)
    t_cap = t_cap or 1 << max(14, (4 * B * K).bit_length())
    arrays = (keys[0].astype(np.int32), keys[1].astype(np.int32), vmask[0], vmask[1], offs,
              idx.starts.astype(np.int32), idx.sites.astype(np.int32))
    return arrays, (B, K, t_cap, 2 * B * cfg.max_sites, cfg.max_sites, int(bridge))


def _both(tool, idx, bases, lengths, t_cap=None):
    arrays, static = _args(tool, idx, bases, lengths, t_cap)
    got = seed_cluster.seed_candidates(*(torch.from_numpy(a) for a in arrays), *static)
    want = seed_candidates_jnp(*(jnp.asarray(a) for a in arrays), *static)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def test_seed_candidates_equal_jax_and_the_host(batch):
    tool, jtool, idx, bases, lengths = batch
    got, want = _both(tool, idx, bases, lengths)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert bool(got[7]), "t_cap overflow"
    n = int(got[6])
    for host in (tool.candidates_for_batch(bases, lengths),
                 jtool.candidates_for_batch(bases, lengths)):
        assert n == len(host[0])
        for name, h, g in zip(NAMES, host[:6], got[:6]):
            np.testing.assert_array_equal(h.astype(np.int64), g[:n].astype(np.int64),
                                          err_msg=name)
        np.testing.assert_array_equal(host[6].astype(np.int64), got[8].astype(np.int64))
    # clusters of several seeds and reads seeded on both strands
    assert (got[3][:n] > 1).any() and set(got[2][:n].tolist()) == {0, 1}


def test_seed_candidates_overflow_flags_and_equals_jax(batch):
    """A static site cap under the batch's seed hits: ok=False on both
    sides, and the truncated expansion's outputs still equal."""
    tool, _, idx, bases, lengths = batch
    got, want = _both(tool, idx, bases, lengths, t_cap=1 << 10)
    assert not bool(got[7]) and not bool(want[7])
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
