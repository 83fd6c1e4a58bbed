"""kscan_combined of the port against the JAX package's, backend by
backend: the lane table and the sorted join (shared with the JAX package
through from_arrays) and the bucket table, packed and unpacked, with the
short-kmer end scans, maskMiddle, restrictLeft and qhdist; plus
credit_id."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bbtools_torch.ops import bbduk_scan as ts
from bbtools_torch.ops.kmer_index import BucketKmerIndex as PBucket
from bbtools_torch.ops.lane_index import LaneKmerIndex as PLane
from bbtools_torch.ops.sort_join import SortJoinIndex as PJoin
from bbtools_tpu.core.dna import encode
from bbtools_tpu.ops import bbduk_scan as js
from bbtools_tpu.ops.kmer_index import BucketKmerIndex, build_ref_keys
from bbtools_tpu.ops.kmers import middle_mask
from bbtools_tpu.ops.lane_index import LaneKmerIndex
from bbtools_tpu.ops.sort_join import SortJoinIndex

PANEL = [
    b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
    b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT",
    b"CTGTCTCTTATACACATCTCCGAGCCCACGAGAC",
]
K = 23


def _reads(seed, B=48, L=151):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, (B, L)).astype(np.uint8)
    bases[rng.random((B, L)) < 0.01] = 4
    lengths = rng.integers(60, L + 1, B).astype(np.int32)
    for i in range(B):
        ad = encode(PANEL[i % len(PANEL)])
        n = lengths[i]
        mode = i % 4
        if mode == 0:  # adapter tail from a random position
            p = int(rng.integers(30, n - 5))
            seg = ad[: n - p]
            bases[i, p : p + len(seg)] = seg
        elif mode == 1:  # short suffix of an adapter at the read end
            m = int(rng.integers(11, 20))
            bases[i, n - m : n] = ad[:m]
        elif mode == 2:  # short adapter suffix at the read start
            m = int(rng.integers(11, 20))
            bases[i, :m] = ad[-m:]
        if i % 5 == 0:  # one substitution inside the planted adapter
            q = int(rng.integers(0, n))
            bases[i, q] = (bases[i, q] + 1) % 4
        bases[i, n:] = 4
    return bases, lengths


def _tables(backend, keys, ids):
    """(jax static kwargs, jax table, port static kwargs, port table)."""
    if backend == "lane":
        j = LaneKmerIndex.build(keys, ids)
        p = PLane.from_arrays(j.tlo, j.thi, j.tid, *j.static_params())
        return (dict(lane=j.static_params()), j.device_arrays(),
                dict(lane=p.static_params()), p.device_arrays("cpu"))
    if backend == "join":
        j = SortJoinIndex.build(keys, ids)
        p = PJoin.from_arrays(j.keys, j.pay)
        return (dict(join=j.static_params()), j.device_arrays(),
                dict(join=p.static_params()), p.device_arrays("cpu"))
    pack = backend == "bucket_packed"
    j = BucketKmerIndex.build(keys, ids, pack=pack)
    p = PBucket.build(keys, ids, pack=pack)
    assert p.packed == j.packed == pack
    np.testing.assert_array_equal(p.keys, j.keys)
    kw = dict(nb=j.nb, packed=j.packed)
    return kw, j.device_arrays(), kw, p.device_arrays("cpu")


CASES = [
    # backend, mink, mask_middle, restrict_left, qhdist
    ("lane", 11, False, 0, 0),
    ("join", 11, False, 0, 0),
    ("bucket", 11, False, 0, 0),
    ("bucket_packed", 11, False, 0, 0),
    ("join", 0, True, 0, 0),
    ("lane", 11, False, 70, 0),
    # qhdist through the full scan's batched mutant lookup (the JAX
    # package compiles its qhdist short-end loop for minutes, so the
    # short-end loop is covered by the restrictLeft case)
    ("bucket", 0, False, 0, 1),
]


@pytest.mark.parametrize("backend,mink,mask_middle,restrict_left,qhdist", CASES)
def test_kscan_combined_matches_jax(backend, mink, mask_middle, restrict_left, qhdist):
    mm = middle_mask(K, 1) if mask_middle else -1
    keys, ids = build_ref_keys(
        [encode(s) for s in PANEL], K, mink=mink, hdist=1, mid_mask=mm
    )
    jkw, jtab, pkw, ptab = _tables(backend, keys, ids)
    common = dict(
        k=K, mink=mink, mid_mask=mm, minlen2=(K - 1) // 2 if mask_middle else K,
        restrict_left=restrict_left, qhdist=qhdist,
    )
    jcfg = js.KScanConfig(**common, **jkw)
    pcfg = ts.KScanConfig(**common, **pkw)
    bases, lengths = _reads(len(keys))
    short = mink > 0
    jout, jsl, jsr = js.kscan_combined(
        jcfg, jtab, jnp.asarray(bases), jnp.asarray(lengths), short, short
    )
    pout, psl, psr = ts.kscan_combined(
        pcfg, ptab, torch.from_numpy(bases), torch.from_numpy(lengths), short, short
    )
    assert set(pout) == set(jout)
    for name in jout:
        np.testing.assert_array_equal(pout[name].numpy(), np.asarray(jout[name]), name)
    assert int(pout["nhits"].sum()) > 0
    if short:
        for jt, pt in ((jsl, psl), (jsr, psr)):
            for j, p in zip(jt, pt):
                np.testing.assert_array_equal(p.numpy(), np.asarray(j))
        assert bool(psl[0].any()) and bool(psr[0].any())
    else:
        assert psl is None and psr is None
    ordinal = np.array([0, 1, 2, 5] * (len(bases) // 4), np.int32)
    want = js.credit_id(jcfg, jout["ids"], jnp.asarray(ordinal))
    got = ts.credit_id(pout["ids"], torch.from_numpy(ordinal))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
