"""The port's BBMerge overlap ops (`bbtools_torch.ops.overlap`,
`ops.overlap_scan`) on the CPU against the JAX package's device and host
versions on the same seeded inputs. Tolerance: exact equality, f32
compared bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbtools_torch.ops import overlap as T
from bbtools_torch.ops.overlap_scan import (VARIANTS, overlap_counts, overlap_counts_plain,
                                            overlap_counts_variant)
from bbtools_tpu.ops import overlap as J
from bbtools_tpu.ops.overlap_pallas import overlap_counts_pallas


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _pairs(seed, B=57, L=51, lo=10):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 5, (B, L)).astype(np.uint8)  # code 4 is N
    b = rng.integers(0, 5, (B, L)).astype(np.uint8)
    alens = rng.integers(lo, L + 1, B).astype(np.int32)
    blens = rng.integers(lo, L + 1, B).astype(np.int32)
    aq = rng.integers(0, 42, (B, L)).astype(np.uint8)
    bq = rng.integers(0, 42, (B, L)).astype(np.uint8)
    return a, b, alens, blens, aq, bq


@pytest.mark.parametrize("min0,D", [(5, 94), (12, 40), (54, 9), (1, 120)])
def test_overlap_counts_match_xla_and_pallas(min0, D):
    """B5's plain version against overlap_counts_jnp and the Pallas
    kernel in interpret mode, with N codes, unequal lengths and inserts
    past alen + blen (empty windows)."""
    a, b, alens, blens, _, _ = _pairs(7)
    args = tuple(jnp.asarray(x) for x in (a, b, alens, blens))
    ref = J.overlap_counts_jnp(*args, min0, D)
    pal = overlap_counts_pallas(*args, min0, D, interpret=True)
    got = overlap_counts(_t(a), _t(b), _t(alens), _t(blens), min0, D)
    plain = overlap_counts_plain(_t(a), _t(b), _t(alens), _t(blens), min0, D)
    for r, p, g, q in zip(ref, pal, got, plain):
        assert g.dtype == torch.int32 and g.shape == (a.shape[0], D)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
        np.testing.assert_array_equal(g.numpy(), q.numpy())


@pytest.mark.parametrize("codes", ["0..255", "0..15", "pad9"])
@pytest.mark.parametrize("min0,D", [(1, 110), (12, 40)])
def test_overlap_counts_any_code_match_xla_and_pallas(codes, min0, D):
    """The contract the CUDA kernel keeps on codes outside 0..4: the
    plain version equals overlap_counts_jnp and the Pallas kernel in
    interpret mode on codes from 0..255 (half of b's bytes copied from
    a, so every code also matches), from 0..15, and on 0..4 with the JAX
    package's pad code 9 in the data; good counts only codes below 4."""
    rng = np.random.default_rng(len(codes) + D)
    a, b, alens, blens, _, _ = _pairs(13)
    if codes == "pad9":
        a[rng.random(a.shape) < 0.1] = 9
        b[rng.random(b.shape) < 0.1] = 9
    else:
        hi = 256 if codes == "0..255" else 16
        a = rng.integers(0, hi, a.shape).astype(np.uint8)
        b = rng.integers(0, hi, b.shape).astype(np.uint8)
        same = rng.random(a.shape) < 0.5
        b[same] = a[same]
    args = tuple(jnp.asarray(x) for x in (a, b, alens, blens))
    ref = J.overlap_counts_jnp(*args, min0, D)
    pal = overlap_counts_pallas(*args, min0, D, interpret=True)
    plain = overlap_counts_plain(_t(a), _t(b), _t(alens), _t(blens), min0, D)
    for r, p, q in zip(ref, pal, plain):
        np.testing.assert_array_equal(q.numpy(), np.asarray(r))
        np.testing.assert_array_equal(q.numpy(), np.asarray(p))
    good, bad = plain[0].numpy(), plain[1].numpy()
    assert good.sum() > 0 and bad.sum() > 0


def test_right_justify_matches_np():
    rng = np.random.default_rng(31)
    B, L = 64, 60
    b = rng.integers(0, 5, (B, L)).astype(np.uint8)
    lens = rng.integers(1, L + 1, B).astype(np.int32)
    lens[0] = L
    want = J.right_justify_np(b, lens, L)
    np.testing.assert_array_equal(T.right_justify_torch(_t(b), _t(lens), L).numpy(), want)


@pytest.mark.parametrize("min0,D", [(5, 94), (12, 40)])
def test_quality_counts_match_np_and_jnp(min0, D):
    a, b, alens, blens, aq, bq = _pairs(11)
    want = J.overlap_counts_quality_np(a, b, aq, bq, alens, blens, min0, D)
    wj = J.overlap_counts_quality_jnp(a, b, aq, bq, alens, blens, min0, D)
    got = T.overlap_counts_quality_torch(
        _t(a), _t(b), _t(aq), _t(bq), _t(alens), _t(blens), min0, D)
    for w, j, g in zip(want, wj, got):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(np.asarray(j)))


def _count_planes(seed, B=64, D=170):
    """Count planes of mostly poor overlaps, with planted clean ones in
    two thirds of the rows (one mismatch in every other planted row)."""
    rng = np.random.default_rng(seed)
    alens = rng.integers(60, 152, B)
    blens = rng.integers(60, 152, B)
    olen = np.minimum(np.minimum(alens[:, None], blens[:, None]),
                      np.abs(np.arange(D)[None, :] - 90) + 5).astype(np.int64)
    good = (olen * rng.random((B, D)) * 0.7).astype(np.int64)
    bad = np.maximum(olen - good - rng.integers(0, 3, (B, D)), 0)
    rows = np.arange(2 * B // 3)
    sel = rng.integers(0, D, len(rows))
    bad[rows, sel] = rows % 2
    good[rows, sel] = olen[rows, sel] - bad[rows, sel]
    # quality-weighted sums: each count times a probability product
    good_f = (good * rng.uniform(0.8, 1.0, (B, D))).astype(np.float32)
    bad_f = (bad * rng.uniform(0.8, 1.0, (B, D))).astype(np.float32)
    return (good, bad, olen, alens, blens, good_f, bad_f,
            rng.integers(3, 9, B), rng.integers(10, 30, B))


@pytest.mark.parametrize("mode", ["ratio", "ratio_collect", "quality"])
def test_mate_by_overlap_ratio_matches_jnp_and_np(mode):
    good, bad, olen, alens, blens, good_f, bad_f, mo0, mo = _count_planes(17)
    em, col = (4.0, True) if mode == "ratio_collect" else (1.2, False)
    q = mode == "quality"
    args = dict(min_insert0_col=26, min_overlap0=mo0, min_overlap=mo,
                min_insert0=26, min_insert=35, max_ratio=0.09,
                min_second_ratio=0.1, margin=5.5, offset=0.5,
                extra_mult=em, collect=col)
    want = J.mate_by_overlap_ratio_np(
        good, bad, olen, alens, blens, good_f=good_f if q else None,
        bad_f=bad_f if q else None, **args)
    wj = J.mate_by_overlap_ratio_jnp(
        *(jnp.asarray(x.astype(np.int32)) for x in (good, bad, olen)),
        jnp.asarray(alens), jnp.asarray(blens),
        good_f=jnp.asarray(good_f) if q else None,
        bad_f=jnp.asarray(bad_f) if q else None, **args)
    got = T.mate_by_overlap_ratio_torch(
        *(_t(x.astype(np.int32)) for x in (good, bad, olen)), _t(alens),
        _t(blens), good_f=_t(good_f) if q else None,
        bad_f=_t(bad_f) if q else None, **args)
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(wj[i]))
    assert (got[0].numpy() > 0).sum() > 5  # the planted overlaps were found
    if col:
        for k in want[3]:
            np.testing.assert_array_equal(_bits(got[3][k].numpy()),
                                          _bits(np.asarray(wj[3][k])), err_msg=k)
            np.testing.assert_array_equal(_bits(got[3][k].numpy()),
                                          _bits(want[3][k]), err_msg=k)


@pytest.mark.parametrize("quality", [False, True])
def test_overlap_and_mate_matches_the_host_path(quality):
    """The device pipeline against the JAX package's CPU path (XLA insert
    scan, np quality scan, np mate selection) on read-like pairs."""
    rng = np.random.default_rng(23)
    B, L = 48, 60
    frag = rng.integers(0, 4, (B, 2 * L))
    ins = rng.integers(20, 2 * L, B)
    a = np.full((B, L), 4, np.uint8)
    b_rc = np.full((B, L), 4, np.uint8)
    alens = rng.integers(40, L + 1, B)
    blens = rng.integers(40, L + 1, B)
    for r in range(B):
        a[r, : alens[r]] = frag[r, : alens[r]]
        tail = frag[r, max(ins[r] - blens[r], 0) : ins[r]]
        b_rc[r, : len(tail)] = tail
        blens[r] = len(tail)
    a[rng.random((B, L)) < 0.02] = 4
    aq = rng.integers(2, 41, (B, L)).astype(np.uint8)
    bq = rng.integers(2, 41, (B, L)).astype(np.uint8)
    m0, D = 9, int((alens + blens).max() - 9 + 1)
    mo = rng.integers(8, 14, B)
    consts = (5, mo, m0, 12, 0.09, 0.1, 5.5, 0.55)
    good, bad, olen = (np.asarray(x) for x in J.overlap_counts_jnp(
        jnp.asarray(a), jnp.asarray(b_rc), jnp.asarray(alens),
        jnp.asarray(blens), m0, D))
    gf = bf = None
    if quality:
        gf, bf, _, _ = J.overlap_counts_quality_np(a, b_rc, aq, bq, alens,
                                                   blens, m0, D)
    want = J.mate_by_overlap_ratio_np(good, bad, olen, alens, blens, m0,
                                      *consts, good_f=gf, bad_f=bf)
    got = T.overlap_and_mate(
        _t(a), _t(b_rc), _t(alens), _t(blens), m0, D, *consts[:1],
        _t(mo), *consts[2:], aq=_t(aq) if quality else None,
        bq_rev=_t(bq) if quality else None)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (got[0].numpy() > 0).sum() >= B // 4


def _filter_inputs():
    rng = np.random.default_rng(29)
    B, L = 64, 60
    a = rng.integers(0, 5, (B, L)).astype(np.uint8)
    b = rng.integers(0, 5, (B, L)).astype(np.uint8)
    aq = rng.integers(0, 42, (B, L)).astype(np.uint8)
    bq = rng.integers(0, 42, (B, L)).astype(np.uint8)
    alens = rng.integers(20, L + 1, B)
    blens = rng.integers(20, L + 1, B)
    overlap = rng.integers(5, 110, B)
    return a, b, aq, bq, alens, blens, overlap


def test_expected_mismatches_matches_jnp_and_np():
    x = _filter_inputs()
    want = J.expected_mismatches_np(*x)
    wj = np.asarray(J.expected_mismatches_jnp(*(jnp.asarray(v) for v in x)))
    got = T.expected_mismatches_torch(*(_t(v) for v in x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(wj))


def test_probability_matches_np_and_jnp():
    """Bit-equal to the host oracle on every row. XLA flushes f32
    subnormals to zero and torch does not, so against the JAX device
    version the rows are bit-equal wherever its value is a normal float
    (the JAX package's own test states the same difference)."""
    x = _filter_inputs()
    want = J.probability_np(*x)
    wj = np.asarray(J.probability_jnp(*(jnp.asarray(v) for v in x)))
    got = T.probability_torch(*(_t(v) for v in x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    normal = np.abs(wj) >= np.finfo(np.float32).tiny
    np.testing.assert_array_equal(_bits(got[normal]), _bits(wj[normal]))
    assert normal.sum() > len(wj) // 2


@pytest.mark.parametrize("from_tail", [True, False])
def test_entropy_min_overlap_matches_jnp_and_np(from_tail):
    rng = np.random.default_rng(29)
    B, L = 64, 60
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.03] = 4
    codes[:15, 20:] = codes[:15, 19:20]  # low-entropy tails
    lens = rng.integers(10, L + 1, B).astype(np.int32)
    want = J.calc_min_overlap_by_entropy_np(codes, lens, 3, 39, from_tail)
    wj = np.asarray(J.calc_min_overlap_by_entropy_jnp(
        jnp.asarray(codes), jnp.asarray(lens), 3, 39, from_tail))
    got = T.calc_min_overlap_by_entropy_torch(_t(codes), _t(lens), 3, 39,
                                              from_tail).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, wj)
    assert (got <= lens).any() and (got > lens).any()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_overlap_variants_run_only_on_the_card(variant):
    """The kernel's measurement variants have no plain version: CPU
    tensors raise and count no launch."""
    a = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.full((2,), 8, dtype=torch.int32)
    before = overlap_counts.launches
    with pytest.raises(ValueError, match="CUDA"):
        overlap_counts_variant(variant, a, a, lens, lens, 1, 4)
    assert overlap_counts.launches == before
