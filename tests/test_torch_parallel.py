"""The port's multi-device functions (bbtools_torch/parallel/) against the
JAX package's (bbtools_tpu/parallel/), on the same numpy inputs from a
seed: the port on meshes of CPU copies, the JAX package on its 8 virtual
CPU devices (tests/conftest.py). Every output is held equal exactly."""

import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbtools_torch.ops import bbduk_scan as tscan
from bbtools_torch.ops import msa_fill as tfill
from bbtools_torch.ops import mm_match as tmm
from bbtools_torch.parallel import distributed as tdist
from bbtools_torch.parallel import mesh as tmesh
from bbtools_torch.parallel import sharded_count as tcount
from bbtools_torch.parallel import sharded_index as tindex
from bbtools_torch.parallel.sharded_spectrum import ShardedSpectrum as TSpectrum
from bbtools_tpu.core.dna import encode
from bbtools_tpu.ops import bbduk_scan as jscan
from bbtools_tpu.ops import mm_match as jmm
from bbtools_tpu.ops import msa as jmsa
from bbtools_tpu.ops.kmer_index import build_ref_keys
from bbtools_tpu.ops.kmers import length_mask, rc_kmer_np, rolling_kmers_np
from bbtools_tpu.parallel import distributed as jdist
from bbtools_tpu.parallel import mesh as jmesh
from bbtools_tpu.parallel import sharded_count as jcount
from bbtools_tpu.parallel import sharded_index as jindex
from bbtools_tpu.parallel.sharded_spectrum import ShardedSpectrum as JSpectrum

ADAPTER = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test processes on
    shared cores (as tests/test_torch_bbmerge.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(n_dp, n_tp):
    return (tmesh.make_mesh(n_dp, n_tp, devices=[torch.device("cpu")] * (n_dp * n_tp)),
            jmesh.make_mesh(n_dp=n_dp, n_tp=n_tp, devices=jax.devices()[: n_dp * n_tp]))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("n_dp,n_tp", [(None, 1), (None, 2), (4, 2), (2, 4), (1, 8), (8, 1)])
def test_make_mesh_shapes(n_dp, n_tp):
    t = tmesh.make_mesh(n_dp, n_tp)
    j = jmesh.make_mesh(n_dp, n_tp)
    assert t.devices.shape == j.devices.shape
    assert t.shape == dict(j.shape)
    assert all(d == torch.device("cpu") for d in t.devices.ravel())


@pytest.mark.parametrize("n_dp,n_tp", [(3, 2), (16, 1), (3, 1), (1, 3)])
def test_make_mesh_errors(n_dp, n_tp):
    with pytest.raises(ValueError) as j:
        jmesh.make_mesh(n_dp, n_tp)
    with pytest.raises(ValueError, match=re.escape(str(j.value))):
        tmesh.make_mesh(n_dp, n_tp)


def test_local_devices(monkeypatch):
    assert tmesh.local_devices("cpu") == [torch.device("cpu")] * len(jax.devices())
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert tmesh.local_devices("cuda") == [torch.device("cuda", i) for i in range(3)]


def _panel(seed=3, n=12, mink=11):
    rng = np.random.default_rng(seed)
    scafs = [encode(ADAPTER)] + [rng.integers(0, 4, 40).astype(np.uint8) for _ in range(n)]
    keys, ids = build_ref_keys(scafs, 23, mink=mink, hdist=1)
    return scafs, keys, ids


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_sharded_index_build(S):
    _, keys, ids = _panel()
    t = tindex.ShardedKmerIndex.build(keys, ids, S)
    j = jindex.ShardedKmerIndex.build(keys, ids, S)
    assert (t.nb, t.n_shards) == (j.nb, j.n_shards)
    np.testing.assert_array_equal(t.keys, j.keys)
    np.testing.assert_array_equal(t.ids, j.ids)


def _reads(scafs, B=64, L=101, seed=5):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for r in range(0, B, 3):
        s = scafs[r % len(scafs)]
        p = int(rng.integers(0, L - 20))
        n = min(len(s), L - p)
        bases[r, p : p + n] = s[:n]
    bases[rng.random((B, L)) < 0.01] = 4
    lengths = rng.integers(30, L + 1, B).astype(np.int32)
    lengths[1] = 0
    return bases, lengths


def test_sharded_kscan_equals_jax():
    """The production scan over a (4, 2) mesh, full and both short-end
    scans, every output equal to the JAX package's over its mesh."""
    scafs, keys, ids = _panel()
    bases, lengths = _reads(scafs)
    tm, jm = _meshes(4, 2)
    tsidx = tindex.ShardedKmerIndex.build(keys, ids, 2)
    jsidx = jindex.ShardedKmerIndex.build(keys, ids, 2)
    tfn = tindex.make_sharded_kscan(tm, tscan.KScanConfig(k=23, mink=11), tsidx, True, True)
    jfn = jindex.make_sharded_kscan(jm, jscan.KScanConfig(k=23, mink=11), jsidx, True, True)
    tout, tsl, tsr = tfn(tsidx.place(tm), torch.from_numpy(bases), torch.from_numpy(lengths))
    jout, jsl, jsr = jfn(jnp.asarray(jsidx.keys), jnp.asarray(jsidx.ids),
                         jnp.asarray(bases), jnp.asarray(lengths))
    assert set(tout) == set(jout)
    _equal([tout[k] for k in sorted(tout)], [jout[k] for k in sorted(jout)])
    _equal(tsl, jsl)
    _equal(tsr, jsr)
    assert int(tout["nhits"].max()) > 0 and bool(tsr[0].any())


def test_sharded_bbduk_step_equals_jax():
    scafs, keys, ids = _panel()
    bases, lengths = _reads(scafs, seed=9)
    tm, jm = _meshes(4, 2)
    tsidx = tindex.ShardedKmerIndex.build(keys, ids, 2)
    jsidx = jindex.ShardedKmerIndex.build(keys, ids, 2)
    got = tindex.sharded_bbduk_step(tm, tscan.KScanConfig(k=23), tsidx)(
        torch.from_numpy(bases), torch.from_numpy(lengths), tsidx.place(tm))
    want = jindex.sharded_bbduk_step(jm, jscan.KScanConfig(k=23), jsidx)(
        jnp.asarray(bases), jnp.asarray(lengths), jnp.asarray(jsidx.keys),
        jnp.asarray(jsidx.ids))
    _equal(got, want)
    assert int(got[0].max()) > 0 and int(got[1].sum()) == len(bases)
    assert got[0].dtype == got[1].dtype == torch.int32


def test_sharded_count_step_equals_jax():
    rng = np.random.default_rng(11)
    B, L, k = 64, 80, 31
    bases = rng.integers(0, 4, (B, L)).astype(np.uint8)
    bases[rng.random((B, L)) < 0.01] = 4
    bases[::5] = bases[0]
    lengths = rng.integers(k - 1, L + 1, B).astype(np.int32)
    tm, jm = _meshes(8, 1)
    got = tcount.sharded_count_step(tm, k)(torch.from_numpy(bases), torch.from_numpy(lengths))
    want = jcount.sharded_count_step(jm, k)(jnp.asarray(bases), jnp.asarray(lengths))
    _equal(got, want)
    assert got[3].dtype == torch.int64 and int(got[3].sum()) == int(got[2].sum())


def test_sharded_ungapped_score_step_equals_jax():
    rng = np.random.default_rng(12)
    T, L, W = 32, 60, 90
    reads = rng.integers(0, 4, (T, L)).astype(np.uint8)
    refs = rng.integers(0, 4, (T, W)).astype(np.uint8)
    starts = rng.integers(-5, 35, T).astype(np.int32)
    for t in range(0, T, 2):
        s = max(int(starts[t]), 0)
        refs[t, s : s + L] = reads[t, : W - s]
        refs[t, min(s + 7, W - 1)] ^= 1
    lens = rng.integers(40, L + 1, T).astype(np.int32)
    tm, jm = _meshes(8, 1)
    got = tcount.sharded_ungapped_score_step(tm, L, W)(
        *(torch.from_numpy(x) for x in (reads, lens, refs, starts)))
    want = jcount.sharded_ungapped_score_step(jm, L, W)(
        *(jnp.asarray(x) for x in (reads, lens, refs, starts)))
    _equal([got], [want])
    assert int(got.max()) > 0


def test_sharded_overlap_step_equals_jax():
    rng = np.random.default_rng(13)
    B, L = 32, 100
    a = rng.integers(0, 5, (B, L)).astype(np.uint8)
    b = a[:, ::-1].copy()
    b[rng.random((B, L)) < 0.05] = 4
    alens = rng.integers(50, L + 1, B).astype(np.int32)
    blens = rng.integers(50, L + 1, B).astype(np.int32)
    m0, ni = 12, 2 * L - 12 + 1
    tm, jm = _meshes(4, 1)
    got = tcount.sharded_overlap_step(tm, m0, ni)(
        *(torch.from_numpy(x) for x in (a, b, alens, blens)))
    want = jcount.sharded_overlap_step(jm, m0, ni)(
        *(jnp.asarray(x) for x in (a, b, alens, blens)))
    _equal(got, want)
    assert all(g.dtype == torch.int32 for g in got)


def test_sharded_seed_expand_step_equals_jax():
    rng = np.random.default_rng(9)
    k, M, S = 5, 4, 2
    nk = 4 ** k
    counts = rng.integers(0, 6, nk)
    starts = np.zeros(nk + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    sites = rng.integers(0, 1 << 20, int(starts[-1]), dtype=np.int32)
    tables = tcount.shard_seed_index(starts, sites, S, M)
    np.testing.assert_array_equal(tables, jcount.shard_seed_index(starts, sites, S, M))
    keys = rng.integers(0, nk, (16, 6)).astype(np.int32)
    tm, jm = _meshes(4, S)
    got = tcount.sharded_seed_expand_step(tm, S)(torch.from_numpy(keys),
                                                 torch.from_numpy(tables))
    want = jcount.sharded_seed_expand_step(jm, S)(jnp.asarray(keys), jnp.asarray(tables))
    _equal([got], [want])
    assert tuple(got.shape) == (S, 16, 6, M) and got.dtype == torch.int32


def _fill_tasks(seed, T, R, Cc):
    """Near-match tasks with indels, mixed lengths, code 4 past the end
    (as tests/test_torch_msa.py makes them)."""
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 4, (T, Cc)).astype(np.uint8)
    lens = rng.integers(R // 2, R + 1, T).astype(np.int32)
    lens[0] = R
    reads = np.full((T, R), 4, np.uint8)
    for b in range(T):
        n = int(lens[b])
        st = int(rng.integers(0, Cc - n - 4))
        src = refs[b, st : st + n + 4].copy()
        if n > 12 and b % 3:
            p, d = int(rng.integers(4, n - 8)), int(rng.integers(1, 5))
            src = (np.concatenate([src[:p], src[p + d :]]) if b % 3 == 1 else
                   np.concatenate([src[:p], rng.integers(0, 4, d).astype(np.uint8), src[p:]]))
        src = src[:n]
        m = rng.random(n) < 0.06
        src[m] = (src[m] + rng.integers(1, 4, int(m.sum()))) % 4
        reads[b, :n] = src
    return reads, lens, refs


def test_sharded_fill_walk_equals_jax(monkeypatch):
    """BBMap's fill and walk over a dp=4 mesh: the plain fill per slab,
    its dead plane bytes poisoned (0xFF), equals the JAX package's
    sharded fill and walk; a tight plane budget cuts each slab in groups
    and changes nothing."""
    T, R, Cc = 16, 40, 64
    reads, lens, refs = _fill_tasks(21, T, R, Cc)
    lens[5] = R - 9
    reads[5, R - 9 :] = 4
    plain = tfill.msa_fill_plain

    def poisoned(r, ln, rf, rows=None):
        *outs, planes = plain(r, ln, rf)
        dead = ~tfill.live_cells(ln, planes.shape[2] - 1, rf.shape[1])
        return (*outs, planes.masked_fill(dead, 0xFF))

    monkeypatch.setattr(tfill, "msa_fill", poisoned)
    tm, jm = _meshes(4, 1)
    fn = tcount.make_sharded_fill_walk(tm, R, Cc)
    got = fn(reads, lens, refs)
    assert fn.fill_calls == 4
    maxgain = (lens.astype(np.int64) - 1) * jmsa.C.POINTS_MATCH2 + jmsa.C.POINTS_MATCH
    vert, horiz, floor, _ = jmsa.prepare_limits_np(
        reads, lens, refs, np.full(T, Cc, np.int32), np.zeros(T, np.int64))
    want = jcount.make_sharded_fill_walk(jm, R, Cc)(
        *(jnp.asarray(x) for x in (reads, lens, refs, vert.astype(np.int32),
                                   horiz.astype(np.int32), floor.astype(np.int32),
                                   (-2 * maxgain).astype(np.int32))))
    _equal(got, want)
    assert tuple(got[3].shape) == (T, R + Cc) and int(got[4].min()) > 0
    monkeypatch.setattr(tfill, "CPU_PLANE_BUDGET", 2 * tfill.task_bytes(R, Cc))
    again = fn(reads, lens, refs)
    assert fn.fill_calls == 8
    _equal(again, got)


def _mm_index():
    rng = np.random.default_rng(21)
    scafs = [rng.integers(0, 4, 60).astype(np.uint8) for _ in range(6)]
    mm = jmm.MMKmerIndex.build(scafs, 13, mink=8, hdist=1)
    q = rng.integers(0, 1 << 26, (8, 64), dtype=np.int64)
    # every third query one of the reference's 13-mers, one base changed
    # in every other one (within hdist=1)
    fwd, rkm, run = rolling_kmers_np(np.stack(scafs), 13)
    real = fwd[run >= 13]
    flat = q.reshape(-1)
    pick = real[rng.integers(0, len(real), len(flat[::3]))]
    pick[::2] ^= np.int64(1) << (2 * rng.integers(0, 13, len(pick[::2])))
    flat[::3] = pick
    q = np.maximum(q, rc_kmer_np(q, 13)) | np.int64(length_mask(13))
    return mm, tmm.MMKmerIndex.from_arrays(mm.keymat, mm.prio, mm.k, mm.mink, mm.n_raw), q


def test_mm_best_plain_equals_jax():
    mm, tidx, q = _mm_index()
    kw, pr = tidx.device_arrays("cpu")
    got = tmm.mm_best_plain(kw, pr, *tidx.static_params(), torch.from_numpy(q))
    want = jmm.mm_best_jnp(*mm.device_arrays(), mm.k, mm.mink, mm.Kp, jnp.asarray(q))
    _equal([got], [want])
    assert bool((got != int(tmm.BIG32)).any()) and bool((got == int(tmm.BIG32)).any())
    _equal([tmm.mm_decode_best(got)], [jmm.mm_decode_best(want)])
    before = tmm.mm_best.launches
    assert torch.equal(tmm.mm_best(kw, pr, *tidx.static_params(), torch.from_numpy(q)), got)
    assert tmm.mm_best.launches == before


def test_sharded_mm_lookup_step_equals_jax():
    """Columns over tp=4, queries over dp=2: the JAX package's sharded
    matcher and the single-device lookup."""
    mm, tidx, q = _mm_index()
    assert mm.Dp % 4 == 0
    tm, jm = _meshes(2, 4)
    kw, pr = tidx.device_arrays("cpu")
    got = tcount.sharded_mm_lookup_step(tm, mm.k, mm.mink, mm.Kp)(kw, pr, torch.from_numpy(q))
    want = jcount.sharded_mm_lookup_step(jm, mm.k, mm.mink, mm.Kp)(
        *mm.device_arrays(), jnp.asarray(q))
    _equal([got], [want])
    _equal([got], [mm.lookup_np(q)])
    assert int((got > 0).sum()) > 0


def test_sharded_mm_lookup_pads_columns_to_tp():
    """tp=3 does not divide the index's columns: the step pads them with
    columns that never match, and equals the single-device lookup."""
    mm, tidx, q = _mm_index()
    assert mm.Dp % 3
    mesh = tmesh.make_mesh(2, 3, devices=[torch.device("cpu")] * 6)
    kw, pr = tidx.device_arrays("cpu")
    got = tcount.sharded_mm_lookup_step(mesh, mm.k, mm.mink, mm.Kp)(kw, pr, torch.from_numpy(q))
    want = tmm.mm_lookup_plain(kw, pr, *tidx.static_params(), torch.from_numpy(q))
    assert torch.equal(got, want)


def test_sharded_spectrum_equals_jax():
    """Three batches of uneven size (padded rows), duplicated rows, short
    reads and N; the JAX side at a small capacity, so it grows and
    retries: spectrum, histogram and unique count equal."""
    k = 31
    tm, jm = _meshes(8, 1)
    ts, js = TSpectrum(tm, k), JSpectrum(jm, k, cap=1 << 8)
    g = np.random.default_rng(77)
    for bi in range(3):
        B, L = 45 + 8 * bi, 120
        bases = g.integers(0, 4, (B, L)).astype(np.uint8)
        bases[::4] = bases[0]
        bases[g.random((B, L)) < 0.005] = 4
        lengths = np.full(B, L, np.int32)
        lengths[5] = 50
        lengths[6] = 20
        ts.add_batch(bases, lengths)
        js.add_batch(bases, lengths)
    assert js.cap > 1 << 8
    _equal(ts.spectrum(), js.spectrum())
    np.testing.assert_array_equal(ts.histogram(1000), js.histogram(1000))
    np.testing.assert_array_equal(ts.histogram(3), js.histogram(3))
    assert ts.n_unique == js.n_unique > 0


def test_merge_equals_jax_merge_jit():
    """The process merge's sort-reduce on a [dp, cap] plane of keys (with
    the JAX package's sentinel pads) and two payloads."""
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 50, (8, 32)).astype(np.int64)
    keys[:, 28:] = jdist._SPEC_SENT
    p1 = rng.integers(1, 9, (8, 32)).astype(np.int64)
    p2 = rng.integers(0, 3, (8, 32)).astype(np.int64)
    got = tdist.merge(*(torch.from_numpy(x) for x in (keys, p1, p2)))
    want = jdist.merge_jit(jmesh.make_mesh(8), n_payload=2)(
        *(jnp.asarray(x) for x in (keys, p1, p2)))
    _equal(got, want)


def test_one_process_is_its_own_group(monkeypatch):
    """Without WORLD_SIZE (or at 1) there is no group: initialize is
    False, and the global merges return their input."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tdist.initialize() is False and tdist.world_size() == 1 and tdist.rank() == 0
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tdist.initialize() is False
    v = np.arange(5, dtype=np.int64)
    np.testing.assert_array_equal(tdist.global_sum_array(v), v)
    k, c = tdist.global_spectrum(v, v + 1)
    np.testing.assert_array_equal(k, v)
    np.testing.assert_array_equal(c, v + 1)


def test_parallel_imports_no_jax():
    code = (
        "import sys, importlib\n"
        "for m in ('mesh', 'sharded_index', 'sharded_count', 'sharded_spectrum',"
        " 'distributed'):\n"
        "    importlib.import_module('bbtools_torch.parallel.' + m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'bbtools_tpu'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
