"""The port's exact k-mer counting against the JAX package's on the CPU:
`count_batch`, `sort_reduce`, `merge_spectra`, `DeviceSpectrum` (with
capacity growth and the late-overflow replay), the W-word count on both
routes, and `python -m bbtools_torch kmercountexact ... device=cpu`,
whose khist, peaks and dump files are byte-equal to the JAX package's.
Every comparison is exact: integer keys, counts and file bytes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bbtools_torch.cli import main as tmain
from bbtools_torch.ops import kmer_count as tkc
from bbtools_torch.ops import kmers2 as tk2
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.ops import kmer_count as jkc
from bbtools_tpu.ops import kmers2 as jk2


def _reads(seed, B=48, L=120, n_prob=0.01, repeat=True):
    """Seeded codes with undefined bases, repeated rows (counts > 1) and
    ragged lengths."""
    g = np.random.default_rng(seed)
    bases = g.integers(0, 4, (B, L)).astype(np.uint8)
    bases[g.random((B, L)) < n_prob] = 4
    if repeat:
        bases[::3] = bases[0]
    lengths = g.integers(L // 3, L + 1, B).astype(np.int32)
    lengths[1] = L
    if repeat:
        lengths[::6] = L
    return bases, lengths


@pytest.mark.parametrize("k", [15, 31])
def test_count_batch_matches_jax(k):
    bases, lengths = _reads(k)
    want = jkc.count_batch(bases, lengths, k)
    got = tkc.count_batch(bases, lengths, k, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.int64


@pytest.mark.parametrize("k", [21, 31])
def test_sort_reduce_matches_jax(k):
    """batch_kmers and the padded (values, counts, n_runs) of sort_reduce
    equal the JAX package's row for row, and the reduction equals the
    host oracle."""
    bases, lengths = _reads(100 + k)
    jkeys = jkc.batch_kmers_jnp(jnp.asarray(bases), jnp.asarray(lengths), k)
    tkeys = tkc.batch_kmers(torch.from_numpy(bases), torch.from_numpy(lengths), k)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    want = jkc.sort_reduce(jkeys)
    got = tkc.sort_reduce(tkeys)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n = int(got[2])
    ov, oc = jkc.count_batch_np(bases, lengths, k)
    np.testing.assert_array_equal(got[0][:n].numpy(), ov)
    np.testing.assert_array_equal(got[1][:n].numpy(), oc)
    assert tkc.sort_reduce.device_calls == 0  # CPU tensors: no CUDA call


def test_sort_reduce_of_nothing_and_of_one_run():
    pad = int(tkc.PAD)
    v, c, n = tkc.sort_reduce(torch.full((5,), pad, dtype=torch.int64))
    assert int(n) == 0 and (v == pad).all() and (c == 0).all()
    v, c, n = tkc.sort_reduce(torch.tensor([7, pad, 7, 7], dtype=torch.int64))
    assert int(n) == 1 and v.tolist() == [7, pad, pad, pad] and c.tolist() == [3, 0, 0, 0]


def test_merge_spectra_matches_jax():
    bases, lengths = _reads(7)
    keys = np.array(jkc.batch_kmers_jnp(jnp.asarray(bases), jnp.asarray(lengths), 31))
    sk, sc, n = jkc.sort_reduce(jnp.asarray(keys[: len(keys) // 2]))
    want = jkc._merge_spectra(sk, sc, jnp.asarray(keys))
    got = tkc.merge_spectra(torch.tensor(np.asarray(sk)), torch.tensor(np.asarray(sc)),
                            torch.from_numpy(keys))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _spectra(cap, sync_every, batches):
    """The JAX DeviceSpectrum, the port's on CPU tensors and the host
    KmerSpectrum over the same batches."""
    js = jkc.DeviceSpectrum(31, cap=cap, sync_every=sync_every)
    ts = tkc.DeviceSpectrum(31, cap=cap, sync_every=sync_every, device="cpu")
    ks = tkc.KmerSpectrum(31)
    for bases, lengths in batches:
        js.add_batch(bases, lengths)
        ts.add_batch(bases, lengths)
        ks.add_batch(*tkc.count_batch_np(bases, lengths, 31))
    ks.flush()
    return js, ts, ks


def _same_spectrum(js, ts, ks, hist_max):
    jk, jc = js.spectrum()
    tk, tc = ts.spectrum()
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tk, ks.keys)
    np.testing.assert_array_equal(tc, ks.counts)
    assert tc.dtype == np.int64 and ts.n_unique == js.n_unique == len(ks.keys)
    np.testing.assert_array_equal(ts.histogram(hist_max), js.histogram(hist_max))
    np.testing.assert_array_equal(ts.histogram(hist_max), ks.histogram(hist_max))
    assert ts.cap == js.cap


def test_device_spectrum_matches_jax_with_growth():
    """The counterpart of test_device_spectrum_matches_host_spectrum: a
    tiny carry grows mid-run."""
    g = np.random.default_rng(3)
    batches = []
    for _ in range(3):
        bases = g.integers(0, 4, (64, 120)).astype(np.uint8)
        bases[::3] = bases[0]
        lengths = np.full(64, 120, np.int32)
        lengths[7] = 40
        batches.append((bases, lengths))
    js, ts, ks = _spectra(1 << 10, 8, batches)
    _same_spectrum(js, ts, ks, 100)
    assert ts.cap > 1 << 10


def test_device_spectrum_late_overflow_matches_jax():
    """The counterpart of test_device_spectrum_adversarial_late_overflow:
    with sync_every=4 and a 512-row carry, mostly-new keys overflow late
    inside each sync window, on batches whose run counts are still
    unsynced; the checkpoint and replay reproduce the spectrum across
    several growth-and-replay cycles."""
    g = np.random.default_rng(11)
    batches = [(g.integers(0, 4, (16, 120)).astype(np.uint8), np.full(16, 120, np.int32))
               for _ in range(10)]
    js, ts, ks = _spectra(1 << 9, 4, batches)
    _same_spectrum(js, ts, ks, 64)
    assert ts.cap >= len(ks.keys) and ts.cap > 1 << 9


def test_device_spectrum_checkpoint_is_never_written():
    """The carry is rebuilt, never written in place: the tensors held as
    the checkpoint keep their values while later batches are added and
    a late overflow replays."""
    g = np.random.default_rng(12)
    ts = tkc.DeviceSpectrum(31, cap=1 << 9, sync_every=4, device="cpu")
    snaps = []
    for i in range(9):
        ts.add_batch(g.integers(0, 4, (8, 100)).astype(np.uint8), np.full(8, 100, np.int32))
        ck = ts._ckpt
        snaps.append((ck, ck[0].clone(), ck[1].clone()))
    for (keys, counts), k0, c0 in snaps:
        assert torch.equal(keys, k0) and torch.equal(counts, c0)
    assert len({id(s[0][0]) for s in snaps}) > 1  # the checkpoint moved


@pytest.mark.parametrize("k", [32, 45, 62, 93, 124])
def test_count_batchw_exact_both_routes_match_jax(k, monkeypatch):
    """The host route (numpy windows, native radix count) and the device
    function on CPU tensors give the JAX package's 'S8W' keys and counts."""
    bases, lengths = _reads(200 + k, B=40, L=150)
    want_keys, want_counts = jk2.count_batchw_exact(bases, lengths.astype(np.int64), k)
    host = tk2.count_batchw_exact(bases, lengths.astype(np.int64), k, "cpu")
    dev = tk2.count_batchw_device(bases, lengths.astype(np.int64), k, "cpu")
    for keys, counts in (host, dev):
        assert keys.dtype == want_keys.dtype == np.dtype(f"S{8 * tk2.n_words(k)}")
        np.testing.assert_array_equal(keys, want_keys)
        np.testing.assert_array_equal(counts, want_counts)
        assert counts.dtype == np.int64
    assert want_counts.max() > 1  # repeated rows reach every route
    # the CPU route never takes the device sort
    monkeypatch.setattr(tk2, "count_batchw_device", None)
    keys, _ = tk2.count_batchw_exact(bases, lengths.astype(np.int64), k, "cpu")
    np.testing.assert_array_equal(keys, want_keys)


def test_rolling_kmersw_matches_jax():
    bases, _ = _reads(9, B=8, L=200, repeat=False)
    for k in (40, 93, 160):
        want = jk2.rolling_kmersw_jnp(jnp.asarray(bases), k)
        got = tk2.rolling_kmersw(torch.from_numpy(bases), k)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        cw = jk2.canonical_words_jnp(*want[:2])
        np.testing.assert_array_equal(tk2.canonical_words_t(*got[:2]).numpy(), np.asarray(cw))


@pytest.fixture(scope="module")
def reads_fq(tmp_path_factory):
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.utils.synth import random_genome, random_reads, write_reads

    tmp = tmp_path_factory.mktemp("tkce")
    write_fasta(str(tmp / "g.fa"), random_genome(12_000, seed=4))
    ref = load_reference(str(tmp / "g.fa"))
    write_reads(str(tmp / "r.fq"), random_reads(ref, 900, read_len=150,
                                                snp_rate=0.005, seed=5))
    return tmp


@pytest.mark.parametrize("tool,k,extra", [
    ("kmercountexact", 31, []), ("kmercount", 31, ["printzeros=f", "mincount=2"]),
    ("khist", 93, []), ("kmercountexact", 93, ["histmax=50"]),
    ("kmercountexact", 20, []),
])
def test_cli_files_equal_jax(reads_fq, tool, k, extra):
    files = {}
    for pkg, main in (("jax", jmain), ("torch", tmain)):
        outs = {o: reads_fq / f"{tool}{k}.{pkg}.{o}" for o in ("khist", "peaks", "dump")}
        argv = [tool, f"in={reads_fq / 'r.fq'}", f"k={k}", *extra,
                *(f"{o}={p}" for o, p in outs.items())]
        main(argv + (["device=cpu"] if pkg == "torch" else []))
        files[pkg] = {o: p.read_bytes() for o, p in outs.items()}
    for o in ("khist", "peaks", "dump"):
        assert files["torch"][o] == files["jax"][o], o
    assert files["torch"]["dump"].count(b">") > 1000
    assert files["torch"]["peaks"].count(b"\n") >= 3  # a peak row
