"""The port's one-hot matcher (`bbtools_torch.ops.mm_match`, kernel B3's
plain version) and its BBDuk backend against the JAX package on the CPU.

The JAX package's index arrays are carried across with
`MMKmerIndex.from_arrays`, so the port's lookup is held against the
JAX package's Pallas kernel (interpret mode), its XLA product and its
host oracle on one key matrix. Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbtools_torch.ops import kmer_index as tk
from bbtools_torch.ops import mm_match as tm
from bbtools_tpu.ops import kmer_index as jk
from bbtools_tpu.ops import mm_match as jm
from bbtools_tpu.ops.kmers import length_mask, rc_kmer_np

MID23 = ~(3 << 22)  # the default maskMiddle of k=23


@pytest.mark.parametrize("klen,hdist,n,mid", [
    (23, 2, 2, -1), (23, 2, 1, MID23), (11, 2, 3, -1), (7, 3, 2, -1),
])
def test_expand_kmers_matches_jax(klen, hdist, n, mid):
    """The port's vectorized hdist>=2 stream equals the JAX package's
    per-kmer recursion: the same keys in the same order, same sources."""
    rng = np.random.default_rng(klen * 10 + hdist)
    kmers = rng.integers(0, 1 << (2 * klen), n, dtype=np.int64)
    want = jk.expand_kmers(kmers, klen, hdist, mid)
    got = tk.expand_kmers(kmers, klen, hdist, mid)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("klen,hdist,n,per_chunk", [(11, 2, 7, 2), (5, 3, 5, 3)])
def test_expand_kmers_chunks_match_jax(monkeypatch, klen, hdist, n, per_chunk):
    """The chunked stream, with the chunk cut to `per_chunk` kmers (the
    last chunk ragged), equals the JAX package's recursion over all kmers."""
    per = len(jk.expand_kmers(np.zeros(1, np.int64), klen, hdist)[0])
    monkeypatch.setattr(tk, "EXPAND_CHUNK", per_chunk * per + per - 1)
    rng = np.random.default_rng(klen + n)
    kmers = rng.integers(0, 1 << (2 * klen), n, dtype=np.int64)
    want = jk.expand_kmers(kmers, klen, hdist, -1)
    got = tk.expand_kmers(kmers, klen, hdist, -1)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_expand_kmers_full_chunks_match_jax_per_kmer():
    """At the real chunk size, k=23 hdist=2 over three chunks (868, 868
    and 64 kmers): the slices of kmers at each chunk's edges equal the
    JAX package's recursion over that kmer alone."""
    klen, n = 23, 1800
    rng = np.random.default_rng(23)
    kmers = rng.integers(0, 1 << (2 * klen), n, dtype=np.int64)
    keys, src = tk.expand_kmers(kmers, klen, 2, MID23)
    per = 1 + 3 * klen * (1 + 3 * klen)
    assert tk.EXPAND_CHUNK // per == 868 and len(keys) == n * per
    np.testing.assert_array_equal(src, np.repeat(np.arange(n), per))
    for i in (0, 867, 868, 1735, 1736, n - 1):
        want = jk.expand_kmers(kmers[i : i + 1], klen, 2, MID23)[0]
        np.testing.assert_array_equal(keys[i * per : (i + 1) * per], want)


def _panel(seed, n_scafs=12, length=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, length).astype(np.uint8) for _ in range(n_scafs)]


def test_build_ref_keys_hdist2_matches_jax():
    scafs = _panel(5, n_scafs=1, length=24)
    want = jk.build_ref_keys(scafs, 23, mink=22, hdist=2)
    got = tk.build_ref_keys(scafs, 23, mink=22, hdist=2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


CONFIGS = {
    "k23_mink11_h2": dict(k=23, mink=11, hdist=2),
    "k23_mink11_h1_h2": dict(k=23, mink=11, hdist=1, hdist2=2),
    "k13_h1": dict(k=13, hdist=1),
    "k31_mink11_h1": dict(k=31, mink=11, hdist=1),  # Kp = 256
}


def _queries(scafs, k, mink, n, seed):
    """Canonical keys of panel windows with 0-3 substitutions, of short
    panel prefixes, and random keys."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = scafs[i % len(scafs)]
        ln = k if (not mink or i % 4) else int(rng.integers(mink, k))
        p = 0 if ln < k else int(rng.integers(0, len(s) - k + 1))
        codes = s[p : p + ln].astype(np.int64).copy()
        for _ in range(i % 4):
            codes[rng.integers(0, ln)] = rng.integers(0, 4)
        if i % 9 == 0:
            codes = rng.integers(0, 4, ln)
        fwd = np.int64(0)
        for c in codes:
            fwd = (fwd << 2) | np.int64(c)
        fwd = np.array([fwd])
        out.append(np.maximum(fwd, rc_kmer_np(fwd, ln))[0] | length_mask(ln))
    return np.array(out, np.int64)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_build_and_lookup_match_jax(name):
    cfg = CONFIGS[name]
    k, mink = cfg["k"], cfg.get("mink", 0)
    scafs = _panel(len(name))
    jidx = jm.MMKmerIndex.build(scafs, **cfg)
    pidx = tm.MMKmerIndex.build(scafs, **cfg)
    assert jidx is not None and pidx is not None
    np.testing.assert_array_equal(pidx.keymat, jidx.keymat)
    np.testing.assert_array_equal(pidx.prio, jidx.prio)
    assert pidx.static_params() == jidx.static_params()
    # the JAX package's arrays, carried across
    idx = tm.MMKmerIndex.from_arrays(jidx.keymat, jidx.prio, jidx.k,
                                     jidx.mink, jidx.n_raw)
    assert idx.static_params() == jidx.static_params() and idx.n_raw == pidx.n_raw
    q = _queries(scafs, k, mink, 700, seed=len(name))
    want = jidx.lookup_np(q)
    km, pr = jidx.device_arrays()
    oh = jm._query_onehot_jnp(jnp.asarray(q), k, mink, jidx.Kp)
    np.testing.assert_array_equal(
        tm.query_onehot(torch.from_numpy(q), k, mink, idx.Kp).numpy(),
        np.asarray(oh))
    pallas = np.asarray(jm._mm_pallas(km, pr, oh, interpret=True))
    xla = np.asarray(jm.mm_lookup_jnp(km, pr, *jidx.static_params(), jnp.asarray(q)))
    km_t, pr_t = idx.device_arrays(torch.device("cpu"))
    np.testing.assert_array_equal(km_t.view(torch.int8).t().numpy(), jidx.keymat)
    before = tm.mm_lookup.launches
    got = tm.mm_lookup(km_t, pr_t, *idx.static_params(),
                       torch.from_numpy(q.reshape(35, 20))).numpy().reshape(-1)
    assert tm.mm_lookup.launches == before
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    assert (got > 0).sum() > len(q) // 3 and (got == 0).sum() > 10


# ---------------------------------------------------------------------------
# the BBDuk backend
# ---------------------------------------------------------------------------


def _write_panel(tmp_path, n_scafs=100, L=50):
    # ~196k hdist-1 keys: past the lane cap, so the JAX package takes its
    # bucket table on the CPU
    rng = np.random.default_rng(101)
    recs = [b">s%d\n%s\n" % (i, bytes(b"ACGT"[x] for x in rng.integers(0, 4, L)))
            for i in range(n_scafs)]
    path = tmp_path / "panel.fa"
    path.write_bytes(b"".join(recs))
    return path, [r.split(b"\n")[1] for r in recs]


def _write_reads(tmp_path, scafs, n=300, L=100):
    """Reads with panel pieces at the end (one substitution in some),
    inside the read, as a short tail, or not at all."""
    rng = np.random.default_rng(102)
    out = []
    for i in range(n):
        seq = bytearray(bytes(b"ACGT"[x] for x in rng.integers(0, 4, L)))
        s = scafs[i % len(scafs)]
        if i % 4 == 0:
            piece = bytearray(s[:30])
            piece[7] = b"ACGT"[(b"ACGT".index(piece[7]) + 1) % 4]
            seq[L - 30 :] = piece
        elif i % 4 == 1:
            seq[40:75] = s[5:40]
        elif i % 4 == 2:
            m = int(rng.integers(11, 22))
            seq[L - m :] = s[:m]
        out.append(b"@r%d\n%s\n+\n%s\n" % (i, bytes(seq), b"F" * L))
    path = tmp_path / "in.fq"
    path.write_bytes(b"".join(out))
    return path


@pytest.mark.parametrize("mode", ["ktrim=r", "ktrim=f"])
def test_bbduk_mm_backend_matches_jax_bucket(tmp_path, monkeypatch, mode):
    """BBDuk on the port's matcher (forced by declining the lane table
    and the sorted join) against the JAX package's CPU run, which takes
    its bucket table: output, matched output and stats byte-equal."""
    from bbtools_torch.models import bbduk as port_bbduk
    from bbtools_torch.ops.lane_index import LaneKmerIndex
    from bbtools_tpu.cli import main as jax_main

    panel, scafs = _write_panel(tmp_path)
    fin = _write_reads(tmp_path, scafs)
    monkeypatch.setattr(LaneKmerIndex, "supports", staticmethod(lambda n: False))
    monkeypatch.setattr(port_bbduk, "_join_eligible", lambda cfg, n: False)
    flags = [f"ref={panel}", "k=23", "mink=11", "hdist=1", "minlen=10", mode]
    res = {}
    for tag in ("jax", "torch"):
        files = [tmp_path / f"{tag}.{x}" for x in ("out.fq", "outm.fq", "stats.txt")]
        argv = [f"in={fin}", f"out={files[0]}", f"outm={files[1]}",
                f"stats={files[2]}", *flags]
        if tag == "jax":
            jax_main(["bbduk", *argv])
        else:
            duk = port_bbduk.BBDuk(port_bbduk.parse_args(argv + ["device=cpu"]))
            assert isinstance(duk.index, tm.MMKmerIndex)
            duk.run()
        res[tag] = [f.read_bytes() for f in files]
    assert res["torch"] == res["jax"]
    assert b"#Matched\t0\t" not in res["torch"][2]


def test_backend_gate_order(monkeypatch):
    """Lane table, then sorted join, then the matcher, then the bucket
    table, decided from the config and panel alone (the caps lowered so
    a small panel walks every branch)."""
    from bbtools_torch.models.bbduk import build_index, parse_args
    from bbtools_torch.ops.kmer_index import BucketKmerIndex
    from bbtools_torch.ops.lane_index import LaneKmerIndex
    from bbtools_torch.ops.sort_join import SortJoinIndex

    lit = ["literal=" + ",".join("".join("ACGT"[x] for x in s) for s in _panel(9, 4, 40))]

    def backend(*flags):
        return type(build_index(parse_args(lit + ["k=23", *flags, "device=cpu"]))[0])

    assert backend("hdist=1") is LaneKmerIndex
    monkeypatch.setattr(LaneKmerIndex, "MAX_COST", 0)
    assert backend("hdist=1") is SortJoinIndex
    monkeypatch.setattr(SortJoinIndex, "MAX_KEYS", 1000)
    assert backend("hdist=1") is tm.MMKmerIndex
    assert backend("hdist=1", "mink=11") is tm.MMKmerIndex
    assert backend("hdist=1", "qhdist=1") is BucketKmerIndex
    assert backend("edist=1") is BucketKmerIndex
    assert backend("hdist=0") is SortJoinIndex  # 72 keys: under the cap


@pytest.mark.parametrize("layout", ["permuted", "ragged"])
def test_from_arrays_any_column_order_matches_jax(layout):
    """An index over the JAX package's arrays with its columns permuted
    out of priority order, or trimmed to a Dp that is no multiple of the
    column tile: the port's lookup still equals the JAX package's oracle
    and its XLA product on those arrays."""
    cfg = CONFIGS["k23_mink11_h2"]
    scafs = _panel(31, n_scafs=20, length=50)
    jidx = jm.MMKmerIndex.build(scafs, **cfg)
    rng = np.random.default_rng(31)
    if layout == "permuted":
        cols = rng.permutation(jidx.Dp)
    else:
        cols = np.arange(int((jidx.prio[0] != jm.BIG32).sum()) + 5)
    km, pr = jidx.keymat[:, cols], jidx.prio[:, cols]
    idx = tm.MMKmerIndex.from_arrays(km, pr, jidx.k, jidx.mink, jidx.n_raw)
    assert (idx.Dp % 128 != 0) == (layout == "ragged")
    q = _queries(scafs, 23, 11, 1500, seed=32)
    want = jidx.lookup_np(q)
    xla = np.asarray(jm.mm_lookup_jnp(jnp.asarray(km), jnp.asarray(pr),
                                      *jidx.static_params()[:3], idx.Dp,
                                      jnp.asarray(q)))
    got = tm.mm_lookup(*idx.device_arrays(torch.device("cpu")),
                       *idx.static_params(), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, xla)
    assert (got > 0).sum() > len(q) // 3


def test_variants_run_only_on_the_card():
    """The kernel's measurement variants have no plain version: a CPU
    tensor raises and counts no launch."""
    idx = tm.MMKmerIndex.build(_panel(4), 23, mink=11, hdist=1)
    args = (*idx.device_arrays(torch.device("cpu")), *idx.static_params(),
            torch.zeros(8, dtype=torch.int64))
    before = tm.mm_lookup.launches
    for name in tm.VARIANTS:
        with pytest.raises(ValueError, match="CUDA"):
            tm.mm_lookup_variant(name, *args)
    assert tm.mm_lookup.launches == before
