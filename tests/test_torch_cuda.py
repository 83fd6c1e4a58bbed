"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked `cuda`: they skip where torch finds no CUDA device, and run
on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from bbtools_torch.ops import lane_index, scan
from bbtools_torch.utils import vcfdiff

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _lane_tables(rng, n, hi_bits):
    top = 62 if hi_bits else 44
    keys = np.unique(
        rng.integers(0, 1 << top, 4 * n, dtype=np.int64) | (np.int64(1) << top)
    )[:n]
    lo = 1 << 17 if hi_bits else 1
    ids = rng.integers(lo, lo + 1000, len(keys), dtype=np.int32)
    idx = lane_index.LaneKmerIndex.build(keys, ids)
    assert idx is not None and idx.packed == (not hi_bits)
    return keys, idx


@pytest.mark.parametrize("hi_bits", [False, True])
@pytest.mark.parametrize("shape", [(0,), (1,), (3, 1001), (16384, 151)])
def test_lane_kernel_matches_plain(cuda, hi_bits, shape):
    rng = np.random.default_rng(len(shape) + hi_bits)
    keys, idx = _lane_tables(rng, 3000, hi_bits)
    n = int(np.prod(shape))
    q = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    q[::3] = keys[rng.integers(0, len(keys), len(q[::3]))]
    q = torch.from_numpy(q.reshape(shape)).to(cuda)
    args = (*idx.device_arrays(cuda), *idx.static_params())
    before = lane_index.lane_lookup.launches
    got = lane_index.lane_lookup(*args, q)
    want = lane_index.lookup_plain(*args, q)
    assert torch.equal(got, want)
    assert lane_index.lane_lookup.launches == before + (n > 0)
    np.testing.assert_array_equal(got.cpu().numpy(), idx.lookup_np(q.cpu().numpy()))


def _cost_cap_table(rng):
    """A layout near the largest LaneKmerIndex.build makes (70,000 keys, groups x
    slots within 10% of MAX_COST), too large for shared memory."""
    keys = np.unique(rng.integers(0, 1 << 44, 4 * 70_000) | (np.int64(1) << 44))[:70_000]
    idx = lane_index.LaneKmerIndex.build(keys, rng.integers(1, 1000, len(keys)).astype(np.int32))
    assert idx.groups * idx.slots > 0.9 * lane_index.LaneKmerIndex.MAX_COST
    return keys, idx


@pytest.mark.parametrize("table", ["shared", "l2"])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 4097, 1_000_003])
@pytest.mark.parametrize("offset", [0, 1])
def test_lane_kernel_paths_ragged_and_offset_views(cuda, table, n, offset):
    """Both table paths (a 3,000-key table in shared memory, a table at
    the cost cap probed in L2) on query counts around the 4-key vector
    and on a view one key off 16-byte alignment, against lookup_plain;
    l2_launches counts the L2 path only."""
    rng = np.random.default_rng(n + offset)
    keys, idx = (_lane_tables(rng, 3000, False) if table == "shared"
                 else _cost_cap_table(rng))
    args = (*idx.device_arrays(cuda), *idx.static_params())
    assert lane_index.fits_shared(cuda, idx.nb, idx.slots, idx.rows, idx.packed) == (
        table == "shared")
    q = rng.integers(-(1 << 62), 1 << 62, n + offset, dtype=np.int64)
    q[::2] = keys[rng.integers(0, len(keys), len(q[::2]))]
    view = torch.from_numpy(q).to(cuda)[offset:]
    assert view.data_ptr() % 16 == 8 * offset
    before = (lane_index.lane_lookup.launches, lane_index.lane_lookup.l2_launches)
    got = lane_index.lane_lookup(*args, view)
    torch.cuda.synchronize()
    assert (lane_index.lane_lookup.launches, lane_index.lane_lookup.l2_launches) == (
        before[0] + 1, before[1] + (table == "l2"))
    assert torch.equal(got, lane_index.lookup_plain(*args, view))


@pytest.mark.parametrize("packed", [True, False])
def test_lane_variants_agree_and_do_not_count(cuda, packed):
    """The original kernel, kept for timing (and serving tables past shared
    memory), equals the shared-memory kernel; neither counts as a
    launch."""
    rng = np.random.default_rng(4 + packed)
    keys, idx = _lane_tables(rng, 3000, not packed)
    args = (*idx.device_arrays(cuda), *idx.static_params())
    q = rng.integers(-(1 << 62), 1 << 62, 100_001, dtype=np.int64)
    q[::3] = keys[rng.integers(0, len(keys), len(q[::3]))]
    q = torch.from_numpy(q).to(cuda)
    want = lane_index.lookup_plain(*args, q)
    before = (lane_index.lane_lookup.launches, lane_index.lane_lookup.l2_launches)
    for name in lane_index.VARIANTS:
        assert torch.equal(lane_index.lane_lookup_variant(name, *args, q), want), name
    torch.cuda.synchronize()
    assert (lane_index.lane_lookup.launches, lane_index.lane_lookup.l2_launches) == before


@pytest.mark.parametrize("n", [0, 1, 31, 4095, 4096, 4097, (1 << 20) + 3, 5_000_000])
def test_cummax_kernel_matches_plain(cuda, n):
    gen = torch.Generator().manual_seed(n)
    v = torch.randint(-(2**63), 2**63 - 1, (n,), generator=gen, dtype=torch.int64)
    v[::7] = -(2**63)
    v = v.to(cuda)
    before = scan.cummax_i64.launches
    got = scan.cummax_i64(v)
    assert torch.equal(got, scan.cummax_plain(v))
    assert scan.cummax_i64.launches == before + (n > 0)


def test_cummax_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError):
        scan.cummax_i64(torch.zeros(8, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        scan.cummax_i64(torch.zeros((4, 4), dtype=torch.int64, device=cuda))


def _cummax_tile():
    from bbtools_torch.kernels.build import library

    return library().cummax_i64_tile()


def _cummax_random(n, seed):
    gen = torch.Generator().manual_seed(seed)
    v = torch.randint(-(2**62), 2**62, (n,), generator=gen, dtype=torch.int64)
    v[v.abs() < 2**60] *= -1
    v[::997] = -(2**63)
    return v


@pytest.mark.parametrize("edge", ["1", "tile-1", "tile", "tile+1", "2tile+1", "1265711",
                                  "5000003"])
def test_cummax_one_pass_at_tile_and_look_back_edges(cuda, edge):
    """The one-pass kernel at element counts around its tile, over the
    join chunk's 1,265,711 and over 5,000,003 (look-backs of more than 32
    tiles), against cummax_plain, one launch counted."""
    tile = _cummax_tile()
    n = {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
         "2tile+1": 2 * tile + 1}.get(edge) or int(edge)
    v = _cummax_random(n, n).to(cuda)
    before = scan.cummax_i64.launches
    got = scan.cummax_i64(v)
    torch.cuda.synchronize()
    assert scan.cummax_i64.launches == before + 1
    assert torch.equal(got, scan.cummax_plain(v))


@pytest.mark.parametrize("pattern", ["all_int64_min", "descending"])
def test_cummax_one_pass_carries(cuda, pattern):
    """All INT64_MIN (the identity everywhere), and a strictly descending
    input, whose every output is the first element: each tile's prefix
    comes from tile 0 through the look-back."""
    n = 1_265_711
    if pattern == "all_int64_min":
        v = torch.full((n,), -(2**63), dtype=torch.int64, device=cuda)
    else:
        v = torch.arange(2**62, 2**62 - n, -1, dtype=torch.int64, device=cuda)
    got = scan.cummax_i64(v)
    assert torch.equal(got, scan.cummax_plain(v))
    assert bool((got == v[0]).all())


def test_cummax_one_pass_in_a_cuda_graph(cuda):
    """50 calls captured in one CUDA graph, on inputs of three sizes, each
    exact on every replay: the records' epochs, not a memset before each
    call, keep each call from reading an earlier call's records."""
    sizes = (1_265_711, 4097, 300_001)
    inputs = [_cummax_random(sizes[i % 3], i).to(cuda) for i in range(50)]
    wants = [scan.cummax_plain(v) for v in inputs]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [scan.cummax_i64(v) for v in inputs]
    for _ in range(3):
        for o in outs:
            o.fill_(0)
        graph.replay()
        torch.cuda.synchronize()
        for i, (o, w) in enumerate(zip(outs, wants)):
            assert torch.equal(o, w), i


def test_cummax_one_pass_scratch_belongs_to_its_capture(cuda):
    """A stream whose first call is made inside a capture: an eager call on
    that stream before the first replay, and then the replay, are exact
    (the capture's scratch is its graph's, zeroed by the graph, not the
    stream's). Two graphs captured on torch's shared capture stream,
    replayed at the same time on two streams, keep to their own scratch
    and stay exact."""
    v = [_cummax_random(1_265_711, 40 + i).to(cuda) for i in range(4)]
    wants = [scan.cummax_plain(x) for x in v]
    fresh = torch.cuda.Stream()
    fresh.wait_stream(torch.cuda.current_stream())
    first = torch.cuda.CUDAGraph()
    with torch.cuda.graph(first, stream=fresh):
        captured = scan.cummax_i64(v[0])
    with torch.cuda.stream(fresh):
        eager = scan.cummax_i64(v[1])
    torch.cuda.synchronize()
    assert torch.equal(eager, wants[1])
    first.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, wants[0])

    graphs, outs = [], []
    for i in (2, 3):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            outs.append([scan.cummax_i64(v[i]) for _ in range(10)])
        graphs.append(g)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    for _ in range(20):
        for g, st in zip(graphs, streams):
            with torch.cuda.stream(st):
                g.replay()
    torch.cuda.synchronize()
    for i, o in zip((2, 3), outs):
        assert all(torch.equal(x, wants[i]) for x in o), i


def test_cummax_variants_agree_and_do_not_count(cuda):
    """The first port's three-launch kernel equals the main kernel, and
    neither variant counts as a launch."""
    v = _cummax_random(1_265_711, 3).to(cuda)
    want = scan.cummax_i64(v)
    before = scan.cummax_i64.launches
    for name in scan.VARIANTS:
        assert torch.equal(scan.cummax_i64_variant(name, v), want), name
        assert torch.equal(scan.cummax_i64(v), want), name
    torch.cuda.synchronize()
    assert scan.cummax_i64.launches == before + len(scan.VARIANTS)


@pytest.mark.parametrize("panel", ["ref=adapters", "literal=AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"])
def test_bbduk_cuda_equals_cpu(cuda, tmp_path, panel):
    from bbtools_torch.cli import main

    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    adapter = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    with open(tmp_path / "in.fq", "wb") as fh:
        for i in range(3000):
            L = int(rng.integers(40, 152))
            seq = acgt[rng.integers(0, 5 if i % 9 == 0 else 4, L)].copy()
            if i % 2 == 0:
                p = int(rng.integers(0, L))
                seq[p:] = np.frombuffer((adapter * 5)[: L - p], np.uint8)
            q = (33 + rng.integers(2, 41, L)).astype(np.uint8)
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), q.tobytes()))
    outs = {}
    for dev in ("cuda", "cpu"):
        out, st = tmp_path / f"{dev}.fq", tmp_path / f"{dev}.txt"
        main(["bbduk", f"in={tmp_path / 'in.fq'}", f"out={out}", f"stats={st}",
              panel, "k=23", "mink=11", "hdist=1", "ktrim=r", "minlen=40",
              f"device={dev}"])
        outs[dev] = (out.read_bytes(), st.read_bytes())
    assert outs["cuda"] == outs["cpu"]


# ---------------------------------------------------------------------------
# B6 lane_table, B5 overlap_scan, B3 mm_match (kernels of the BBMerge / BBDuk
# tbo / matcher slice)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_table", [60, 1025, 2048])
@pytest.mark.parametrize("shape", [(0,), (1,), (8192, 290)])
def test_lane_table_kernel_matches_plain(cuda, n_table, shape):
    from bbtools_torch.ops import lane_table

    rng = np.random.default_rng(n_table)
    table = rng.standard_normal(n_table).astype(np.float32)
    table[:3] = np.array([0x80000000, 0x00000001, 0x7FC00001],
                         np.uint32).view(np.float32)  # -0, subnormal, NaN
    packed = torch.from_numpy(lane_table.pack_table(table)).to(cuda)
    idx = rng.integers(-3, packed.numel() + 3, shape).astype(np.int32)
    idx = torch.from_numpy(idx).to(cuda)
    before = lane_table.lookup.launches
    got = lane_table.lookup(packed, idx)
    want = lane_table.lookup_plain(packed, idx)
    assert got.dtype == torch.float32 and got.shape == idx.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert lane_table.lookup.launches == before + (idx.numel() > 0)


@pytest.mark.parametrize("B,L,min0,D", [
    (1, 10, 5, 20), (77, 51, 5, 94), (300, 151, 12, 289), (64, 120, 13, 240),
    (33, 40, 60, 9),
])
def test_overlap_scan_kernel_matches_plain(cuda, B, L, min0, D):
    from bbtools_torch.ops.overlap_scan import overlap_counts, overlap_counts_plain

    rng = np.random.default_rng(B + L)
    a = torch.from_numpy(rng.integers(0, 5, (B, L)).astype(np.uint8)).to(cuda)
    b = torch.from_numpy(rng.integers(0, 5, (B, L)).astype(np.uint8)).to(cuda)
    al = torch.from_numpy(rng.integers(1, L + 1, B).astype(np.int32)).to(cuda)
    bl = torch.from_numpy(rng.integers(1, L + 1, B).astype(np.int32)).to(cuda)
    before = overlap_counts.launches
    got = overlap_counts(a, b, al, bl, min0, D)
    want = overlap_counts_plain(a, b, al, bl, min0, D)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert overlap_counts.launches == before + 1


def _overlap_check(a, b, al, bl, min0, D):
    """The bit-sliced kernel against overlap_counts_plain, and the
    variants, exactly; one launch counted."""
    from bbtools_torch.ops.overlap_scan import (VARIANTS, overlap_counts,
                                                overlap_counts_plain, overlap_counts_variant)

    before = overlap_counts.launches
    got = overlap_counts(a, b, al, bl, min0, D)
    torch.cuda.synchronize()
    assert overlap_counts.launches == before + 1
    want = overlap_counts_plain(a, b, al, bl, min0, D)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for name in VARIANTS:
        for g, w in zip(overlap_counts_variant(name, a, b, al, bl, min0, D), want):
            assert torch.equal(g, w), name
    torch.cuda.synchronize()
    assert overlap_counts.launches == before + 1
    return want


@pytest.mark.parametrize("codes", ["0..255", "0..15", "all_N", "N_and_pad9"])
@pytest.mark.parametrize("L", [31, 33, 151, 250])
def test_overlap_scan_exact_on_every_code(cuda, codes, L):
    """Codes drawn from 0..255 (every pair compares 8 planes), 0..15 (4
    planes), all N, and 0..4 with the JAX package's pad code 9; L not a
    multiple of 32; lengths of 0 and of L; inserts past alen + blen."""
    rng = np.random.default_rng(L + len(codes))
    B = 300
    hi = {"0..255": 256, "0..15": 16, "all_N": 5, "N_and_pad9": 5}[codes]
    a = rng.integers(0, hi, (B, L)).astype(np.uint8)
    b = rng.integers(0, hi, (B, L)).astype(np.uint8)
    if codes == "0..255":
        # equal bytes at random places, so matches occur at every code
        same = rng.random((B, L)) < 0.5
        b[same] = a[same]
    if codes == "all_N":
        a[:] = 4
        b[: B // 2] = 4
    if codes == "N_and_pad9":
        a[rng.random((B, L)) < 0.1] = 9
        b[rng.random((B, L)) < 0.1] = 9
    al = rng.integers(0, L + 1, B).astype(np.int32)
    bl = rng.integers(0, L + 1, B).astype(np.int32)
    al[:4], bl[:4] = [0, L, 0, L], [0, 0, L, L]
    min0, D = 1, 2 * L + 20  # the last 20 inserts lie past every alen + blen
    t = {k: torch.from_numpy(x).to(cuda) for k, x in dict(a=a, b=b, al=al, bl=bl).items()}
    good, bad, olen = _overlap_check(t["a"], t["b"], t["al"], t["bl"], min0, D)
    assert int(olen[:, -20:].abs().sum()) == 0
    if codes != "all_N":
        assert int(good.sum()) > 0 and int(bad.sum()) > 0


def test_overlap_scan_one_merge_batch(cuda):
    """8,192 pairs of 150 bp at the BBMerge main path's shapes (codes
    0-4, min0 12, D 289), a pair with a code above 15 among them."""
    rng = np.random.default_rng(5)
    B, L = 8192, 150
    frag = rng.integers(0, 4, (B, 2 * L)).astype(np.uint8)
    a = frag[:, :L].copy()
    b = frag[:, 60 : 60 + L].copy()
    a[rng.random((B, L)) < 0.01] = 4
    a[17, 3] = 200
    t = [torch.from_numpy(x).to(cuda) for x in
         (a, b, np.full(B, L, np.int32), rng.integers(100, L + 1, B).astype(np.int32))]
    good, _, _ = _overlap_check(*t, 12, 289)
    assert int(good.max()) >= 80  # insert blen + 60: a 90-position overlap


@pytest.mark.parametrize("L", [2100, 20_000])
def test_overlap_scan_long_reads(cuda, L):
    """Reads so long that a block holds fewer than its 8 pairs (L 2,100:
    4 pairs in 25 KB of shared memory), or that one pair needs more than
    48 KB and the launch opts in (L 20,000: 60 KB); codes 0..4 and, on
    half the pairs, 0..255; lengths of 0, of L and between; inserts
    around L, where the windows are longest."""
    rng = np.random.default_rng(L)
    B = 6
    a = rng.integers(0, 5, (B, L)).astype(np.uint8)
    b = rng.integers(0, 5, (B, L)).astype(np.uint8)
    a[3:] = rng.integers(0, 256, (3, L))
    b[3:] = np.where(rng.random((3, L)) < 0.5, a[3:], rng.integers(0, 256, (3, L)))
    al = np.array([0, L, L, L - 17, 5, L], np.int32)
    bl = np.array([L, 0, L, L, L - 3, L // 2], np.int32)
    t = [torch.from_numpy(x).to(cuda) for x in (a, b, al, bl)]
    good, bad, olen = _overlap_check(*t, L - 150, 300)
    assert int(olen.max()) == L and int(good.sum()) > 0 and int(bad.sum()) > 0


@pytest.mark.parametrize("k,mink,hdist", [(23, 11, 2), (13, 0, 1), (31, 11, 1)])
def test_mm_kernel_matches_plain(cuda, k, mink, hdist):
    from bbtools_torch.ops import mm_match

    rng = np.random.default_rng(k)
    scafs = [rng.integers(0, 4, 60).astype(np.uint8) for _ in range(30)]
    idx = mm_match.MMKmerIndex.build(scafs, k, mink=mink, hdist=hdist)
    assert idx is not None
    km, pr = idx.device_arrays(cuda)
    q = []
    for i in range(5000):
        s = scafs[i % 30]
        ln = k if (not mink or i % 3) else int(rng.integers(mink, k))
        codes = s[: ln].astype(np.int64).copy()
        for _ in range(i % 5):
            codes[rng.integers(0, ln)] = rng.integers(0, 4)
        fwd = 0
        for c in codes:
            fwd = (fwd << 2) | int(c)
        rc = int(mm_match.rc_kmer_np(np.array([fwd], np.int64), ln)[0])
        q.append(max(fwd, rc) | (1 << (2 * ln)))
    q = torch.tensor(q, dtype=torch.int64, device=cuda).reshape(50, 100)
    before = mm_match.mm_lookup.launches
    got = mm_match.mm_lookup(km, pr, *idx.static_params(), q)
    want = mm_match.mm_lookup_plain(km, pr, *idx.static_params(), q)
    assert torch.equal(got, want)
    assert mm_match.mm_lookup.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), idx.lookup_np(q.cpu().numpy()))
    assert int((got > 0).sum()) > 1000


def _kmer_key(codes):
    """Canonical key of a k-mer of 2-bit codes, with its length tag."""
    from bbtools_torch.ops import mm_match

    ln = len(codes)
    fwd = 0
    for c in codes:
        fwd = (fwd << 2) | int(c)
    rc = int(mm_match.rc_kmer_np(np.array([fwd], np.int64), ln)[0])
    return max(fwd, rc) | (1 << (2 * ln))


def _mm_queries(rng, scafs, k, mink, n, mutate=2):
    """n seeded queries: k-mers (and short k-mers when mink) of the
    scaffolds with up to `mutate` substitutions, and random keys."""
    q = []
    for i in range(n):
        if i % 4 == 3:
            ln = k if not mink or i % 3 else int(rng.integers(mink, k))
            q.append(_kmer_key(rng.integers(0, 4, ln)))
            continue
        s = scafs[int(rng.integers(0, len(scafs)))]
        ln = k if (not mink or i % 3) else int(rng.integers(mink, k))
        p = int(rng.integers(0, len(s) - ln + 1))
        codes = s[p : p + ln].astype(np.int64).copy()
        for _ in range(int(rng.integers(0, mutate + 1))):
            codes[rng.integers(0, ln)] = rng.integers(0, 4)
        q.append(_kmer_key(codes))
    return np.asarray(q, np.int64)


def _mm_check(idx, q_np, cuda, *, min_hits=0):
    """The kernel against mm_lookup_plain and lookup_np, exactly, and one
    launch counted."""
    from bbtools_torch.ops import mm_match

    km, pr = idx.device_arrays(cuda)
    q = torch.from_numpy(q_np).to(cuda)
    before = mm_match.mm_lookup.launches
    got = mm_match.mm_lookup(km, pr, *idx.static_params(), q)
    torch.cuda.synchronize()
    assert mm_match.mm_lookup.launches == before + (q.numel() > 0)
    want = mm_match.mm_lookup_plain(km, pr, *idx.static_params(), q)
    assert torch.equal(got, want)
    # the host oracle's int32 product is slow: the first 4,096 queries
    np.testing.assert_array_equal(got[:4096].cpu().numpy(), idx.lookup_np(q_np[:4096]))
    assert int((got > 0).sum()) >= min_hits
    return got


@pytest.mark.parametrize("n", [1, 127, 129, 511, 513, 65_537])
def test_mm_kernel_ragged_query_counts(cuda, n):
    """Query counts that are not a multiple of the kernel's query tile."""
    from bbtools_torch.ops import mm_match

    rng = np.random.default_rng(n)
    scafs = [rng.integers(0, 4, 60).astype(np.uint8) for _ in range(30)]
    idx = mm_match.MMKmerIndex.build(scafs, 23, mink=11, hdist=2)
    _mm_check(idx, _mm_queries(rng, scafs, 23, 11, n), cuda,
              min_hits=min(1, n // 2))


@pytest.mark.parametrize("k,mink,hdist", [(23, 11, 2), (31, 11, 1)])
def test_mm_kernel_many_column_tiles(cuda, k, mink, hdist):
    """A panel of >= 4,096 columns (many staged tiles), at Kp=128 and at
    Kp=256 (k=31, mink=11)."""
    from bbtools_torch.ops import mm_match

    rng = np.random.default_rng(k + 100)
    scafs = [rng.integers(0, 4, 80).astype(np.uint8) for _ in range(45)]
    idx = mm_match.MMKmerIndex.build(scafs, k, mink=mink, hdist=hdist)
    assert idx.Dp >= 4096 and idx.Kp == (128 if k == 23 else 256)
    _mm_check(idx, _mm_queries(rng, scafs, k, mink, 20_000), cuda, min_hits=5000)


def test_mm_kernel_all_miss(cuda):
    from bbtools_torch.ops import mm_match

    rng = np.random.default_rng(3)
    scafs = [np.zeros(60, np.uint8) for _ in range(3)]  # poly-A panel
    idx = mm_match.MMKmerIndex.build(scafs, 23, mink=11, hdist=2)
    # keys with at most 11 A's of 23 bases: far from poly-A
    codes = rng.integers(1, 4, (9000, 23))
    codes[:, ::2] = rng.integers(0, 4, (9000, 12))
    codes[:, 1::2] = rng.integers(1, 4, (9000, 11))
    q = np.asarray([_kmer_key(c) for c in codes], np.int64)
    got = _mm_check(idx, q, cuda)
    assert int((got != 0).sum()) == 0


def test_mm_kernel_first_inserted_id_wins(cuda):
    """Queries within hamming distance of many columns: the id of the
    first-inserted key wins."""
    from bbtools_torch.ops import mm_match

    rng = np.random.default_rng(8)
    base = rng.integers(0, 4, 40).astype(np.uint8)
    scafs = []
    for i in range(40):  # 40 scaffolds, each one substitution off the base
        s = base.copy()
        s[i] = (s[i] + 1 + i % 3) % 4
        scafs.append(s)
    idx = mm_match.MMKmerIndex.build(scafs, 23, mink=11, hdist=2)
    q = np.asarray([_kmer_key(base[p : p + 23]) for p in range(18)] * 200, np.int64)
    got = _mm_check(idx, q, cuda, min_hits=len(q))
    # each base k-mer lies within one substitution of a k-mer of every
    # scaffold; the first scaffold's keys were inserted first
    assert bool((got == 1).all())


def test_mm_kernel_permuted_columns(cuda):
    """An index from `from_arrays` whose columns are out of priority
    order (and one trimmed to a ragged Dp): the same ids."""
    from bbtools_torch.ops import mm_match

    rng = np.random.default_rng(12)
    scafs = [rng.integers(0, 4, 70).astype(np.uint8) for _ in range(25)]
    idx = mm_match.MMKmerIndex.build(scafs, 23, mink=11, hdist=2)
    q = _mm_queries(rng, scafs, 23, 11, 30_000)
    want = mm_match.mm_lookup_plain(*idx.device_arrays("cpu"), *idx.static_params(),
                                    torch.from_numpy(q)).numpy()
    perm = rng.permutation(idx.Dp)
    shuffled = mm_match.MMKmerIndex.from_arrays(
        idx.keymat[:, perm], idx.prio[:, perm], idx.k, idx.mink, idx.n_raw)
    np.testing.assert_array_equal(_mm_check(shuffled, q, cuda).cpu().numpy(), want)
    real = int((idx.prio[0] != mm_match.BIG32).sum())
    ragged = mm_match.MMKmerIndex.from_arrays(
        idx.keymat[:, :real + 5], idx.prio[:, :real + 5], idx.k, idx.mink, idx.n_raw)
    assert ragged.Dp % 128
    np.testing.assert_array_equal(_mm_check(ragged, q, cuda).cpu().numpy(), want)


def test_mm_variants_agree_and_do_not_count(cuda):
    """The measurement variants that compute the lookup (twice the query
    tile, the original dp4a kernel) equal the main kernel; the epilogue
    variants give each query's max score and run; none counts as
    a launch."""
    from bbtools_torch.ops import mm_match

    rng = np.random.default_rng(2)
    scafs = [rng.integers(0, 4, 60).astype(np.uint8) for _ in range(30)]
    idx = mm_match.MMKmerIndex.build(scafs, 23, mink=11, hdist=2)
    km, pr = idx.device_arrays(cuda)
    q = torch.from_numpy(_mm_queries(rng, scafs, 23, 11, 3001)).to(cuda)
    args = (km, pr, *idx.static_params(), q)
    main = mm_match.mm_lookup(*args)
    before = mm_match.mm_lookup.launches
    for name in mm_match.LOOKUP_VARIANTS:
        assert torch.equal(mm_match.mm_lookup_variant(name, *args), main), name
    # float64 is exact for these small integer products (|s| < 256)
    oh = mm_match.query_onehot(q, idx.k, idx.mink, idx.Kp).double()
    smax = (oh @ km.view(torch.int8).t().double()).amax(dim=1).to(torch.int32)
    assert torch.equal(mm_match.mm_lookup_variant("max_only", *args), smax)
    mm_match.mm_lookup_variant("one_column", *args)
    torch.cuda.synchronize()
    assert mm_match.mm_lookup.launches == before


@pytest.mark.parametrize("n", [1, 3, 4, 5, 2_097_153])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_lane_table_kernel_ragged_and_offset_views(cuda, n, offset):
    """Lengths around the 4-element vector and index views at 4-byte
    offsets (not 16-byte aligned), against lookup_plain."""
    from bbtools_torch.ops import lane_table

    rng = np.random.default_rng(n + offset)
    table = rng.standard_normal(128).astype(np.float32)
    packed = torch.from_numpy(lane_table.pack_table(table)).to(cuda)
    base = torch.from_numpy(rng.integers(-2, 131, n + offset).astype(np.int32)).to(cuda)
    idx = base[offset:]
    assert idx.is_contiguous() and idx.data_ptr() % 16 == 4 * offset % 16
    before = lane_table.lookup.launches
    got = lane_table.lookup(packed, idx)
    torch.cuda.synchronize()
    assert lane_table.lookup.launches == before + 1
    assert torch.equal(got.view(torch.int32),
                       lane_table.lookup_plain(packed, idx).view(torch.int32))


@pytest.mark.parametrize("n", [1, 5, 2_097_153])
@pytest.mark.parametrize("offset", [0, 1])
def test_lane_table_variants_agree_and_do_not_count(cuda, n, offset):
    """The original kernel, kept for timing, equals lookup_plain too, and
    no variant counts as a launch."""
    from bbtools_torch.ops import lane_table

    rng = np.random.default_rng(n + offset)
    table = rng.standard_normal(128).astype(np.float32)
    packed = torch.from_numpy(lane_table.pack_table(table)).to(cuda)
    base = torch.from_numpy(rng.integers(-2, 131, n + offset).astype(np.int32)).to(cuda)
    idx = base[offset:]
    want = lane_table.lookup_plain(packed, idx).view(torch.int32)
    before = lane_table.lookup.launches
    for name in lane_table.VARIANTS:
        got = lane_table.lookup_variant(name, packed, idx)
        assert torch.equal(got.view(torch.int32), want), name
    torch.cuda.synchronize()
    assert lane_table.lookup.launches == before


def _pairs_fastq(path, n, seed, L=150, lo=100, hi=300):
    rng = np.random.default_rng(seed)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    adapter = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    with open(path, "wb") as fh:
        for i in range(n):
            frag = bytes(b"ACGT"[x] for x in rng.integers(0, 4, int(rng.integers(lo, hi + 1))))
            r1 = (frag + adapter + b"A" * L)[:L]
            r2 = (frag[::-1].translate(comp) + adapter + b"A" * L)[:L]
            for m, r in enumerate((r1, r2)):
                q = (33 + np.clip(41 - rng.exponential(7, L), 2, 40)).astype(np.uint8)
                fh.write(b"@p%d %d:N:0\n%s\n+\n%s\n" % (i, m + 1, r, q.tobytes()))
    return path


def test_bbmerge_and_tbo_cuda_equal_cpu(cuda, tmp_path):
    from bbtools_torch.cli import main

    fin = _pairs_fastq(tmp_path / "pairs.fq", 3000, 9)
    outs = {}
    for dev in ("cuda", "cpu"):
        files = [tmp_path / f"{dev}.{x}" for x in ("m.fq", "u1.fq", "u2.fq", "ih.txt",
                                                  "tbo.fq", "tbo.txt")]
        main(["bbmerge", f"in={fin}", f"out={files[0]}", f"outu1={files[1]}",
              f"outu2={files[2]}", f"ihist={files[3]}", f"device={dev}"])
        main(["bbduk", f"in={fin}", f"out={files[4]}", f"stats={files[5]}",
              "literal=AGATCGGAAGAGCACACGTCTGAACTCCAGTCA", "k=23", "mink=11",
              "hdist=1", "ktrim=r", "minlen=40", "tbo", "tpe", f"device={dev}"])
        outs[dev] = [f.read_bytes() for f in files]
    assert outs["cuda"] == outs["cpu"]
    assert outs["cuda"][0].count(b"\n+\n") > 1000


@pytest.mark.parametrize("quality", [False, True])
def test_overlap_device_path_matches_host_oracles(cuda, quality):
    """The torch loops of ops/overlap.py on the card (insert scan kernel,
    quality scan, mate selection, efilter, pfilter, entropy) against the
    port's numpy oracles, copied from the JAX package: f32 bit for bit."""
    from bbtools_torch.ops import overlap as T
    from bbtools_torch.ops.overlap_scan import overlap_counts_plain

    rng = np.random.default_rng(41)
    B, L = 3000, 151
    frag = rng.integers(0, 4, (B, 2 * L)).astype(np.uint8)
    ins = rng.integers(30, 2 * L, B)
    alens = rng.integers(60, L + 1, B)
    a = np.full((B, L), 4, np.uint8)
    b_rc = np.full((B, L), 4, np.uint8)
    blens = np.zeros(B, np.int64)
    for r in range(B):
        a[r, : alens[r]] = frag[r, : alens[r]]
        tail = frag[r, max(ins[r] - int(rng.integers(60, L + 1)), 0) : ins[r]]
        b_rc[r, : len(tail)] = tail
        blens[r] = len(tail)
    a[rng.random((B, L)) < 0.01] = 4
    aq = rng.integers(2, 41, (B, L)).astype(np.uint8)
    bq = rng.integers(2, 41, (B, L)).astype(np.uint8)
    m0, D = 12, int((alens + blens).max() - 12 + 1)
    mo = rng.integers(8, 14, B)
    consts = (5, mo, m0, 15, 0.09, 0.1, 5.5, 0.55)
    good, bad, olen = (x.numpy() for x in overlap_counts_plain(
        *(torch.from_numpy(v) for v in (a, b_rc, alens, blens)), m0, D))
    gf = bf = None
    if quality:
        gf, bf, _, _ = T.overlap_counts_quality_np(a, b_rc, aq, bq, alens, blens, m0, D)
    want = T.mate_by_overlap_ratio_np(good, bad, olen, alens, blens, m0, *consts,
                                      good_f=gf, bad_f=bf)
    d = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
         for k, v in dict(a=a, b=b_rc, al=alens, bl=blens, aq=aq, bq=bq, mo=mo).items()}
    got = T.overlap_and_mate(d["a"], d["b"], d["al"], d["bl"], m0, D, 5, d["mo"],
                             *consts[2:], aq=d["aq"] if quality else None,
                             bq_rev=d["bq"] if quality else None)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.cpu().numpy(), w)
    assert (want[0] > 0).sum() > B // 4
    ov = np.where(want[0] > 0, want[0], 1)
    for name in ("expected_mismatches", "probability"):
        w = getattr(T, f"{name}_np")(a, b_rc, aq, bq, alens, blens, ov)
        g = getattr(T, f"{name}_torch")(d["a"], d["b"], d["aq"], d["bq"], d["al"],
                                        d["bl"], torch.from_numpy(ov).to(cuda))
        np.testing.assert_array_equal(g.cpu().numpy().view(np.int32), w.view(np.int32))
    for tail in (True, False):
        w = T.calc_min_overlap_by_entropy_np(a, alens, 3, 39, tail)
        g = T.calc_min_overlap_by_entropy_torch(d["a"], d["al"], 3, 39, tail)
        np.testing.assert_array_equal(g.cpu().numpy(), w)


def test_bbduk_mm_backend_cuda_equals_cpu(cuda, tmp_path, monkeypatch):
    """BBDuk on the matcher backend (forced on a small hdist=1 panel by
    declining the lane table and the sorted join): CUDA output and stats
    byte-equal to the CPU's."""
    from bbtools_torch.models import bbduk
    from bbtools_torch.ops.lane_index import LaneKmerIndex
    from bbtools_torch.ops.mm_match import mm_lookup

    rng = np.random.default_rng(21)
    scafs = [bytes(b"ACGT"[x] for x in rng.integers(0, 4, 50)) for _ in range(60)]
    (tmp_path / "panel.fa").write_bytes(
        b"".join(b">s%d\n%s\n" % (i, s) for i, s in enumerate(scafs)))
    with open(tmp_path / "in.fq", "wb") as fh:
        for i in range(4000):
            seq = bytearray(bytes(b"ACGT"[x] for x in rng.integers(0, 4, 120)))
            if i % 3 == 0:
                piece = bytearray(scafs[i % 60][:35])
                piece[9] = b"ACGT"[(b"ACGT".index(piece[9]) + 2) % 4]
                seq[85:] = piece
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, bytes(seq), b"F" * 120))
    monkeypatch.setattr(LaneKmerIndex, "supports", staticmethod(lambda n: False))
    monkeypatch.setattr(bbduk, "_join_eligible", lambda cfg, n: False)
    outs = {}
    for dev in ("cuda", "cpu"):
        out, st = tmp_path / f"{dev}.fq", tmp_path / f"{dev}.txt"
        before = mm_lookup.launches
        bbduk.main([f"in={tmp_path / 'in.fq'}", f"out={out}", f"stats={st}",
                    f"ref={tmp_path / 'panel.fa'}", "k=23", "mink=11", "hdist=1",
                    "ktrim=r", "minlen=40", f"device={dev}"])
        assert (mm_lookup.launches > before) == (dev == "cuda")
        outs[dev] = (out.read_bytes(), st.read_bytes())
    assert outs["cuda"] == outs["cpu"]
    assert b"#Matched\t0\t" not in outs["cuda"][1]


# ---------------------------------------------------------------------------
# B4 msa_fill (the BBMap slice)
# ---------------------------------------------------------------------------


def _msa_tasks(rng, S, R, Cc, lmin):
    """Seeded near-match fill tasks: each read is a slice of its window
    with substitutions and one indel, some N in reads and windows, code 4
    past each read's length."""
    refs = rng.integers(0, 4, (S, Cc)).astype(np.uint8)
    refs[rng.random((S, Cc)) < 0.003] = 4
    lens = rng.integers(lmin, R + 1, S).astype(np.int32)
    reads = np.full((S, R), 4, np.uint8)
    for s in range(S):
        n = int(lens[s])
        start = int(rng.integers(0, max(Cc - n - 12, 1)))
        src = refs[s, start : start + n + 12].copy()
        p = int(rng.integers(0, max(n - 10, 1)))
        cut = int(rng.integers(0, 11))
        src = np.concatenate([src[:p], src[p + cut :]]) if s % 2 else np.concatenate(
            [src[:p], rng.integers(0, 4, cut).astype(np.uint8), src[p:]])
        src = np.resize(src, n) if len(src) < n else src[:n]
        m = rng.random(n) < 0.03
        src[m] = (src[m] + rng.integers(1, 4, int(m.sum()))) % 4
        src[rng.random(n) < 0.003] = 4
        reads[s, :n] = src
    return reads, lens, refs


@pytest.mark.parametrize("S,R,Cc,lmin", [
    (512, 256, 280, 140),  # window class 0 of a batch of 151 bp reads (L=256)
    (64, 256, 2328, 140),  # window class 3 (L + 2072)
    (256, 250, 274, 100),  # mixed lengths
    (512, 151, 175, 151),  # class 0 of reads exactly as long as the batch
    (3, 1, 1, 0), (7, 9, 4, 0), (5, 31, 33, 0),  # tiny and ragged
    (4, 1100, 1130, 900),  # two rows per thread
])
def test_msa_fill_kernel_matches_plain(cuda, S, R, Cc, lmin):
    """The wrapper's choice, and each kernel over every task."""
    from bbtools_torch.ops.msa_fill import msa_fill, msa_fill_plain, msa_fill_variant

    rng = np.random.default_rng(S + R + Cc)
    reads, lens, refs = (torch.from_numpy(x).to(cuda)
                         for x in _msa_tasks(rng, S, R, Cc, lmin))
    before = _b4_launches()
    got = msa_fill(reads, lens, refs)
    want = msa_fill_plain(reads, lens, refs)
    torch.cuda.synchronize()
    _assert_fill_equal(got, want, lens, Cc)
    assert _b4_launches() == before + 1
    if lmin >= 100:
        assert int((got[1] >= 0).sum()) == S  # every task aligned
    for name in ("warp", "band", "block"):
        _assert_fill_equal(msa_fill_variant(name, reads, lens, refs), want, lens, Cc)


def _b4_launches():
    """B4's launches on every route: the warp, band and block kernels."""
    from bbtools_torch.ops.msa_fill import msa_fill

    return msa_fill.launches + msa_fill.band_launches + msa_fill.block_launches


def _assert_fill_equal(got, want, lens, Cc):
    """Scores, columns and states equal; the planes equal in shape and on
    every live cell (the kernel leaves dead cells' bytes unspecified)."""
    from bbtools_torch.ops.msa_fill import live_cells

    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    live = live_cells(lens, got[3].shape[2] - 1, Cc)
    assert not bool(((got[3] != want[3]) & live).any())


@pytest.mark.parametrize("R,Cc", [(256, 280), (300, 330)])
@pytest.mark.parametrize("S", [96, 1600])
def test_msa_fill_warp_and_block_kernels_on_mixed_lengths(cuda, R, Cc, S):
    """Lengths 0, 1, 31, 32, 33, 255 and R in one call, with the rest
    mixed. The warp kernel takes every task of at most 256 rows and, at
    R = 300, the band kernel the tasks of more, in the same call; the
    wrapper takes the band kernel for all tasks of a call with fewer
    than WARP_MIN_TASKS_PER_SM tasks an SM, or the block kernel
    where `few_task_route` keeps the shape on it. Each count counts the
    calls that launched its kernel."""
    from bbtools_torch.ops.msa_fill import (WARP_MAX_ROWS, WARP_MIN_TASKS_PER_SM,
                                            few_task_route, msa_fill, msa_fill_plain,
                                            msa_fill_variant)

    rng = np.random.default_rng(R + S)
    reads, lens, refs = _msa_tasks(rng, S, R, Cc, 0)
    special = [0, 1, 31, 32, 33, 255, R]
    lens[: len(special)] = special
    reads[np.arange(R)[None, :] >= lens[:, None]] = 4
    reads, lens, refs = (torch.from_numpy(x).to(cuda) for x in (reads, lens, refs))
    want = msa_fill_plain(reads, lens, refs)
    before = (msa_fill.launches, msa_fill.band_launches, msa_fill.block_launches)
    got = msa_fill(reads, lens, refs)
    torch.cuda.synchronize()
    _assert_fill_equal(got, want, lens, Cc)
    for name in ("warp", "band", "block"):
        _assert_fill_equal(msa_fill_variant(name, reads, lens, refs), want, lens, Cc)
    long_tasks = int((lens + 1 > WARP_MAX_ROWS).sum())
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    warp = S - long_tasks >= WARP_MIN_TASKS_PER_SM * sms
    few = None if warp else few_task_route(int(lens.max()) + 1, S, sms)
    assert (msa_fill.launches, msa_fill.band_launches, msa_fill.block_launches) == (
        before[0] + warp, before[1] + (few == "band" or (warp and long_tasks > 0)),
        before[2] + (few == "block"))
    assert int(got[1][0]) >= 0 and int(got[1][6]) >= 0  # len 0 and len R align


def test_msa_fill_block_variant_equals_plain_and_does_not_count(cuda):
    """The three kernels over every task, as measurement variants, equal
    the plain fill on live cells, and no launch counts."""
    from bbtools_torch.ops.msa_fill import msa_fill, msa_fill_plain, msa_fill_variant

    rng = np.random.default_rng(9)
    reads, lens, refs = (torch.from_numpy(x).to(cuda)
                         for x in _msa_tasks(rng, 300, 256, 280, 100))
    before = _b4_launches()
    want = msa_fill_plain(reads, lens, refs)
    for name in ("warp", "band", "block"):
        _assert_fill_equal(msa_fill_variant(name, reads, lens, refs), want, lens, 280)
    torch.cuda.synchronize()
    assert _b4_launches() == before


def _band_case(rng, case):
    """(reads, lens, refs) of one band-kernel case."""
    if case.startswith("edges K="):  # 32K-1, 32K, 32K+1 rows, and 0, 1
        K = int(case.split("=")[1])
        lens = [32 * K - 2, 32 * K - 1, 32 * K, 0, 1, 3 * 32 * K]
        R = max(lens)
        reads, _, refs = _msa_tasks(rng, len(lens), R, R + 40, 0)
    elif case == "len 0, 1 and R'":
        lens = [0, 1, 700, 699, 2]
        reads, _, refs = _msa_tasks(rng, len(lens), 700, 760, 0)
    elif case == "one band beside many":
        lens = [17, 1500, 40, 1499]
        reads, _, refs = _msa_tasks(rng, len(lens), 1500, 1540, 0)
    elif case == "Cc < R'":
        lens = [900, 640, 33]
        reads, _, refs = _msa_tasks(rng, len(lens), 900, 300, 0)
    elif case == "N codes":
        reads, lens, refs = _msa_tasks(rng, 6, 500, 560, 300)
        reads[rng.random(reads.shape) < 0.05] = 4
        refs[rng.random(refs.shape) < 0.05] = 4
        refs[:, 100:130] = 4
        return reads, lens, refs
    else:  # "2,000 rows in 2,500 columns"
        reads, lens, refs = _msa_tasks(rng, 1, 2000, 2500, 2000)
        return reads, lens, refs
    lens = np.asarray(lens, np.int32)
    reads = reads[:, : int(lens.max())].copy() if lens.max() < reads.shape[1] else reads
    for s, n in enumerate(lens):
        reads[s, n:] = 4
        if n:  # a read of its window with a few substitutions
            start = int(rng.integers(0, max(refs.shape[1] - n, 1)))
            src = np.resize(refs[s, start : start + n], n).copy()
            m = rng.random(n) < 0.03
            src[m] = (src[m] + 1) % 4
            reads[s, :n] = src
    return reads, lens, refs


BAND_CASES = ["edges K=1", "edges K=2", "edges K=4", "edges K=8", "len 0, 1 and R'",
              "one band beside many", "Cc < R'", "N codes", "2,000 rows in 2,500 columns"]


@pytest.mark.parametrize("case", BAND_CASES)
def test_msa_fill_band_kernel_matches_plain(cuda, case):
    """The band kernel as the variant at every K, and the wrapper (a
    few-task call: the band kernel, or the block kernel where
    `few_task_route` keeps the shape on it), equal the plain fill on
    every output and every live plane byte; the wrapper counts one
    launch of its route and the variants none."""
    from bbtools_torch.ops.msa_fill import (BAND_K, few_task_route, msa_fill, msa_fill_plain,
                                            msa_fill_variant)

    rng = np.random.default_rng(len(case))
    reads, lens, refs = (torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
                         for x in _band_case(rng, case))
    Cc = refs.shape[1]
    want = msa_fill_plain(reads, lens, refs)
    before = (msa_fill.launches, msa_fill.band_launches, msa_fill.block_launches)
    got = msa_fill(reads, lens, refs)
    torch.cuda.synchronize()
    _assert_fill_equal(got, want, lens, Cc)
    band = few_task_route(int(lens.max()) + 1, len(lens), torch.cuda.get_device_properties(
        cuda).multi_processor_count) == "band"
    after = (before[0], before[1] + band, before[2] + (not band))
    assert (msa_fill.launches, msa_fill.band_launches, msa_fill.block_launches) == after
    for k in BAND_K:
        _assert_fill_equal(msa_fill_variant("band", reads, lens, refs, k=k), want, lens, Cc)
    torch.cuda.synchronize()
    assert (msa_fill.launches, msa_fill.band_launches, msa_fill.block_launches) == after
    assert int((got[1] >= 0).sum()) == int((lens >= 0).sum())


def test_msa_fill_band_kernel_two_calls_in_a_row(cuda):
    """Calls back to back on one stream, of other ticket counts, reuse
    the ticket counter and progress words without zeroing them: each
    call's epoch tells its words from the last call's."""
    from bbtools_torch.ops.msa_fill import msa_fill, msa_fill_plain, msa_fill_variant

    rng = np.random.default_rng(19)
    before = msa_fill.band_launches
    sets = [tuple(torch.from_numpy(x).to(cuda) for x in _msa_tasks(rng, S, R, R + 300, R - 50))
            for S, R in ((4, 1200), (3, 700), (4, 1200))]
    wants = [msa_fill_plain(*t) for t in sets]
    for _ in range(2):
        gots = [msa_fill(*t) for t in sets]
        gots += [msa_fill_variant("band", *t, k=1) for t in sets]
        torch.cuda.synchronize()
        for got, want, t in zip(gots, wants + wants, sets + sets):
            _assert_fill_equal(got, want, t[1], t[2].shape[1])
    assert msa_fill.band_launches == before + 6  # rows past BLOCK_MAX_ROWS: the band route


def test_msa_fill_kernel_rejects_what_it_does_not_take(cuda):
    from bbtools_torch.ops.msa_fill import msa_fill

    r = torch.zeros((4, 10), dtype=torch.uint8, device=cuda)
    n = torch.full((4,), 10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        msa_fill(r.int(), n, r)
    with pytest.raises(ValueError):
        msa_fill(r, n.long(), r)
    with pytest.raises(ValueError):
        msa_fill(r, n, r[:, ::2])


def test_bbmap_cuda_equals_cpu(cuda, tmp_path):
    """512 seeded reads with SNPs and indels, single end and paired:
    CUDA SAM byte-equal to the CPU's, with the fill kernel launched."""
    from bbtools_torch.cli import main
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.ops.msa_fill import msa_fill
    from bbtools_torch.utils.synth import random_genome, random_reads, write_reads

    write_fasta(str(tmp_path / "ref.fa"), random_genome(150_000, n_scaffolds=2, seed=7))
    ref = load_reference(str(tmp_path / "ref.fa"))
    write_reads(str(tmp_path / "r.fq"), random_reads(
        ref, 512, read_len=151, snp_rate=0.01, indel_rate=0.1,
        indel_range=(1, 10), seed=3))
    pairs = random_reads(ref, 256, read_len=151, paired=True,
                         insert_range=(200, 500), snp_rate=0.01, seed=4)
    write_reads(str(tmp_path / "p1.fq"), [p[0] for p in pairs])
    write_reads(str(tmp_path / "p2.fq"), [p[1] for p in pairs])
    outs = {}
    for dev in ("cuda", "cpu"):
        before = _b4_launches()
        se, pe = tmp_path / f"{dev}.sam", tmp_path / f"{dev}.pe.sam"
        main(["bbmap", f"ref={tmp_path / 'ref.fa'}", f"in={tmp_path / 'r.fq'}",
              f"out={se}", f"device={dev}"])
        main(["bbmap", f"ref={tmp_path / 'ref.fa'}", f"in={tmp_path / 'p1.fq'}",
              f"in2={tmp_path / 'p2.fq'}", f"out={pe}", f"device={dev}"])
        assert (_b4_launches() > before) == (dev == "cuda")
        outs[dev] = (se.read_bytes(), pe.read_bytes())
    assert outs["cuda"] == outs["cpu"]
    assert outs["cuda"][0].count(b"\n") > 512


@pytest.fixture(scope="module")
def repeat_genome(tmp_path_factory):
    """A seeded 150 kb genome of two scaffolds with planted repeats: a
    5 kb segment of scaffold 0 copied into scaffold 1 once exactly and
    once with 1% substitutions. Reads of 151 bp (and pairs from inserts
    of 200-500), three in eight of them drawn from the segment; indel
    reads (60% with an indel) for the walk-cap overflow."""
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.utils.synth import random_genome, random_reads, write_reads

    tmp = tmp_path_factory.mktemp("repeats")
    (n0, s0), (n1, s1) = random_genome(150_000, n_scaffolds=2, seed=13)
    rng = np.random.default_rng(14)
    seg = s0[20_000:25_000]
    mut = bytearray(seg)
    for p in rng.choice(len(seg), len(seg) // 100, replace=False):
        mut[p] = b"ACGT"[(b"ACGT".index(mut[p]) + int(rng.integers(1, 4))) % 4]
    s1 = s1[:30_000] + seg + s1[35_000:50_000] + bytes(mut) + s1[55_000:]
    write_fasta(str(tmp / "ref.fa"), [(n0, s0), (n1, s1)])
    write_fasta(str(tmp / "seg.fa"), [(b"segment", seg)])
    ref, segment = load_reference(str(tmp / "ref.fa")), load_reference(str(tmp / "seg.fa"))
    write_reads(str(tmp / "r.fq"), random_reads(
        ref, 160, read_len=151, snp_rate=0.01, indel_rate=0.1, seed=3) + random_reads(
        segment, 96, read_len=151, snp_rate=0.01, indel_rate=0.1, seed=4))
    pairs = random_reads(ref, 96, read_len=151, paired=True, insert_range=(200, 500),
                         snp_rate=0.01, seed=5) + random_reads(
        segment, 64, read_len=151, paired=True, insert_range=(200, 500), snp_rate=0.01,
        seed=6)
    write_reads(str(tmp / "p1.fq"), [p[0] for p in pairs])
    write_reads(str(tmp / "p2.fq"), [p[1] for p in pairs])
    write_reads(str(tmp / "indel.fq"), random_reads(
        ref, 64, read_len=151, snp_rate=0.01, indel_rate=0.6, seed=7) + random_reads(
        segment, 32, read_len=151, snp_rate=0.01, indel_rate=0.6, seed=8))
    return tmp


REPEAT_CASES = {
    "secondary_ambig_all": ["in=r.fq", "secondary=t", "ambig=all"],
    "paired_secondary_ambig_all": ["in=p1.fq", "in2=p2.fq", "secondary=t", "ambig=all"],
    "local": ["in=r.fq", "local=t"],
    "fused_f": ["in=r.fq", "fused=f"],
    "walk_cap_overflow": ["in=indel.fq", "batchreads=32"],
}


@pytest.mark.parametrize("case", list(REPEAT_CASES))
def test_bbmap_cuda_equals_cpu_on_repeats(cuda, repeat_genome, case):
    """BBMap's CUDA SAM and scafstats byte-equal to the CPU's on the
    repeat genome, with the fill kernel launched: ties between the exact
    copies, secondary sites on the mutated copy, the staged path
    (fused=f), local alignment, and batches of 32 whose indel reads
    overflow the fused phase's walk cap. The repeat reads must come out
    ambiguous (and, for single-end secondary=t, as flag-256 lines)."""
    from bbtools_torch.models import bbmap as tbbmap
    from bbtools_torch.ops.msa_fill import msa_fill

    d = repeat_genome
    args = [f"ref={d / 'ref.fa'}"] + [
        f"{f.split('=')[0]}={d / f.split('=')[1]}" if f.endswith(".fq") else f
        for f in REPEAT_CASES[case]]
    outs, tools = {}, {}
    for dev in ("cuda", "cpu"):
        sam, stats = d / f"{case}.{dev}.sam", d / f"{case}.{dev}.scafstats.txt"
        before = _b4_launches()
        tools[dev] = tbbmap.main([*args, f"out={sam}", f"scafstats={stats}", f"device={dev}"])
        assert (_b4_launches() > before) == (dev == "cuda")
        outs[dev] = (sam.read_bytes(), stats.read_bytes())
    assert outs["cuda"] == outs["cpu"]
    sam, stats = outs["cuda"]
    ambiguous = sum(int(ln.split(b"\t")[6]) for ln in stats.splitlines()[1:])
    assert ambiguous >= 20
    if case == "secondary_ambig_all":
        flags = [int(ln.split(b"\t")[1]) for ln in sam.splitlines() if not ln.startswith(b"@")]
        assert sum(f & 0x100 != 0 for f in flags) >= 20
    if case == "walk_cap_overflow":
        assert tools["cuda"].fused_overflows >= 2 and tools["cpu"].fused_overflows >= 2
    for tool in tools.values():
        assert tool.reads_mapped >= 0.95 * tool.reads_in


# ---- kmercountexact, Tadpole and CallVariants: their device counts and
# realignment on the card equal the CPU's, and the CLIs write the same
# bytes on both devices without falling back to a host route ----


def _kmer_batches(seed, n, B=64, L=150, fresh=False):
    g = np.random.default_rng(seed)
    genome = g.integers(0, 4, 20_000).astype(np.uint8)
    out = []
    for _ in range(n):
        if fresh:  # mostly new keys each batch
            bases = g.integers(0, 4, (B, L)).astype(np.uint8)
        else:
            starts = g.integers(0, len(genome) - L, B)
            bases = np.stack([genome[s : s + L] for s in starts])
            err = g.random((B, L)) < 0.01
            bases[err] = g.integers(0, 5, err.sum())
        out.append((bases, g.integers(L // 2, L + 1, B).astype(np.int32)))
    return out


@pytest.mark.parametrize("cap,sync_every,fresh", [(1 << 21, 8, False), (1 << 9, 4, True),
                                                  (1 << 12, 3, False)])
def test_device_spectrum_cuda_equals_cpu(cuda, cap, sync_every, fresh):
    """DeviceSpectrum on the card against the same on CPU tensors and the
    host KmerSpectrum: spectrum, histogram and capacity, with growth and
    late overflows replayed after growth (a 512-row carry, sync_every=4,
    mostly new keys each batch)."""
    from bbtools_torch.ops import kmer_count as kc

    batches = _kmer_batches(cap, 10, fresh=fresh)
    specs = {d: kc.DeviceSpectrum(31, cap=cap, sync_every=sync_every, device=d)
             for d in ("cuda", "cpu")}
    host = kc.KmerSpectrum(31)
    before = kc.merge_spectra.device_calls
    for bases, lengths in batches:
        for s in specs.values():
            s.add_batch(bases, lengths)
        host.add_batch(*kc.count_batch_np(bases, lengths, 31))
    host.flush()
    got, want = specs["cuda"].spectrum(), specs["cpu"].spectrum()
    for g, w, h in zip(got, want, (host.keys, host.counts)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, h)
    np.testing.assert_array_equal(specs["cuda"].histogram(200), specs["cpu"].histogram(200))
    assert specs["cuda"].cap == specs["cpu"].cap
    assert kc.merge_spectra.device_calls - before >= len(batches)
    if fresh:
        assert specs["cuda"].cap > cap  # grown, with replays


@pytest.mark.parametrize("k", [31, 62, 93])
def test_device_counts_cuda_equal_host_routes(cuda, k):
    """count_batch (k <= 31) and the W-word device count (k > 31) on the
    card against the host routes (np.unique; the native radix count)."""
    from bbtools_torch.ops import kmer_count as kc
    from bbtools_torch.ops import kmers2

    for bases, lengths in _kmer_batches(k, 3, B=512):
        if k <= 31:
            before = kc.sort_reduce.device_calls
            got = kc.count_batch(bases, lengths, k, device=cuda)
            want = kc.count_batch(bases, lengths, k, device="cpu")
            assert kc.sort_reduce.device_calls == before + 1
        else:
            before = kmers2.count_words.device_calls
            got = kmers2.count_batchw_exact(bases, lengths.astype(np.int64), k, cuda)
            want = kmers2.count_batchw_exact(bases, lengths.astype(np.int64), k, "cpu")
            assert kmers2.count_words.device_calls == before + 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert want[1].max() > 1


def test_realign_batch_cuda_equals_cpu(cuda):
    """realign_batch's fill and walk on the card over ragged windows."""
    from bbtools_torch.ops.msa import realign_batch

    g = np.random.default_rng(5)
    B, R, W = 128, 151, 551
    genome = g.integers(0, 4, 20_000).astype(np.uint8)
    reads = np.full((B, R), 4, np.uint8)
    rl = g.integers(90, R + 1, B).astype(np.int32)
    refs = np.full((B, W), 4, np.uint8)
    wl = g.integers(300, W + 1, B).astype(np.int32)
    for i in range(B):
        s = int(g.integers(0, len(genome) - W))
        refs[i, : wl[i]] = genome[s : s + wl[i]]
        r = genome[s + 150 : s + 150 + rl[i] + 8].copy()
        r[g.random(len(r)) < 0.03] = g.integers(0, 4)
        if i % 2:
            r = np.concatenate([r[:40], r[40 + i % 8 :]])
        reads[i, : rl[i]] = r[: rl[i]]
    got = realign_batch(reads, rl, refs, wl, cuda)
    want = realign_batch(reads, rl, refs, wl, "cpu")
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


def test_kmer_tools_cuda_equal_cpu(cuda, tmp_path):
    """kmercountexact (k=31 and k=93: khist, peaks, dump) and Tadpole
    (k=31 and k=62 contigs, k=31 mode=correct) write the same bytes on
    both devices. On the card every batch's count runs on the device:
    kmercountexact's k=31 merges into DeviceSpectrum (three batches,
    three merges), Tadpole's k=31 load takes count_batch's sort-reduce,
    and every k > 31 count the W-word device sort, one call a batch; on
    the CPU none of them."""
    from bbtools_torch.cli import main
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.ops import kmer_count as kc
    from bbtools_torch.ops import kmers2
    from bbtools_torch.utils.synth import random_genome, random_reads, write_reads

    write_fasta(str(tmp_path / "g.fa"), random_genome(20_000, seed=31))
    reads = random_reads(load_reference(str(tmp_path / "g.fa")), 3000, read_len=150,
                         snp_rate=0.005, seed=32)
    write_reads(str(tmp_path / "r.fq"), reads)
    write_reads(str(tmp_path / "ecc.fq"), reads[:600])  # the correction is host code
    fq = tmp_path / "r.fq"
    runs = {
        "kce31": (["kmercountexact", f"in={fq}", "k=31", "batchreads=1000"],
                  ["khist", "peaks", "dump"]),
        "kce93": (["kmercountexact", f"in={fq}", "k=93"], ["khist", "peaks", "dump"]),
        "tad31": (["tadpole", f"in={fq}", "k=31"], ["out"]),
        "tad62": (["tadpole", f"in={fq}", "k=62"], ["out"]),
        "ecc31": (["tadpole", f"in={tmp_path / 'ecc.fq'}", "k=31", "mode=correct"], ["out"]),
    }
    #: device calls a run makes on the card: (merges, sort-reduces,
    #: W-word sorts)
    expect = {"kce31": [3, 0, 0], "kce93": [0, 0, 1], "tad31": [0, 1, 0],
              "tad62": [0, 0, 1], "ecc31": [0, 1, 0]}

    def calls():
        return [kc.merge_spectra.device_calls, kc.sort_reduce.device_calls,
                kmers2.count_words.device_calls]

    files = {}
    for dev in ("cuda", "cpu"):
        for tag, (argv, outs) in runs.items():
            paths = [tmp_path / f"{tag}.{dev}.{o}" for o in outs]
            before = calls()
            main([*argv, *(f"{o}={p}" for o, p in zip(outs, paths)), f"device={dev}"])
            files[tag, dev] = [p.read_bytes() for p in paths]
            moved = [a - b for a, b in zip(calls(), before)]
            assert moved == (expect[tag] if dev == "cuda" else [0, 0, 0]), (tag, dev, moved)
    for tag in runs:
        assert files[tag, "cuda"] == files[tag, "cpu"], tag
    assert files["tad62", "cuda"][0].count(b">") >= 1


def test_callvariants_cuda_equals_cpu(cuda, tmp_path):
    """CallVariants realign=t and nn=t on the SAM of BBMap's CUDA run:
    the VCF equal on both devices, but for the last QUAL digit with
    nn=t, where the card's and the CPU's float32 matmuls may round a
    scaled score the other way (tests/test_torch_callvariants.py holds
    the same rule against the JAX package)."""
    from bbtools_torch.cli import main
    from bbtools_torch.core.dna import CODE_TO_BASE
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.utils.synth import mutate_genome, random_genome, random_reads, write_reads

    write_fasta(str(tmp_path / "ref.fa"), random_genome(30_000, seed=41))
    ref = load_reference(str(tmp_path / "ref.fa"))
    mutated, _ = mutate_genome(ref, sub_rate=0.003, seed=42)
    write_fasta(str(tmp_path / "mut.fa"),
                [(b"scaffold_0", CODE_TO_BASE[np.minimum(mutated[0], 4)].tobytes())])
    write_reads(str(tmp_path / "r.fq"), random_reads(
        load_reference(str(tmp_path / "mut.fa")), 2000, read_len=150, snp_rate=0.005,
        indel_rate=0.1, indel_range=(1, 10), seed=43))
    sam = tmp_path / "m.sam"
    main(["bbmap", f"ref={tmp_path / 'ref.fa'}", f"in={tmp_path / 'r.fq'}", f"out={sam}",
          "device=cuda"])
    for flags in (["realign=t"], ["nn=t", "minscore=10"]):
        vcf = {}
        for dev in ("cuda", "cpu"):
            out = tmp_path / f"{flags[0]}.{dev}.vcf"
            main(["callvariants", f"in={sam}", f"ref={tmp_path / 'ref.fa'}", f"vcf={out}",
                  *flags, f"device={dev}"])
            vcf[dev] = out.read_bytes()
        if flags[0] == "realign=t":
            assert vcf["cuda"] == vcf["cpu"]
        else:
            vcfdiff.qual_flips(vcf["cuda"], vcf["cpu"])


def test_realign_recovers_deletion_cuda_equals_cpu(cuda, tmp_path):
    """Reads spanning a 3 bp deletion, written with the tail soft-clipped
    (the case of tests/test_torch_callvariants.py's
    test_realign_recovers_deletion_equal_jax): realign=t realigns them
    on both devices, the same reads, and the VCFs are byte-equal."""
    from bbtools_torch.core.dna import CODE_TO_BASE
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.io.sam import SamWriter
    from bbtools_torch.models import callvariants
    from bbtools_torch.ops import msa
    from bbtools_torch.utils.synth import random_genome

    write_fasta(str(tmp_path / "ref.fa"), random_genome(5_000, 1, seed=77))
    ref = load_reference(str(tmp_path / "ref.fa"))
    codes = ref.scaffold_codes(0)
    rows = []
    for i in range(10):
        start = 1950 - i * 4
        n_pre = 2000 - start
        read = np.concatenate([codes[start:2000], codes[2003 : 2003 + 100 - n_pre]])
        rows.append([b"r%d" % i, b"0", ref.names[0].split()[0], str(start + 1).encode(),
                     b"40", b"%d=%dS" % (n_pre, 100 - n_pre), b"*", b"0", b"0",
                     CODE_TO_BASE[np.minimum(read, 4)].tobytes(), b"F" * 100])
    w = SamWriter(str(tmp_path / "mis.sam"), ref.names, ref.lengths)
    w.add_batch(0, b"".join(b"\t".join(r) + b"\n" for r in rows))
    w.close()
    vcf, tools, devs = {}, {}, []
    realign_batch = msa.realign_batch

    def spy(reads, rlens, refs, wlens, device):
        devs.append(str(device))
        return realign_batch(reads, rlens, refs, wlens, device)

    msa.realign_batch = spy
    try:
        for dev in ("cuda", "cpu"):
            out = tmp_path / f"mis.{dev}.vcf"
            tools[dev] = callvariants.main([
                f"in={tmp_path / 'mis.sam'}", f"ref={tmp_path / 'ref.fa'}", f"vcf={out}",
                "minreads=2", "minscore=0", "realign=t", f"device={dev}"])
            vcf[dev] = out.read_bytes()
    finally:
        msa.realign_batch = realign_batch
    assert devs == ["cuda", "cpu"]
    assert tools["cuda"].realigned == tools["cpu"].realigned >= 8
    assert vcf["cuda"] == vcf["cpu"]
    assert any(v.type == callvariants.DEL and v.start == 2000 and v.reflen() == 3
               for v in tools["cuda"].varmap.values())


def test_cms_cuda_equals_cpu(cuda):
    """The count-min sketch's add (sort, runs, index_add_ over unique
    slots, saturation) and query on the card against the same sketch on
    the CPU and against the host hash: duplicates, a key repeated past
    max_count, several adds; each CUDA add counted."""
    from bbtools_torch.ops import cms

    rng = np.random.default_rng(5)
    sk = {d: cms.CountMinSketch(1 << 14, 3, max_count=50, device=d) for d in ("cuda", "cpu")}
    before = cms.cms_add.device_calls
    for r in range(4):
        keys = rng.integers(0, 1 << 62, 200_000).astype(np.int64)
        keys = np.concatenate([keys, keys[:5000], np.full(70, keys[0])])
        for d in sk:
            sk[d].add(keys)
        assert torch.equal(sk["cuda"].table.cpu(), sk["cpu"].table)
    assert cms.cms_add.device_calls == before + 4
    q = np.concatenate([keys[:1000], rng.integers(0, 1 << 62, 1000)])
    np.testing.assert_array_equal(sk["cuda"].query(q), sk["cpu"].query(q))
    assert sk["cuda"].query(keys[:1])[0] == 50
    np.testing.assert_array_equal(
        cms.cms_slots(torch.as_tensor(q, device=cuda), 3, 1 << 14).cpu().numpy(),
        sk["cpu"]._slots_np(q))


def _error_reads(path, n, seed, glen=3000, L=100):
    """Deep reads of a random genome, every fourth with one substitution,
    and 20 random reads."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, glen)
    with open(path, "w") as fh:
        for i in range(n + 20):
            if i < n:
                p = int(rng.integers(0, glen - L))
                s = genome[p : p + L].copy()
                if i % 4 == 0:
                    s[int(rng.integers(10, L - 10))] ^= 1
            else:
                s = rng.integers(0, 4, L)
            fh.write(f"@r{i}\n{bytes(b'ACGT'[c] for c in s).decode()}\n+\n{'D' * L}\n")
    return path


@pytest.mark.parametrize("flags", [["k=25"], ["ecc=f", "mincount=2", "hcf=0.5"]],
                         ids=["ecc", "mincount"])
def test_bbcms_cuda_equals_cpu(cuda, tmp_path, flags):
    from bbtools_torch.cli import main
    from bbtools_torch.ops import cms

    fin = _error_reads(tmp_path / "in.fq", 1500, 8)
    files = {}
    for dev in ("cuda", "cpu"):
        outs = [tmp_path / f"{dev}.{x}.fq" for x in ("out", "bad")]
        before = cms.cms_add.device_calls
        main(["bbcms", f"in={fin}", f"out={outs[0]}", f"outb={outs[1]}", *flags,
              f"device={dev}"])
        assert cms.cms_add.device_calls - before == (1 if dev == "cuda" else 0)
        files[dev] = [p.read_bytes() for p in outs]
    assert files["cuda"] == files["cpu"]
    assert files["cuda"][0].count(b"\n") >= 4 * 1400


def test_bbmap_bloomfilter_cuda_equals_cpu(cuda, tmp_path):
    """bloomfilter=t: the reference's 31-mers in a sketch on the card, each
    batch prescreened by one query; the foreign reads come out unmapped,
    the SAM equal to the CPU's, and B4 runs for the rest."""
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.models import bbmap
    from bbtools_torch.ops import msa_fill
    from bbtools_torch.utils.synth import random_genome, random_reads, write_reads

    write_fasta(str(tmp_path / "ref.fa"), random_genome(150_000, seed=17))
    reads = random_reads(load_reference(str(tmp_path / "ref.fa")), 600, read_len=151,
                         snp_rate=0.01, seed=5)
    rng = np.random.default_rng(3)
    reads += [(b"junk%d_scaf0_pos0_strand0_insert0" % i,
               bytes(b"ACGT"[c] for c in rng.integers(0, 4, 151)), b"F" * 151)
              for i in range(200)]
    write_reads(str(tmp_path / "r.fq"), reads)
    sams, tools = {}, {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.sam"
        def b4():
            return _b4_launches()

        before = b4()
        tools[dev] = bbmap.main([f"ref={tmp_path / 'ref.fa'}", f"in={tmp_path / 'r.fq'}",
                                 f"out={out}", "bloomfilter=t", f"device={dev}"])
        assert (b4() > before) == (dev == "cuda")
        sams[dev] = out.read_bytes()
    assert sams["cuda"] == sams["cpu"]
    # nearly every foreign read shares no 31-mer with the sketch (a few
    # hit it by chance: 150,000 31-mers in 3 x 2^22 cells); none maps
    assert tools["cuda"].prescreened == tools["cpu"].prescreened >= 190
    assert not [ln for ln in sams["cuda"].splitlines()
                if ln.startswith(b"junk") and not int(ln.split(b"\t")[1]) & 4]
    assert tools["cuda"].reads_mapped >= 590


@pytest.mark.parametrize("flags", [["ecco=t", "mix=t", "strict"],
                                   ["k=75", "extend2=120", "rem=t", "ecct=t"],
                                   ["nn=t"]], ids=["ecco", "extend2_ecct", "nn"])
def test_bbmerge_flags_cuda_equal_cpu(cuda, tmp_path, flags):
    """BBMerge's ecco, tadpipe's merge stage (extension and correction on
    k-mers counted on the card) and the net gate, CUDA against CPU; with
    nn=t only pairs whose score lay within NN_NEAR of the cutoff may
    differ (none expected)."""
    from bbtools_torch.models import bbmerge
    from bbtools_torch.ops import kmer_count, overlap_scan
    from bbtools_torch.utils.fqdiff import differing_names

    fin = _pairs_fastq(tmp_path / "pairs.fq", 3000, 19, lo=100, hi=330)
    files, tools = {}, {}
    for dev in ("cuda", "cpu"):
        outs = [tmp_path / f"{dev}.{x}" for x in ("m.fq", "u1.fq", "u2.fq", "ih.txt")]
        before = (overlap_scan.overlap_counts.launches, kmer_count.sort_reduce.device_calls)
        tools[dev] = bbmerge.main([f"in={fin}", f"out={outs[0]}", f"outu1={outs[1]}",
                                   f"outu2={outs[2]}", f"ihist={outs[3]}", *flags,
                                   f"device={dev}"])
        moved = (overlap_scan.overlap_counts.launches - before[0],
                 kmer_count.sort_reduce.device_calls - before[1])
        if dev == "cuda":
            assert moved[0] > 0 and (moved[1] > 0) == ("ecct=t" in flags)
        else:
            assert moved == (0, 0)
        files[dev] = [p.read_bytes() for p in outs]
    near = set(tools["cpu"].nn_near) | set(tools["cuda"].nn_near)
    for got, want in zip(files["cuda"], files["cpu"]):
        if got != want:
            assert "nn=t" in flags and differing_names(got, want) <= near
    # nn=t merges about half as many pairs as the default gate
    assert tools["cuda"].merged > 300


def test_bbrealign_cuda_equals_cpu(cuda, tmp_path):
    from bbtools_torch.core.dna import CODE_TO_BASE
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.io.sam import SamWriter
    from bbtools_torch.models.bbrealign import main as bbrealign
    from bbtools_torch.utils.synth import random_genome

    write_fasta(str(tmp_path / "ref.fa"), random_genome(5_000, 1, seed=77))
    ref = load_reference(str(tmp_path / "ref.fa"))
    codes = ref.scaffold_codes(0)
    rows = []
    for i in range(40):
        start = 1950 - i
        n_pre = 2000 - start
        read = np.concatenate([codes[start:2000], codes[2003 : 2003 + 100 - n_pre]])
        rows.append([b"r%d" % i, b"0", ref.names[0].split()[0], str(start + 1).encode(),
                     b"40", b"%d=%dS" % (n_pre, 100 - n_pre), b"*", b"0", b"0",
                     CODE_TO_BASE[np.minimum(read, 4)].tobytes(), b"F" * 100])
    w = SamWriter(str(tmp_path / "mis.sam"), ref.names, ref.lengths)
    w.add_batch(0, b"".join(b"\t".join(r) + b"\n" for r in rows))
    w.close()
    res = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.sam"
        counts = bbrealign([f"in={tmp_path / 'mis.sam'}", f"ref={tmp_path / 'ref.fa'}",
                            f"out={out}", f"device={dev}"])
        res[dev] = (counts, out.read_bytes())
    assert res["cuda"] == res["cpu"]
    assert res["cuda"][0][0] >= 30


def test_tadpipe_cuda_equals_cpu(cuda, tmp_path):
    """tadpipe k=31 with every stage on and deletetemp=f on pairs of a
    5 kb genome: the final contigs and every stage file equal; on the
    card the trim stage runs B2 (the sorted join) and B5/B6 (tbo), the
    merge stages B5/B6, and the counts their device routes."""
    import os

    from bbtools_torch.models.tadpipe import tadpipe
    from bbtools_torch.ops import kmer_count, overlap_scan, scan

    rng = np.random.default_rng(4)
    g = bytes(b"ACGT"[c] for c in rng.integers(0, 4, 5000))
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    ad = (b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA", b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT")
    for m in (0, 1):
        with open(tmp_path / f"r{m + 1}.fq", "wb") as fh:
            r2 = np.random.default_rng(5)
            for i in range(600):
                ins = int(r2.integers(100, 320))
                p = int(r2.integers(0, len(g) - ins))
                frag = g[p : p + ins]
                s = (frag if m == 0 else frag.translate(comp)[::-1]) + ad[m] + b"A" * 150
                fh.write(b"@r%d /%d\n%s\n+\n%s\n" % (i, m + 1, s[:150], b"I" * 150))
    stage_files = {}
    for dev in ("cuda", "cpu"):
        before = (scan.cummax_i64.launches, overlap_scan.overlap_counts.launches,
                  kmer_count.sort_reduce.device_calls)
        tadpipe([f"in={tmp_path / 'r1.fq'}", f"in2={tmp_path / 'r2.fq'}",
                 f"out={tmp_path / dev}.fa", f"tmpdir={tmp_path / dev}", "k=31",
                 "deletetemp=f", f"device={dev}"])
        moved = [scan.cummax_i64.launches - before[0],
                 overlap_scan.overlap_counts.launches - before[1],
                 kmer_count.sort_reduce.device_calls - before[2]]
        assert all(moved) if dev == "cuda" else not any(moved), (dev, moved)
        d = tmp_path / dev
        stage_files[dev] = {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}
        stage_files[dev]["out"] = (tmp_path / f"{dev}.fa").read_bytes()
    assert stage_files["cuda"] == stage_files["cpu"]
    assert len(stage_files["cuda"]) == 12 and stage_files["cuda"]["out"].count(b">") >= 1


# ---------------------------------------------------------------------------
# The long-read presets, the side channel and the tools around BBMap
# ---------------------------------------------------------------------------


def test_msa_fill_block_kernel_at_a_long_read_shape(cuda):
    """B4 at a mapPacBio widest-class shape (R = 2,000, Cc = R + 7,640):
    the wrapper's route (the band kernel) and the block kernel, every
    output and every live plane byte equal to the plain fill; one band
    launch."""
    from bbtools_torch.ops.msa_fill import msa_fill, msa_fill_plain, msa_fill_variant

    R = 2000
    rng = np.random.default_rng(R)
    reads, lens, refs = (torch.from_numpy(x).to(cuda)
                         for x in _msa_tasks(rng, 4, R, R + 7640, 1500))
    before = (msa_fill.launches, msa_fill.band_launches, msa_fill.block_launches)
    got = msa_fill(reads, lens, refs)
    want = msa_fill_plain(reads, lens, refs)
    torch.cuda.synchronize()
    _assert_fill_equal(got, want, lens, R + 7640)
    assert (msa_fill.launches, msa_fill.band_launches, msa_fill.block_launches) == (
        before[0], before[1] + 1, before[2])
    assert int((got[1] >= 0).sum()) == 4
    _assert_fill_equal(msa_fill_variant("block", reads, lens, refs), want, lens, R + 7640)


@pytest.fixture(scope="module")
def long_reads(tmp_path_factory):
    """A seeded 300 kb genome; 8 reads of 800-1,200 bp with 1%
    substitutions, 1-3 bp indels and a 50 bp deletion in half of them,
    either strand, as FASTA; one read of 2,600 bp that fastareadlen=1200
    chunks; 12 reads of 150 bp from a segment present twice."""
    from bbtools_torch.core.dna import CODE_TO_BASE
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.utils.synth import random_genome

    tmp = tmp_path_factory.mktemp("longreads")
    (name, seq), = random_genome(300_000, seed=41)
    seq = seq[:200_000] + seq[10_000:13_000] + seq[200_000:]
    write_fasta(str(tmp / "ref.fa"), [(name, seq)])
    codes = load_reference(str(tmp / "ref.fa")).scaffold_codes(0)
    rng = np.random.default_rng(42)
    with open(tmp / "long.fa", "wb") as f:
        for i in range(9):
            n = 2600 if i == 8 else int(rng.integers(800, 1201))
            start = 20_000 + i * 30_000
            read = codes[start : start + n + 60].copy()
            if i % 2:
                read = np.concatenate([read[: n // 2], read[n // 2 + 50 :]])
            for _ in range(3):
                p = int(rng.integers(50, len(read) - 50))
                cut = int(rng.integers(1, 4))
                read = np.concatenate([read[:p], read[p + cut :]])
            read = read[:n]
            m = rng.random(n) < 0.01
            read[m] = (read[m] + rng.integers(1, 4, int(m.sum()))) % 4
            if i % 3 == 1:
                read = (3 - read)[::-1]
            f.write(b">l%d\n%s\n" % (i, CODE_TO_BASE[read].tobytes()))
    with open(tmp / "dup.fa", "wb") as f:
        for i in range(12):
            f.write(b">d%d\n%s\n" % (i, CODE_TO_BASE[codes[10_100 + 200 * i :][:150]].tobytes()))
    return tmp


@pytest.mark.parametrize("tool", ["mappacbio", "bbmapskimmer"])
def test_long_read_presets_cuda_equal_cpu_at_two_budgets(cuda, long_reads, tool,
                                                        monkeypatch):
    """mapPacBio and the skimmer: the CUDA SAM byte-equal to the CPU's,
    at the default plane budget and at a share of the card's memory that
    holds about two widest-class tasks (two class-0 tasks of the
    skimmer's 150 bp reads), which fills (and walks) the classes in
    groups; B4 launched on the card."""
    from bbtools_torch.cli import TOOLS
    from bbtools_torch.ops import msa_fill as mf
    from bbtools_torch.ops.msa_fill import msa_fill

    d = long_reads
    R = 1200 if tool == "mappacbio" else 150
    small = 2 * mf.task_bytes(R, R + (7640 if tool == "mappacbio" else 24)) / (
        torch.cuda.mem_get_info(cuda)[0])
    inp = d / ("long.fa" if tool == "mappacbio" else "dup.fa")
    outs, groups = {}, {}
    for tag, dev, share in (("cuda", "cuda", mf.PLANE_SHARE), ("cuda_small", "cuda", small),
                            ("cpu", "cpu", mf.PLANE_SHARE)):
        monkeypatch.setattr(mf, "PLANE_SHARE", share)
        before = _b4_launches()
        sam = d / f"{tool}.{tag}.sam"
        argv = [f"ref={d / 'ref.fa'}", f"in={inp}", f"out={sam}", "fastareadlen=1200",
                f"device={dev}"]
        groups[tag] = TOOLS[tool](argv).plane_groups
        assert (_b4_launches() > before) == (dev == "cuda")
        outs[tag] = sam.read_bytes()
    assert outs["cuda"] == outs["cpu"] == outs["cuda_small"]
    assert groups["cuda_small"] > groups["cuda"]
    recs = [ln.split(b"\t") for ln in outs["cuda"].splitlines() if not ln.startswith(b"@")]
    if tool == "mappacbio":
        assert sum(b"_chunk" in r[0] for r in recs) == 3
        assert sum(not int(r[1]) & 4 for r in recs) >= 9
    else:
        assert sum(int(r[1]) & 0x100 != 0 for r in recs) >= 10


def test_micro_batches_cuda_equal_cpu(cuda):
    """micro_map_batch and quick_align_batch on the card equal their CPU
    run, array for array, on reads off both ends of phiX."""
    import gzip
    import os

    from bbtools_torch.core.dna import encode
    from bbtools_torch.ops import microalign as tm

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with gzip.open(os.path.join(here, "bbtools_tpu", "resources", "phix2.fa.gz")) as fh:
        ref = encode(b"".join(ln for ln in fh.read().splitlines() if not ln.startswith(b">")))
    rng = np.random.default_rng(3)
    B, L = 4096, 151
    starts = rng.integers(-120, len(ref) - 30, B)
    bases = np.full((B, L), 4, np.uint8)
    lengths = rng.integers(60, L + 1, B).astype(np.int32)
    for i in range(B):
        seg = np.concatenate([rng.integers(0, 4, max(0, -starts[i])),
                              ref[max(0, starts[i]) :]])[: lengths[i]]
        seg = np.concatenate([seg, rng.integers(0, 4, lengths[i] - len(seg))]).astype(np.uint8)
        bases[i, : lengths[i]] = np.where(seg < 4, 3 - seg, 4)[::-1] if i % 2 else seg
    idx = tm.MicroIndex.build(ref, 17, 1, 0.66)
    out = {}
    for dev in ("cuda", "cpu"):
        kt, it, rd = idx.device_tables(dev)
        b, ln = torch.from_numpy(bases).to(dev), torch.from_numpy(lengths).to(dev)
        hit, off, st = tm.micro_map_batch(idx.cfg, kt, it, b, ln)
        qa = tm.quick_align_batch(idx.cfg, rd, b, ln, off, st)
        out[dev] = [x.cpu().numpy() for x in (hit, off, st, *qa.values())]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert out["cuda"][0].mean() > 0.8 and (out["cuda"][7][out["cuda"][0]] > 0).any()


def test_align_coverage_and_bbsplit_cuda_equal_cpu(cuda, tmp_path):
    """BBDuk align=t (the side SAM and the FASTQ), BBMap's four coverage
    outputs and bbsplit's files: byte-equal on the card and the CPU."""
    import gzip
    import os

    from bbtools_torch.cli import main
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.utils.synth import random_genome, random_reads, write_reads

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with gzip.open(os.path.join(here, "bbtools_tpu", "resources", "phix2.fa.gz")) as fh:
        phix = b"".join(ln for ln in fh.read().splitlines() if not ln.startswith(b">"))
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(2000):
        p = int(rng.integers(0, len(phix) - 100))
        seq = phix[p : p + 100] if i % 10 == 0 else acgt[rng.integers(0, 4, 100)].tobytes()
        recs.append((b"r%d" % i, seq, b"F" * 100))
    write_reads(str(tmp_path / "side.fq"), recs)
    write_fasta(str(tmp_path / "a.fa"), random_genome(60_000, n_scaffolds=2, seed=1))
    write_fasta(str(tmp_path / "b.fa"), random_genome(40_000, seed=2))
    write_reads(str(tmp_path / "r.fq"), random_reads(
        load_reference(str(tmp_path / "a.fa")), 1024, read_len=150, snp_rate=0.01, seed=3)
        + random_reads(load_reference(str(tmp_path / "b.fa")), 1024, read_len=150,
                       snp_rate=0.01, seed=4))
    outs = {}
    for dev in ("cuda", "cpu"):
        t = tmp_path / dev
        t.mkdir()
        main(["bbduk", f"in={tmp_path / 'side.fq'}", f"out={t / 'o.fq'}", "align=t",
              f"alignout={t / 'side.sam'}", "k=27", "literal=ACGTACGTACGTACGTACGTACGTACGTAC",
              f"device={dev}"])
        main(["bbmap", f"ref={tmp_path / 'a.fa'}", f"in={tmp_path / 'r.fq'}",
              f"out={t / 'm.sam'}", f"covstats={t / 'cs.txt'}", f"basecov={t / 'bc.txt'}",
              f"covhist={t / 'ch.txt'}", f"bincov={t / 'bn.txt'}", f"device={dev}"])
        main(["bbsplit", f"ref={tmp_path / 'a.fa'},{tmp_path / 'b.fa'}",
              f"in={tmp_path / 'r.fq'}", f"basename={t / 'split_%.fq'}",
              f"outu={t / 'u.fq'}", f"device={dev}"])
        outs[dev] = {p.name: p.read_bytes() for p in sorted(t.iterdir())}
    assert outs["cuda"] == outs["cpu"]
    side = outs["cuda"]["side.sam"].splitlines()
    assert sum(1 for ln in side if not ln.startswith(b"@") and not int(ln.split(b"\t")[1]) & 4) == 200
    assert outs["cuda"]["split_a.fq"].count(b"\n") >= 4 * 1000


def test_banded_edits_cuda_equals_cpu(cuda):
    """The banded edit distance (ROADMAP L6) on the card against the CPU
    at the widest band (max_edits=4, width 9) over 20,000 pairs of 150
    bp with substitutions, indels, N bases and unrelated pairs; one
    counted call."""
    from bbtools_torch.ops import banded

    rng = np.random.default_rng(3)
    P, L = 20_000, 150
    a = rng.integers(0, 4, (P, L)).astype(np.uint8)
    b = a.copy()
    for _ in range(3):
        rows = rng.random(P) < 0.5
        b[rows, rng.integers(0, L, rows.sum())] = rng.integers(0, 5, rows.sum())
    shift = rng.random(P) < 0.3
    b[shift, 1:] = a[shift, :-1]  # a 1 bp insertion
    b[::7] = rng.integers(0, 4, (len(b[::7]), L))
    al = rng.integers(100, L + 1, P).astype(np.int32)
    bl = np.minimum(al + rng.integers(-2, 3, P), L).astype(np.int32)
    args = [torch.from_numpy(x) for x in (a, al, b, bl)]
    before = banded.banded_edits.device_calls
    got = banded.align_pairs(*(x.to(cuda) for x in args), 4)
    assert banded.banded_edits.device_calls == before + 1
    want = banded.align_pairs(*args, 4)
    assert torch.equal(got.cpu(), want)
    assert (want <= 4).float().mean() > 0.3 and (want > 4).any()


def test_pivot_and_loglog_cuda_equal_cpu(cuda):
    """Clumpify's pivot (ROADMAP L7) and LogLog's bucket maxima on one
    full batch (16,384 reads of 151 bp, tandem repeats for ties) on the
    card against the CPU, at 2^14 buckets."""
    from bbtools_torch.models import clumpify, loglog

    rng = np.random.default_rng(4)
    bases = rng.integers(0, 4, (16384, 151)).astype(np.uint8)
    bases[rng.random(bases.shape) < 0.01] = 4
    bases[::5] = np.resize(np.array([2, 0, 3], np.uint8), 151)
    lengths = rng.integers(20, 152, 16384).astype(np.int64)
    before = clumpify._pivot_kmers_t.device_calls
    got = clumpify.pivot_kmers(bases, lengths, 31, cuda)
    assert clumpify._pivot_kmers_t.device_calls == before + 1
    want = clumpify.pivot_kmers(bases, lengths, 31, torch.device("cpu"))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # ties: a period-3 repeat's pivot ends at its first window, 30-32
    assert got[0].dtype == np.uint64 and (got[1][::5] < 33).all()
    ll = {d: loglog.LogLog(buckets=1 << 14, k=31, device=d) for d in ("cuda", "cpu")}
    before = loglog.loglog_update.device_calls
    for d in ll:
        ll[d].add_batch(bases, lengths)
        ll[d].add_batch(bases[::-1].copy(), lengths)
    assert loglog.loglog_update.device_calls == before + 2
    assert torch.equal(ll["cuda"].maxima.cpu(), ll["cpu"].maxima)
    assert ll["cuda"].cardinality() == ll["cpu"].cardinality()


def test_seal_votes_cuda_equal_cpu(cuda):
    """Seal's votes and verdicts over 130 references (three 62-bit words a
    combo) on one full batch, on the card against the CPU."""
    from bbtools_torch.models import seal

    rng = np.random.default_rng(6)
    nref = 130
    combo = rng.integers(0, 1 << 62, (500, 3), dtype=np.int64)
    combo[:, 2] &= (1 << (nref - 124)) - 1
    combo[0] = 0
    ids = rng.integers(0, 500, (16384, 151)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.7] = 0
    before = seal.seal_votes.device_calls
    got = seal.seal_votes(torch.from_numpy(combo).to(cuda), torch.from_numpy(ids).to(cuda), nref)
    assert seal.seal_votes.device_calls == before + 1
    want = seal.seal_votes(torch.from_numpy(combo), torch.from_numpy(ids), nref)
    assert torch.equal(got.cpu(), want)
    for mkh, toss in ((1, False), (30, True)):
        assert torch.equal(seal.seal_best(got, mkh, toss).cpu(), seal.seal_best(want, mkh, toss))


def test_a8a_tools_cuda_equal_cpu(cuda, tmp_path):
    """seal (three references), bbnorm, ecc, loglog, dedupe (s=2 e=2 over
    several batches) and clumpify (dedupe=t) through the CLI on both
    devices: the same files and the same printed estimate, each with its
    device route counted on the card."""
    import contextlib
    import functools
    import io

    from bbtools_torch.cli import main
    from bbtools_torch.io.fasta import write_fasta
    from bbtools_torch.io.fastq import FastqReader
    from bbtools_torch.models import clumpify, dedupe, loglog, seal
    from bbtools_torch.ops import banded, cms
    from bbtools_torch.models import bbnorm

    rng = np.random.default_rng(9)
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    genomes = [ACGT[rng.integers(0, 4, 4000)].tobytes() for _ in range(3)]
    for i, g in enumerate(genomes):
        write_fasta(str(tmp_path / f"g{i}.fa"), [(b"g%d" % i, g)])
    with open(tmp_path / "in.fq", "wb") as fh:
        for i in range(6000):
            g = genomes[i % 3]
            p = int(rng.integers(0, len(g) - 120))
            s = bytearray(g[p:p + 120])
            if i % 4 == 0:
                s[int(rng.integers(0, 120))] = ord("ACGT"[int(rng.integers(0, 4))])
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, bytes(s), b"D" * 120))
    refs = ",".join(str(tmp_path / f"g{i}.fa") for i in range(3))
    cases = {
        "seal": (["seal", f"ref={refs}", "stats={o}.st"], seal.seal_votes, ["st"]),
        "bbnorm": (["bbnorm", "out={o}.fq", "outt={o}.t.fq", "target=20", "mindepth=2"],
                   bbnorm.read_depths, ["fq", "t.fq"]),
        "ecc": (["ecc", "out={o}.fq", "k=25"], cms.cms_add, ["fq"]),
        "loglog": (["loglog"], loglog.loglog_update, []),
        "dedupe": (["dedupe", "out={o}.fq", "outd={o}.d.fq", "s=2", "e=2"],
                   banded.banded_edits, ["fq", "d.fq"]),
        "clumpify": (["clumpify", "out={o}.fq", "dedupe=t"], clumpify._pivot_kmers_t, ["fq"]),
    }
    old = dedupe.FastqReader
    dedupe.FastqReader = functools.partial(FastqReader, batch_reads=1024)
    try:
        for name, (argv, counted, exts) in cases.items():
            out = {}
            for dev in ("cuda", "cpu"):
                o = str(tmp_path / f"{name}.{dev}")
                before = counted.device_calls
                text = io.StringIO()
                with contextlib.redirect_stdout(text), contextlib.redirect_stderr(io.StringIO()):
                    main([argv[0], f"in={tmp_path / 'in.fq'}",
                          *(a.format(o=o) for a in argv[1:]), f"device={dev}"])
                assert (counted.device_calls > before) == (dev == "cuda"), name
                out[dev] = [open(f"{o}.{e}", "rb").read() for e in exts] + [text.getvalue()]
            assert out["cuda"] == out["cpu"], name
    finally:
        dedupe.FastqReader = old


def test_glocal_identity_cuda_equals_cpu(cuda):
    """The glocal identity aligner (ROADMAP L5) on the card against the
    CPU at icecream's shape (352-row tip queries against remainders of
    up to 10,000 columns, ragged) and on rows built to tie (homopolymers,
    tandem repeats, a two-letter alphabet); glocal_counts too; one
    counted call each."""
    from bbtools_torch.ops import idalign

    rng = np.random.default_rng(12)
    T, M, N = 64, 352, 10_000
    qs = rng.integers(0, 4, (T, M)).astype(np.uint8)
    rs = rng.integers(0, 4, (T, N)).astype(np.uint8)
    ql = rng.integers(100, M + 1, T).astype(np.int32)
    rl = rng.integers(1_500, N + 1, T).astype(np.int32)
    for t in range(0, T, 2):  # a reverse-complement copy somewhere in the remainder
        p = int(rng.integers(0, rl[t] - ql[t]))
        qs[t, : ql[t]] = rs[t, p : p + ql[t]]
        qs[t, rng.integers(0, ql[t], 20)] = rng.integers(0, 4, 20)
    qs[1], rs[1] = 0, 0  # homopolymers
    qs[3, :], rs[3, :] = np.resize([0, 1], M), np.resize([0, 1], N)  # a tandem repeat
    qs[5], rs[5] = rng.integers(0, 2, M), rng.integers(0, 2, N)
    ql[7], rl[9] = 0, 0
    args = (qs, ql, rs, rl)
    before = idalign.glocal_identity.device_calls
    got = idalign.glocal_identity(*args, cuda)
    assert idalign.glocal_identity.device_calls == before + 1
    want = idalign.glocal_identity(*args, "cpu")
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
    got = idalign.glocal_counts(*args, cuda)
    assert idalign.glocal_identity.device_calls == before + 2
    for g, w in zip(got, idalign.glocal_counts(*args, "cpu")):
        assert torch.equal(g.cpu(), w)
    assert float(want[0][0]) > 0.9 and float(want[0][1]) == 1.0


def test_banded_identity_and_trim_cuda_equal_cpu(cuda):
    """BandedIDAligner.align_batch (width 81) on arrays of two widths,
    and reformat's quality trim, on the card against the CPU."""
    from bbtools_torch.ops import banded, idalign, trim

    rng = np.random.default_rng(13)
    q = rng.integers(0, 4, (40, 3000)).astype(np.uint8)
    r = np.pad(q, ((0, 0), (0, 12)))
    r[:, rng.integers(0, 3000, 300)] = rng.integers(0, 4, 300)
    r[::4, 7:3007] = q[::4, :3000]
    ql = np.full(40, 3000, np.int32)
    rl = (ql + np.where(np.arange(40) % 4 == 0, 7, 0)).astype(np.int32)
    before = banded.banded_edits.device_calls
    aligner = idalign.BandedIDAligner(max_edits=750)
    got = aligner.align_batch(q, ql, r, rl, cuda)
    assert banded.banded_edits.device_calls == before + 1
    np.testing.assert_array_equal(got, aligner.align_batch(q, ql, r, rl, "cpu"))
    quals = torch.from_numpy(rng.integers(0, 41, (4096, 151)).astype(np.uint8))
    lengths = torch.from_numpy(rng.integers(0, 152, 4096).astype(np.int32))
    is_n = torch.from_numpy(rng.random((4096, 151)) < 0.01)
    before = trim.optimal_trim.device_calls
    got = trim.optimal_trim(quals.to(cuda), lengths.to(cuda), is_n.to(cuda), 0.1)
    assert trim.optimal_trim.device_calls == before + 1
    for g, w in zip(got, trim.optimal_trim(quals, lengths, is_n, 0.1)):
        assert torch.equal(g.cpu(), w)


def test_a8a_l5_tools_cuda_equal_cpu(cuda, tmp_path):
    """reformat (qtrim), alltoall, splitribo, mergeribo, icecream (kzt),
    the two device aligner ladders (the length ladder's 3,000 bp on the
    banded route) and microalign through the CLI on both devices: the
    same files and printed lines, each with its device route counted on
    the card."""
    import contextlib
    import io
    import re

    from bbtools_torch.cli import main
    from bbtools_torch.ops import banded, idalign, microalign, trim

    rng = np.random.default_rng(14)
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    with open(tmp_path / "q.fq", "wb") as fh:
        for i in range(3000):
            q = rng.integers(2, 41, 150)
            q[-int(rng.integers(1, 60)):] = 2 if i % 3 == 0 else 30
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, ACGT[rng.integers(0, 4, 150)].tobytes(),
                                             (q + 33).astype(np.uint8).tobytes()))
    base = ACGT[rng.integers(0, 4, 1500)]
    with open(tmp_path / "s.fa", "wb") as fh:
        for i in range(24):
            s = base.copy()
            s[rng.integers(0, 1500, 20 * i)] = ACGT[rng.integers(0, 4, 20 * i)]
            fh.write(b">s%d\n%s\n" % (i, s.tobytes()))
    with open(tmp_path / "pb.fq", "wb") as fh:
        for z in range(20):
            c = rng.integers(0, 4, int(rng.integers(2000, 4000)))
            if z % 4 == 0:
                c[len(c) // 2:] = (3 - c[: len(c) - len(c) // 2])[::-1]
            s = ACGT[c].tobytes()
            fh.write(b"@m1/%d/0_%d\n%s\n+\n%s\n" % (z, len(s), s, b"F" * len(s)))
    cases = {
        "reformat": (["reformat", "in={t}/q.fq", "out={o}.fq", "qtrim=rl", "trimq=10",
                      "minlen=40"], trim.optimal_trim, [".fq"]),
        "alltoall": (["alltoall", "in={t}/s.fa", "out={o}.txt"], idalign.glocal_identity,
                     [".txt"]),
        "splitribo": (["splitribo", "in={t}/s.fa", "out={o}_#.fa"], idalign.glocal_identity,
                      ["_junk.fa"]),
        "mergeribo": (["mergeribo", "in={t}/s.fa", "out={o}.fa"], idalign.glocal_identity,
                      [".fa"]),
        "icecream": (["icecream", "in={t}/pb.fq", "outg={o}.fq", "outb={o}.b.fq", "kzt=t"],
                     idalign.glocal_identity, [".fq", ".b.fq"]),
        "testalignersbatch": (["testalignersbatch", "length=2000", "samples=4",
                               "ani=1,0.95,0.85,0.75"], idalign.glocal_identity, []),
        "testalignerslength": (["testalignerslength", "samples=4"], banded.banded_edits, []),
        "microalign": (["microalign", "in={t}/q.fq", "ref=phix", "out={o}.sam"],
                       microalign.micro_map_batch, [".sam"]),
    }
    for name, (argv, counted, exts) in cases.items():
        out = {}
        for dev in ("cuda", "cpu"):
            o = str(tmp_path / f"{name}.{dev}")
            before = getattr(counted, "device_calls", None)
            text, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(text), contextlib.redirect_stderr(err):
                main([argv[0], *(a.format(t=tmp_path, o=o) for a in argv[1:]),
                      f"device={dev}"])
            if before is not None:
                assert (counted.device_calls > before) == (dev == "cuda"), name
            out[dev] = ([open(o + e, "rb").read() for e in exts]
                        + [text.getvalue(), re.sub(r"[0-9.]+ seconds", "", err.getvalue())])
        assert out["cuda"] == out["cpu"], name


def test_best_sites_and_indelfree_search_cuda_equal_cpu(cuda):
    """findprimers' best_sites and indelfree's search (at two tile
    budgets) give the CPU's numbers on the card, each counted."""
    from bbtools_torch.models import indelfree
    from bbtools_torch.models.findprimers import best_sites

    rng = np.random.default_rng(13)
    bases = rng.integers(0, 5, (4096, 300)).astype(np.uint8)
    lengths = rng.integers(150, 301, 4096).astype(np.int32)
    prim = rng.integers(0, 5, (4, 20)).astype(np.uint8)
    plens = np.array([19, 20, 19, 20], np.int32)
    bases[::7, 40:59] = prim[0, :19]
    before = best_sites.device_calls
    got = best_sites(bases, lengths, prim, plens, "cuda")
    want = best_sites(bases, lengths, prim, plens, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert best_sites.device_calls == before + 1
    q = rng.integers(0, 4, (64, 55)).astype(np.uint8)
    ql = rng.integers(22, 56, 64).astype(np.int32)
    for i in range(64):
        q[i, ql[i]:] = 4
    chunk = rng.integers(0, 5, indelfree.CHUNK + 55).astype(np.uint8)
    chunk[1000:1055] = q[3]
    want = indelfree._device_search(q, ql, chunk, "cpu").numpy()
    for budget in (1 << 26, None):
        before = indelfree._device_search.device_calls
        got = indelfree._device_search(q, ql, chunk, "cuda", budget).cpu().numpy()
        np.testing.assert_array_equal(got, want)
        assert indelfree._device_search.device_calls == before + 1
    assert want[3, 1000] == 0


def test_cellnet_fit_cuda_within_tolerance_of_cpu(cuda):
    """A few epochs of Adam on the card end within the CPU tests' bound
    (tests/test_torch_mltools.py FIT_WEIGHT_TOL) of the CPU's."""
    from bbtools_torch.ml.cellnet import CellNet

    rng = np.random.default_rng(2)
    x = rng.random((2000, 40)).astype(np.float32)
    y = (x[:, :3].sum(1, keepdims=True) > 1.5).astype(np.float32)
    nets = {}
    for dev in ("cpu", "cuda"):
        nets[dev] = CellNet.create([40, 20, 1], seed=3)
        nets[dev].device = dev
        before = CellNet.fit.device_calls
        nets[dev].loss = nets[dev].fit(x, y, epochs=20, lr=0.05)
        assert CellNet.fit.device_calls == before + (dev == "cuda")
    for a, b in zip(nets["cpu"].weights + nets["cpu"].biases,
                    nets["cuda"].weights + nets["cuda"].biases):
        assert float(np.abs(a - b).max()) <= 5e-5
    assert abs(nets["cpu"].loss - nets["cuda"].loss) <= 1e-6


# ---------------------------------------------------------------------------
# A7: the sharded paths on a virtual mesh of the card (cuda:0 repeated)
# ---------------------------------------------------------------------------


def _virtual(cuda, n_dp, n_tp):
    from bbtools_torch.parallel.mesh import make_mesh

    return make_mesh(n_dp, n_tp, devices=[cuda] * (n_dp * n_tp))


def test_mm_best_equals_plain_at_a_column_slab(cuda):
    """mm_best (the B3 kernel's undecoded epilogue) against its plain twin
    on half the columns of a matcher of ~18,000 (the matcher's slab at
    tp=2) and on all of them; the min of the two halves' words, decoded,
    is mm_lookup's answer."""
    from bbtools_torch.ops import mm_match

    rng = np.random.default_rng(14)
    scafs = [rng.integers(0, 4, 460).astype(np.uint8) for _ in range(20)]
    idx = mm_match.MMKmerIndex.build(scafs, 23, mink=11, hdist=2)
    assert idx is not None and idx.Dp >= 16_384
    q = torch.from_numpy(_mm_queries(rng, scafs, 23, 11, 60_000)).to(cuda)
    km, pr = idx.device_arrays(cuda)
    k, mink, Kp, Dp = idx.static_params()
    half = Dp // 2
    slabs = [(km[:half].contiguous(), pr[:, :half].contiguous()),
             (km[half:].contiguous(), pr[:, half:].contiguous())]
    words = []
    for kw, p in [*slabs, (km, pr)]:
        before = mm_match.mm_best.launches
        got = mm_match.mm_best(kw, p, k, mink, Kp, kw.shape[0], q)
        torch.cuda.synchronize()
        assert mm_match.mm_best.launches == before + 1
        assert torch.equal(got, mm_match.mm_best_plain(kw, p, k, mink, Kp, kw.shape[0], q))
        words.append(got)
    assert bool((words[2] != int(mm_match.BIG32)).any())
    lookup = mm_match.mm_lookup(km, pr, k, mink, Kp, Dp, q)
    assert torch.equal(mm_match.mm_decode_best(torch.minimum(words[0], words[1])), lookup)
    assert torch.equal(mm_match.mm_decode_best(words[2]), lookup)


def test_sharded_steps_on_a_virtual_mesh_equal_one_device(cuda):
    """Each sharded step on [cuda:0] * 4 equals the single-device call on
    the card, through the kernels per slab (B3's mm_best, B4, B5)."""
    from bbtools_torch.ops import kmer_count as kc
    from bbtools_torch.ops import mm_match, msa_fill, overlap_scan
    from bbtools_torch.ops.bbduk_scan import KScanConfig, kscan_combined
    from bbtools_torch.ops.kmer_index import BucketKmerIndex, build_ref_keys
    from bbtools_torch.ops.score_ungapped import score_no_indels
    from bbtools_torch.parallel import sharded_count as sc
    from bbtools_torch.parallel import sharded_index as si
    from bbtools_torch.parallel.sharded_spectrum import ShardedSpectrum

    rng = np.random.default_rng(15)
    # the BBDuk scan: (2, 2) against the unsharded bucket table
    scafs = [rng.integers(0, 4, 60).astype(np.uint8) for _ in range(30)]
    keys, ids = build_ref_keys(scafs, 23, mink=11, hdist=1)
    B, L = 1024, 151
    bases = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for r in range(0, B, 3):
        s = scafs[r % len(scafs)]
        p = int(rng.integers(0, L - 60))
        bases[r, p : p + 60] = s
    lengths = rng.integers(60, L + 1, B).astype(np.int32)
    b_t, l_t = torch.from_numpy(bases).to(cuda), torch.from_numpy(lengths).to(cuda)
    sidx = si.ShardedKmerIndex.build(keys, ids, 2)
    mesh = _virtual(cuda, 2, 2)
    cfg = KScanConfig(k=23, mink=11)
    got = si.make_sharded_kscan(mesh, cfg, sidx, True, True)(sidx.place(mesh), b_t, l_t)
    one = BucketKmerIndex.build(keys, ids)
    want = kscan_combined(KScanConfig(k=23, mink=11, nb=one.nb), one.device_arrays(cuda),
                          b_t, l_t, True, True)
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    for g, w in zip((*got[1], *got[2]), (*want[1], *want[2])):
        assert torch.equal(g, w)
    assert int(got[0]["nhits"].max()) > 0
    # counting, ungapped scoring and the insert scan over dp=4
    mesh4 = _virtual(cuda, 4, 1)
    v, c, n, h = sc.sharded_count_step(mesh4, 31)(b_t, l_t)
    cpu = sc.sharded_count_step(_cpu_mesh(4), 31)(torch.from_numpy(bases),
                                                  torch.from_numpy(lengths))
    for g, w in zip((v, c, n, h), cpu):
        assert torch.equal(g.cpu(), w)
    T, W = 512, 200
    refs = rng.integers(0, 4, (T, W)).astype(np.uint8)
    starts = rng.integers(0, 40, T).astype(np.int32)
    for t in range(T):
        refs[t, starts[t] : starts[t] + L] = bases[t]
    args = [torch.from_numpy(x).to(cuda) for x in (bases[:T], lengths[:T], refs, starts)]
    assert torch.equal(sc.sharded_ungapped_score_step(mesh4, L, W)(*args),
                       score_no_indels(L, *args, torch.full((T,), W, dtype=torch.int32,
                                                            device=cuda)))
    b_rc = torch.flip(b_t, [1]).contiguous()
    before = overlap_scan.overlap_counts.launches
    got = sc.sharded_overlap_step(mesh4, 12, 2 * L - 11)(b_t, b_rc, l_t, l_t)
    assert overlap_scan.overlap_counts.launches == before + 4
    for g, w in zip(got, overlap_scan.overlap_counts(b_t, b_rc, l_t, l_t, 12, 2 * L - 11)):
        assert torch.equal(g, w)
    # the fill and walk over dp=4
    tasks = _msa_tasks(rng, 400, 151, 151 + 24, 100)
    fn = sc.make_sharded_fill_walk(mesh4, 151, 151 + 24)
    before = _b4_launches()
    got = fn(*tasks)
    assert _b4_launches() >= before + 4
    (want, _groups) = msa_fill.fill_walk(*tasks, cuda)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 3:  # walk ops: one width across slabs, zero past each row's steps
            w = torch.nn.functional.pad(w, (0, g.shape[1] - w.shape[1]))
        assert torch.equal(g, w)
    # the matcher over (2, 2)
    mscafs = [rng.integers(0, 4, 200).astype(np.uint8) for _ in range(20)]
    idx = mm_match.MMKmerIndex.build(mscafs, 23, mink=11, hdist=2)
    q = torch.from_numpy(_mm_queries(rng, mscafs, 23, 11, 20_000)).to(cuda)
    km, pr = idx.device_arrays(cuda)
    before = mm_match.mm_best.launches
    got = sc.sharded_mm_lookup_step(mesh, idx.k, idx.mink, idx.Kp)(km, pr, q)
    assert mm_match.mm_best.launches == before + 4
    assert torch.equal(got, mm_match.mm_lookup(km, pr, *idx.static_params(), q))
    # the spectrum over dp=4 against DeviceSpectrum
    ss, ds = ShardedSpectrum(mesh4, 31), kc.DeviceSpectrum(31, device=cuda)
    for bases_b, lengths_b in _kmer_batches(16, 5):
        ss.add_batch(bases_b, lengths_b)
        ds.add_batch(bases_b, lengths_b)
    for g, w in zip(ss.spectrum(), ds.spectrum()):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ss.histogram(200), ds.histogram(200))


def _cpu_mesh(n_dp):
    from bbtools_torch.parallel.mesh import make_mesh

    return make_mesh(n_dp, 1, devices=[torch.device("cpu")] * n_dp)


def test_bbmap_on_a_virtual_mesh_equals_cpu(cuda, tmp_path):
    """BBMap with its tasks over [cuda:0] * 4 (the mesh tpshards=4 takes
    on four cards) writes the SAM of `tpshards=4 device=cpu` and of one
    card."""
    from bbtools_torch.cli import main
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.models import bbmap
    from bbtools_torch.utils.synth import random_genome, random_reads, write_reads

    write_fasta(str(tmp_path / "ref.fa"), random_genome(150_000, n_scaffolds=2, seed=8))
    ref = load_reference(str(tmp_path / "ref.fa"))
    write_reads(str(tmp_path / "r.fq"), random_reads(
        ref, 512, read_len=151, snp_rate=0.01, indel_rate=0.1,
        indel_range=(1, 10), seed=5))
    base = [f"ref={tmp_path / 'ref.fa'}", f"in={tmp_path / 'r.fq'}"]
    main(["bbmap", *base, f"out={tmp_path / 'cpu.sam'}", "tpshards=4", "device=cpu"])
    main(["bbmap", *base, f"out={tmp_path / 'one.sam'}", "device=cuda"])
    tool = bbmap.BBMap(bbmap.parse_args([*base, f"out={tmp_path / 'mesh.sam'}",
                                         "device=cuda"]))
    tool.enable_mesh(mesh=_virtual(cuda, 4, 1))
    tool.run()

    def body(name):
        return [ln for ln in (tmp_path / name).read_bytes().splitlines()
                if not ln.startswith(b"@PG")]

    assert body("mesh.sam") == body("cpu.sam") == body("one.sam")
    assert len(body("mesh.sam")) > 512


def test_seed_candidates_on_the_card_equal_the_cpu_and_the_host(cuda, tmp_path):
    """ops/seed_cluster.seed_candidates on the card: its nine outputs equal
    the same function's on the CPU, and the host candidates_for_batch."""
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.models.bbmap import BBMap, BBMapConfig
    from bbtools_torch.models.bbmap_index import SeedIndex
    from bbtools_torch.ops.seed_cluster import seed_candidates
    from bbtools_torch.utils.synth import random_genome, random_reads, write_reads

    write_fasta(str(tmp_path / "ref.fa"), random_genome(300_000, n_scaffolds=2, seed=14))
    ref = load_reference(str(tmp_path / "ref.fa"))
    write_reads(str(tmp_path / "r.fq"), random_reads(
        ref, 256, read_len=151, snp_rate=0.01, indel_rate=0.1, indel_range=(1, 10), seed=6))
    tool = BBMap(BBMapConfig(device="cuda"), index=SeedIndex.build(ref, k=13))
    batch = list(tool._read_batches(str(tmp_path / "r.fq")))[0]
    lengths = batch.lengths.astype(np.int64)
    keys, vmask, offs, K = tool._seed_slots(batch.bases, lengths)
    B, cfg = batch.bases.shape[0], tool.cfg
    static = (B, K, 1 << max(14, (4 * B * K).bit_length()), 2 * B * cfg.max_sites,
              cfg.max_sites, int(min(cfg.max_indel, cfg.window_extras[-1] - 2 * cfg.pad)))
    arrays = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        keys[0].astype(np.int32), keys[1].astype(np.int32), vmask[0], vmask[1], offs,
        tool.index.starts.astype(np.int32), tool.index.sites.astype(np.int32))]
    got = seed_candidates(*(a.to(cuda) for a in arrays), *static)
    want = seed_candidates(*arrays, *static)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
    host = tool.candidates_for_batch(batch.bases, lengths)
    n = int(got[6])
    assert bool(got[7]) and n == len(host[0])
    for h, g in zip(host[:6], got[:6]):
        np.testing.assert_array_equal(h.astype(np.int64), g[:n].cpu().numpy().astype(np.int64))


@pytest.mark.parametrize("structure", ["sorted", "hash"])
def test_kmer_index_lookups_on_the_card_equal_lookup_np(cuda, structure):
    """SortedKmerIndex and HashKmerIndex on the card: ids equal to
    lookup_np, low lanes of 2^31 and more included."""
    from bbtools_torch.ops import kmer_index

    rng = np.random.default_rng(4)
    keys = np.unique(rng.integers(0, 1 << 62, 50_000, dtype=np.int64))
    ids = rng.integers(1, 60_000, len(keys)).astype(np.int32)
    q = np.concatenate([keys[::3], rng.integers(0, 1 << 62, 100_000, dtype=np.int64)])
    if structure == "sorted":
        idx = kmer_index.SortedKmerIndex(keys, ids)
        got = kmer_index.SortedKmerIndex.lookup(*idx.device_arrays(cuda),
                                                torch.from_numpy(q).to(cuda))
    else:
        idx = kmer_index.HashKmerIndex.build(keys, ids)
        got = kmer_index.HashKmerIndex.lookup(*idx.device_arrays(cuda), idx.cap, idx.max_probe,
                                              torch.from_numpy(q).to(cuda))
    want = idx.lookup_np(q)
    assert (want > 0).sum() == len(keys[::3])
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_pruned_fill_with_planes_on_the_card_equals_the_cpu(cuda):
    """msa_fill_batch(prune=True, traceback=True) on the card: scores,
    columns, states, walk ops and steps of the CPU run."""
    from bbtools_torch.ops import msa
    from bbtools_torch.ops import msa_constants as C

    rng = np.random.default_rng(9)
    S, R, Cc = 96, 60, 120
    refs = rng.integers(0, 4, (S, Cc)).astype(np.uint8)
    lens = rng.integers(30, R + 1, S).astype(np.int32)
    reads = np.full((S, R), 4, np.uint8)
    for i in range(S):
        src = refs[i, 20 : 20 + lens[i]].copy()
        m = rng.random(lens[i]) < 0.05 * (i % 4)
        src[m] = (src[m] + 1) % 4
        reads[i, : lens[i]] = src
    cols = np.full(S, Cc, np.int32)
    mins = (0.7 * (C.POINTS_MATCH + (lens.astype(np.int64) - 1) * C.POINTS_MATCH2)).astype(np.int64)
    args = (reads, lens, refs, cols, mins)
    got = msa.msa_fill_batch(*args, prune=True, device=cuda, traceback=True)
    want = msa.msa_fill_batch(*args, prune=True, device="cpu", traceback=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[4] > 0).any() and (got[0] < mins - C.MIN_SCORE_ADJUST).any()


def test_bbduk_profile_traces_the_kernels(cuda, tmp_path, monkeypatch):
    """bbduk profile= on the card: the trace's B1 kernel events equal
    lane_lookup's launches, and the files equal a run without it."""
    from bbtools_torch.cli import main
    from bbtools_torch.utils.timer import device_events, trace_path

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(2)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    adapter = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    with open("in.fq", "wb") as fh:
        for i in range(3000):
            s = acgt[rng.integers(0, 4, 100)].copy()
            if i % 3 == 0:
                s[67:] = np.frombuffer(adapter, np.uint8)
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"I" * 100))
    flags = [f"literal={adapter.decode()}", "k=23", "mink=11", "hdist=1", "ktrim=r",
             "minlen=40", "device=cuda"]
    main(["bbduk", "in=in.fq", "out=plain.fq", *flags])
    lane_index.lane_lookup.launches = 0
    main(["bbduk", "in=in.fq", "out=prof.fq", "profile=prof", *flags])
    events = [e for e in device_events(trace_path("prof")) if e["cat"] == "kernel"]
    traced = sum("lane_lookup_" in e["name"] for e in events)
    assert traced == lane_index.lane_lookup.launches > 0
    assert open("plain.fq", "rb").read() == open("prof.fq", "rb").read()
