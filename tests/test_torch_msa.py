"""The port's MultiStateAligner11ts pieces against the JAX package's, on
the CPU: the unpruned fill with traceback planes (ops/msa_fill.py, the
plain version of the B4 kernel) against the TPU kernel in interpret mode
and the XLA wavefront, the traceback walk, and the fused map step. All
integer arithmetic: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbtools_torch.ops import msa as tmsa
from bbtools_torch.ops import map_fused
from bbtools_torch.ops.msa_fill import live_cells, msa_fill, msa_fill_plain
from bbtools_tpu.ops import msa as jmsa
from bbtools_tpu.ops import msa_constants as C
from bbtools_tpu.ops.msa_pallas import msa_fill_pallas, prepare_refp


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU runs: the suite runs several
    test processes on shared cores, where torch's thread pool, woken at
    each of the plain fill's many small ops, stalls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tasks(seed, B, R, Cc):
    """Near-match tasks with mixed lengths (some under R, one of length
    R, one far shorter), N in reads and windows, code 4 past the end."""
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 4, (B, Cc)).astype(np.uint8)
    refs[rng.random((B, Cc)) < 0.02] = 4
    lens = rng.integers(R // 2, R + 1, B).astype(np.int32)
    lens[0], lens[-1] = R, 3
    reads = np.full((B, R), 4, np.uint8)
    for b in range(B):
        n = int(lens[b])
        start = int(rng.integers(0, Cc - n - 4))
        src = refs[b, start : start + n + 4].copy()
        if n > 12 and b % 3:
            p, k = int(rng.integers(4, n - 8)), int(rng.integers(1, 5))
            if b % 3 == 1:  # a deletion of k reference bases
                src = np.concatenate([src[:p], src[p + k :]])
            else:  # an insertion of k bases
                src = np.concatenate([src[:p], rng.integers(0, 4, k).astype(np.uint8),
                                      src[p:]])
        src = src[:n]
        m = rng.random(n) < 0.06
        src[m] = (src[m] + rng.integers(1, 4, int(m.sum()))) % 4
        src[rng.random(n) < 0.02] = 4
        reads[b, :n] = src
    return reads, lens, refs


def _xla_fill(reads, lens, refs):
    B, R = reads.shape
    Cc = refs.shape[1]
    clens = np.full(B, Cc, np.int32)
    maxgain = (lens.astype(np.int64) - 1) * C.POINTS_MATCH2 + C.POINTS_MATCH
    vert, horiz, floor, _ = jmsa.prepare_limits_np(reads, lens, refs, clens,
                                                   np.zeros(B, np.int64))
    return jmsa.msa_fill(
        R, Cc, False, True, jnp.asarray(reads), jnp.asarray(lens),
        jnp.asarray(refs), jnp.asarray(clens),
        jnp.asarray(vert.astype(np.int32)), jnp.asarray(horiz.astype(np.int32)),
        jnp.asarray(floor.astype(np.int32)), jnp.asarray((-2 * maxgain).astype(np.int32)),
    )


R = 40


@pytest.mark.parametrize("Cc", [R + 24, R + 152])
def test_fill_plain_equals_pallas_kernel_and_xla(Cc):
    reads, lens, refs = _tasks(Cc, 16, R, Cc)
    got = [x.numpy() for x in msa_fill_plain(
        torch.from_numpy(reads), torch.from_numpy(lens), torch.from_numpy(refs))]
    pal = msa_fill_pallas(R, Cc, jnp.asarray(reads), jnp.asarray(lens),
                          jnp.asarray(prepare_refp(refs, R)), tile=8,
                          interpret=True, traceback=True)
    xla = _xla_fill(reads, lens, refs)
    assert got[3].shape == (R + Cc - 1, 16, R + 1) and got[3].dtype == np.uint8
    for want in (pal, xla):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    # the set exercises every state and both kinds of indel
    assert set(got[2].tolist()) >= {0} and (got[1] >= 0).all()
    assert len(np.unique(got[3])) > 4


def test_fill_wrapper_runs_plain_on_cpu():
    reads, lens, refs = _tasks(5, 6, 12, 20)
    t = [torch.from_numpy(x) for x in (reads, lens, refs)]
    before = msa_fill.launches
    for g, w in zip(msa_fill(*t), msa_fill_plain(*t)):
        assert torch.equal(g, w)
    assert msa_fill.launches == before


def _poisoned_fill(reads, lens, refs):
    """msa_fill_plain with every dead plane byte (r > len, c outside
    0..Cc) set to 0xFF: what a reader of live cells only cannot see."""
    *outs, planes = msa_fill_plain(reads, lens, refs)
    dead = ~live_cells(lens, planes.shape[2] - 1, refs.shape[1])
    return (*outs, planes.masked_fill(dead, 0xFF))


def test_fill_trims_rows_to_the_longest_read_and_equals_jax_on_live_cells():
    """Reads of at most R - 9 bases in rows of R: the planes keep R' =
    the longest length (R' + 1 rows, R' + Cc - 1 diagonals), and equal
    the JAX fill's (XLA wavefront and Pallas kernel, untrimmed) on every
    live cell; scores, columns and states equal."""
    Cc = R + 24
    reads, lens, refs = _tasks(31, 16, R, Cc)
    lens = np.minimum(lens, R - 9).astype(np.int32)
    lens[3] = 0
    reads[np.arange(R)[None, :] >= lens[:, None]] = 4
    Rp = int(lens.max())
    assert Rp < R
    t = [torch.from_numpy(x) for x in (reads, lens, refs)]
    *got, planes = msa_fill_plain(*t)
    assert planes.shape == (Rp + Cc - 1, 16, Rp + 1)
    live = live_cells(t[1], Rp, Cc).numpy()
    # all cells of rows 0..len, columns 0..Cc, but those of diagonals 0
    # and 1, which are not stored: (0, 0), (0, 1) and, for len >= 1, (1, 0)
    assert live.sum() == ((lens + 1) * (Cc + 1) - 2 - (lens >= 1)).sum()
    pal = msa_fill_pallas(R, Cc, jnp.asarray(reads), jnp.asarray(lens),
                          jnp.asarray(prepare_refp(refs, R)), tile=8,
                          interpret=True, traceback=True)
    for want in (pal, _xla_fill(reads, lens, refs)):
        for g, w in zip(got, want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        wp = np.asarray(want[3])[: Rp + Cc - 1, :, : Rp + 1]
        np.testing.assert_array_equal(planes.numpy()[live], wp[live])


@pytest.mark.parametrize("Cc", [R + 24, R + 152])
def test_walk_on_live_cells_only_equals_jax(Cc):
    """The walk over the trimmed plain fill with every dead plane byte
    set to 0xFF gives the JAX walk's ops (zero past R' + Cc steps) and
    step counts over the JAX fill."""
    reads, lens, refs = _tasks(Cc + 7, 16, R, Cc)
    lens = np.minimum(lens, R - 5).astype(np.int32)
    reads[np.arange(R)[None, :] >= lens[:, None]] = 4
    _s, c, st, jplanes = _xla_fill(reads, lens, refs)
    jo, jn = jmsa.msa_walk(R, Cc, jplanes, jnp.asarray(lens), c, st)
    *outs, planes = _poisoned_fill(*(torch.from_numpy(x) for x in (reads, lens, refs)))
    Rp = planes.shape[2] - 1
    assert Rp == R - 5
    np.testing.assert_array_equal(outs[1].numpy(), np.asarray(c))
    to, tn = tmsa.msa_walk(Rp, Cc, planes, torch.from_numpy(lens), outs[1], outs[2])
    jo = np.asarray(jo)
    np.testing.assert_array_equal(to.numpy(), jo[:, : Rp + Cc])
    assert not jo[:, Rp + Cc :].any()
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("Cc", [R + 24, R + 152])
def test_walk_equals_jax(Cc):
    reads, lens, refs = _tasks(Cc + 1, 16, R, Cc)
    s, c, st, planes = _xla_fill(reads, lens, refs)
    # a lane with no qualifying cell walks from state -1, column -1
    c = np.asarray(c).copy()
    st = np.asarray(st).copy()
    c[5], st[5] = -1, -1
    jo, jn = jmsa.msa_walk(R, Cc, planes, jnp.asarray(lens), jnp.asarray(c),
                           jnp.asarray(st))
    to, tn = tmsa.msa_walk(R, Cc, torch.from_numpy(np.array(planes)),
                           torch.from_numpy(lens), torch.from_numpy(c),
                           torch.from_numpy(st))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert to.dtype == torch.uint8 and tn.dtype == torch.int32
    # and the match strings rendered from them
    clens = np.full(16, Cc, np.int32)
    assert tmsa.match_strings_np(to.numpy(), tn.numpy(), reads, lens, refs, clens, c) == \
        jmsa.match_strings_np(np.asarray(jo), np.asarray(jn), reads, lens, refs, clens, c)


def test_fused_map_step_equals_jax(tmp_path):
    """One prepared batch through both fused steps: per-task scores,
    winners, runner-ups and the walked winners' rows. The reference holds
    an exact repeat, so reads from it tie on the slot grid and the first
    maximal slot (the lowest task index) must win in both."""
    _check_fused_map_step(tmp_path)


def test_fused_map_step_reads_live_cells_only(tmp_path, monkeypatch):
    """The same batch with every dead plane byte of the fill set to 0xFF:
    the fused step still equals the JAX package's."""
    monkeypatch.setattr(map_fused, "msa_fill", _poisoned_fill)
    _check_fused_map_step(tmp_path)


def _check_fused_map_step(tmp_path):
    from bbtools_torch.models.bbmap import BBMap as TBBMap
    from bbtools_torch.models.bbmap import parse_args as tparse
    from bbtools_torch.ops.map_fused import fused_map_step as tstep
    from bbtools_tpu.io.fastq import FastqReader
    from bbtools_tpu.io.fasta import load_reference, write_fasta
    from bbtools_tpu.models.bbmap import BBMap as JBBMap
    from bbtools_tpu.models.bbmap import parse_args as jparse
    from bbtools_tpu.ops.map_fused import fused_map_step as jstep
    from bbtools_tpu.utils.synth import random_genome, random_reads, write_reads

    (name, seq), = random_genome(40_000, seed=11)
    rep = seq[5_000:7_000]
    write_fasta(str(tmp_path / "ref.fa"), [(name, seq[:20_000] + rep + seq[20_000:])])
    ref = load_reference(str(tmp_path / "ref.fa"))
    write_reads(str(tmp_path / "r.fq"), random_reads(
        ref, 256, read_len=100, snp_rate=0.01, indel_rate=0.06,
        indel_range=(1, 8), seed=5))
    args = [f"ref={tmp_path / 'ref.fa'}", f"in={tmp_path / 'r.fq'}"]
    jt = JBBMap(jparse(args))
    tt = TBBMap(tparse(args + ["device=cpu"]))
    batch = next(iter(FastqReader(str(tmp_path / "r.fq"), batch_reads=256, pad_to=None)))
    lengths = batch.lengths.astype(np.int64)
    outs = []
    for tool in (jt, tt):
        cand = tool.candidates_for_batch(batch.bases, lengths)
        task = tool._build_tasks(batch.bases, lengths, cand[0], cand[2], cand[5])
        prep = tool._fused_prep(batch.bases.shape[0], batch.bases.shape[1], cand[0],
                                cand[3], cand[4], cand[5], cand[1], *task[:3])
        outs.append((len(cand[0]), prep))
    (T, jprep), (T2, tprep) = outs
    assert T == T2
    j = jstep(*jprep["jit_args"])
    t = tstep(*tprep["args"])
    assert not bool(j[8]) and t[8] is False
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0])[:T])
    for k in range(1, 8):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    win_cls = t[5].numpy()
    assert len(t[9]) == len(j[9]) >= 1
    for c, (to, tn, jo, jn) in enumerate(zip(t[9], t[10], j[9], j[10])):
        n = int((win_cls == c).sum())
        assert to.shape[0] == tn.shape[0] == n
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo)[:n])
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn)[:n])
    assert sum(x.shape[0] for x in t[9]) > 0  # some winners were DP-improved
    # ties on the slot grid: the winner is the first of the tied slots
    win_task, win_score, second = (t[k].numpy() for k in (1, 2, 3))
    tied = np.flatnonzero((win_task >= 0) & (win_score == second))
    assert len(tied) > 0
    slot_map = tprep["args"][8].numpy()
    eff = t[0].numpy()
    for b in tied:
        slots = slot_map[b][slot_map[b] >= 0]
        assert win_task[b] == slots[np.argmax(eff[slots] == win_score[b])]
