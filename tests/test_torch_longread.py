"""The port's long-read presets against the JAX package's on the CPU:
`python -m bbtools_torch mappacbio|bbmapskimmer|mappacbioskimmer ...
device=cpu` writes the SAM of `python -m bbtools_tpu ...` byte for byte,
but for the program name of the @PG line; reads longer than fastareadlen
are chunked; and the plane budget, which splits a window class's DP tasks
into groups, changes no output."""

import numpy as np
import pytest
import torch

from bbtools_tpu.cli import main as jmain
from bbtools_tpu.core.dna import CODE_TO_BASE
from bbtools_tpu.io.fasta import load_reference, write_fasta
from bbtools_tpu.utils.synth import random_genome, write_reads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU runs (the plain fill's many
    small ops stall a shared thread pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """tests/test_bbmap_modes.py's 120 kb genome; six 2 kb reads with 4%
    substitutions and a 50 bp deletion (its mapPacBio case); four 2.5 kb
    reads with 1% substitutions, two of them reverse-complemented."""
    tmp = tmp_path_factory.mktemp("tlongread")
    write_fasta(str(tmp / "ref.fa"), random_genome(120_000, n_scaffolds=1, seed=17))
    codes = load_reference(str(tmp / "ref.fa")).scaffold_codes(0)
    rng = np.random.default_rng(31)
    with open(tmp / "pb.fa", "wb") as f:
        for i in range(6):
            start = 1000 + i * 15000
            read = codes[start : start + 2000].copy()
            m = rng.random(2000) < 0.04
            read[m] = (read[m] + rng.integers(1, 4, int(m.sum()))) % 4
            read = np.concatenate([read[:900], read[950:]])
            f.write(b">r%d_scaf0_pos%d_strand0_insert0\n%s\n"
                    % (i, start, CODE_TO_BASE[read].tobytes()))
    rng = np.random.default_rng(5)
    with open(tmp / "long.fa", "wb") as f:
        for i in range(4):
            start = 3000 + i * 25000
            read = codes[start : start + 2500].copy()
            m = rng.random(2500) < 0.01
            read[m] = (read[m] + rng.integers(1, 4, int(m.sum()))) % 4
            if i % 2:
                read = 3 - read[::-1]
            f.write(b">c%d_scaf0_pos%d_strand%d_insert0\n%s\n"
                    % (i, start, i % 2, CODE_TO_BASE[read].tobytes()))
    return tmp


@pytest.fixture(scope="module")
def dup(tmp_path_factory):
    """tests/test_bbmap_modes.py's skimmer case: a 3 kb segment twice in
    one scaffold, and 12 reads of 150 bp from its first copy."""
    tmp = tmp_path_factory.mktemp("tskim")
    rng = np.random.default_rng(13)
    seg = rng.integers(0, 4, 3000).astype(np.uint8)
    filler = rng.integers(0, 4, 5000).astype(np.uint8)
    codes = np.concatenate([filler, seg, filler[::-1], seg, filler])
    write_fasta(str(tmp / "dup.fa"), [(b"dup", CODE_TO_BASE[codes].tobytes())])
    recs = []
    for i in range(12):
        start = 5100 + i * 200
        recs.append((b"r%d_scaf0_pos%d_strand0_insert0" % (i, start),
                     CODE_TO_BASE[codes[start : start + 150]].tobytes(), b"F" * 150))
    write_reads(str(tmp / "dup.fq"), recs)
    return tmp


def jax_sam(tool, argv, path):
    jmain([tool, *argv, f"out={path}"])
    want = path.read_bytes()
    assert want.count(b"bbtools_tpu") == 2  # @PG ID and PN
    return want.replace(b"bbtools_tpu", b"bbtools_torch")


def torch_run(tool, argv, path):
    """The port's CLI entry of `tool` on the CPU; returns the BBMap it
    ran and its SAM."""
    from bbtools_torch.cli import TOOLS

    mapper = TOOLS[tool]([*argv, f"out={path}", "device=cpu"])
    return mapper, path.read_bytes()


def body(sam):
    return [ln.split(b"\t") for ln in sam.splitlines() if not ln.startswith(b"@")]


def test_mappacbio_equals_jax(genome):
    """mapPacBio at its defaults (k=12, minratio=0.40, window classes up
    to 7,640 extra columns): one record per 2 kb read, each mapped near
    its origin, the SAM equal to the JAX package's."""
    argv = [f"ref={genome / 'ref.fa'}", f"in={genome / 'pb.fa'}"]
    want = jax_sam("mappacbio", argv, genome / "pb.jax.sam")
    mapper, got = torch_run("mappacbio", argv, genome / "pb.torch.sam")
    assert got == want
    recs = body(got)
    assert len(recs) == 6  # fastareadlen=6000: not chunked
    near = [abs(int(r[3]) - 1 - int(r[0].split(b"_pos")[1].split(b"_")[0])) <= 50
            for r in recs]
    assert sum(near) >= 5
    assert mapper.fused_overflows == 0 and mapper.plane_groups >= 2
    assert sum(b"D" in r[5] for r in recs) >= 5  # the 50 bp deletion


def test_chunked_long_reads_equal_jax_at_two_budgets(genome, monkeypatch):
    """fastareadlen=1000 breaks 2.5 kb reads into name_chunk<off> reads.
    At a plane budget of four widest-class tasks, window class 0 (24
    tasks) passes the budget, so the fused phase hands the batch to the
    staged path, which fills and walks that class in groups: the SAM
    equals the JAX package's, as it does at the default budget
    (test_mappacbio_equals_jax)."""
    from bbtools_torch.ops import msa_fill

    argv = [f"ref={genome / 'ref.fa'}", f"in={genome / 'long.fa'}", "fastareadlen=1000"]
    want = jax_sam("mappacbio", argv, genome / "ch.jax.sam")
    monkeypatch.setattr(msa_fill, "CPU_PLANE_BUDGET", 4 * msa_fill.task_bytes(1024, 1024 + 7640))
    grouped, got = torch_run("mappacbio", argv, genome / "ch.torch.sam")
    assert got == want
    names = [r[0] for r in body(got)]
    assert len(names) == 12 and all(b"_chunk" in n for n in names)
    assert sum(not int(r[1]) & 4 for r in body(got)) >= 11
    # no fused fill; class 0 in two groups, classes 1 and 3 in one each
    assert grouped.fused_overflows == 1 and grouped.plane_groups >= 4


@pytest.mark.parametrize("tool", ["bbmapskimmer", "mappacbioskimmer"])
@pytest.mark.parametrize("budget", [None, 1])
def test_skimmer_equals_jax(dup, tool, budget, monkeypatch):
    """bbmapskimmer (ambig=all, secondary sites, the staged path) prints
    the repeat's second copy as flag-256 records; a plane budget of one
    byte fills and walks every DP task alone and changes no byte."""
    argv = [f"ref={dup / 'dup.fa'}", f"in={dup / 'dup.fq'}"]
    tag = f"{tool}.{budget}"
    want = jax_sam(tool, argv, dup / f"{tag}.jax.sam")
    if budget is not None:
        from bbtools_torch.ops import msa_fill

        monkeypatch.setattr(msa_fill, "CPU_PLANE_BUDGET", budget)
    mapper, got = torch_run(tool, argv, dup / f"{tag}.torch.sam")
    assert got == want
    recs = body(got)
    secondary = [r for r in recs if int(r[1]) & 0x100]
    assert len(recs) - len(secondary) == 12
    assert len(secondary) >= 10 and secondary[0][9] == b"*"
    assert mapper.plane_groups >= (1 if budget is None else 2)


def test_fused_step_declines_a_class_past_the_budget(tmp_path, monkeypatch):
    """The fused step of one prepared batch fills each class once at the
    default budget; at a budget of four tasks, under every class's size,
    it returns overflow before any fill, so the batch goes staged."""
    from bbtools_torch.models.bbmap import BBMap, parse_args
    from bbtools_torch.ops import map_fused, msa_fill
    from bbtools_torch.ops.map_fused import fused_map_step
    from bbtools_tpu.io.fastq import FastqReader
    from bbtools_tpu.utils.synth import random_reads

    write_fasta(str(tmp_path / "ref.fa"), random_genome(40_000, seed=11))
    write_reads(str(tmp_path / "r.fq"), random_reads(
        load_reference(str(tmp_path / "ref.fa")), 64, read_len=100,
        snp_rate=0.01, indel_rate=0.1, indel_range=(1, 8), seed=5))
    tool = BBMap(parse_args([f"ref={tmp_path / 'ref.fa'}", f"in={tmp_path / 'r.fq'}",
                             "device=cpu"]))
    batch = next(iter(FastqReader(str(tmp_path / "r.fq"), batch_reads=64, pad_to=None)))
    lengths = batch.lengths.astype(np.int64)
    B, L = batch.bases.shape
    cand = tool.candidates_for_batch(batch.bases, lengths)
    task = tool._build_tasks(batch.bases, lengths, cand[0], cand[2], cand[5])
    prep = tool._fused_prep(B, L, cand[0], cand[3], cand[4], cand[5], cand[1], *task[:3])
    cls_shapes = prep["args"][3]
    assert min(Sc for _Wc, Sc in cls_shapes) > 4
    one = fused_map_step(*prep["args"])
    assert not one[8] and one[11] == len(cls_shapes)
    assert sum(x.shape[0] for x in one[9]) > 0  # winners were walked
    fills = []
    monkeypatch.setattr(map_fused, "msa_fill", lambda *a: fills.append(1) or msa_fill.msa_fill(*a))
    monkeypatch.setattr(msa_fill, "CPU_PLANE_BUDGET", 4 * msa_fill.task_bytes(L, L + 24))
    small = fused_map_step(*prep["args"])
    assert small[8] and small[11] == 0 and small[9] == small[10] == ()
    assert fills == []


def test_fill_groups_cover_tasks_within_budget():
    from bbtools_torch.ops.msa_fill import fill_groups, plane_budget, task_bytes

    per = task_bytes(6000, 6000 + 7640)
    assert per > 117_000_000  # a mapPacBio widest-class task
    groups = fill_groups(1536, 6000, 13640, 40 * per + per // 2)
    assert [g.stop - g.start for g in groups] == [40] * 38 + [16]
    assert groups[0].start == 0 and groups[-1].stop == 1536
    assert all(a.stop == b.start for a, b in zip(groups, groups[1:]))
    # a task over the budget is a group of its own
    assert fill_groups(3, 6000, 13640, 1000) == [slice(0, 1), slice(1, 2), slice(2, 3)]
    assert fill_groups(0, 100, 124, 1 << 20) == []
    assert plane_budget("cpu") == 1 << 30


def test_failed_fill_allocation_raises(genome, monkeypatch):
    """An allocation that fails inside the fill reaches the caller: no
    path catches it, retries smaller or moves to another version."""
    from bbtools_torch.ops import map_fused

    def oom(*_a, **_k):
        raise torch.OutOfMemoryError("fill planes")

    monkeypatch.setattr(map_fused, "msa_fill", oom)
    argv = [f"ref={genome / 'ref.fa'}", f"in={genome / 'long.fa'}", "fastareadlen=1000"]
    with pytest.raises(torch.OutOfMemoryError):
        torch_run("mappacbio", argv, genome / "oom.sam")
