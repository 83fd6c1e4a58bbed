import json
import os
import tempfile

import numpy as np
import pytest

from portbench import gen, harness


def test_genome_and_reads_repeat_from_the_seed():
    g1, g2 = gen.genome(20_000, 2**31 + 5), gen.genome(20_000, 2**31 + 5)
    assert np.array_equal(g1, g2)
    assert not np.array_equal(g1, gen.genome(20_000, 7))
    a, ta = gen.genome_reads(g1, 400, 151, 0.01, 0.1, (1, 10), 99)
    b, tb = gen.genome_reads(g1, 400, 151, 0.01, 0.1, (1, 10), 99)
    assert np.array_equal(a, b)
    assert all(np.array_equal(ta[k], tb[k]) for k in ta)


def test_every_seed_gets_the_same_set_of_sizes():
    g = gen.genome(50_000, 1)
    sizes = []
    for seed in (1, 2, 2**33 + 3):
        _, t = gen.genome_reads(g, 1000, 151, 0.01, 0.1, (1, 10), seed)
        sizes.append((int((t["kind"] == 1).sum()), int((t["kind"] == 2).sum()),
                      tuple(np.sort(t["ilen"][t["kind"] > 0]))))
    assert sizes[0] == sizes[1] == sizes[2]
    assert sizes[0][0] + sizes[0][1] == 100
    ins = [np.sort(gen.spread(gen.rng_for(s, "reads"), 500, 100, 450)) for s in (4, 5)]
    assert np.array_equal(ins[0], ins[1])


def test_reads_come_from_their_truth():
    g = gen.genome(30_000, 3)
    codes, t = gen.genome_reads(g, 200, 151, 0.0, 0.0, (1, 10), 4)
    for i in range(200):
        fwd = codes[i] if t["strand"][i] == 0 else gen.revcomp(codes[i])
        assert np.array_equal(fwd, g[t["start"][i]:t["start"][i] + 151])


@pytest.mark.parametrize("mates", [1, 2])
def test_adapter_pairs_and_fastq_repeat(mates):
    ad = ["AGATCGGAAGAGCACACGTCTGAACTCCAGTCA", "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"]
    x = gen.adapter_pairs(300, 151, (100, 450), 0.005, ad, 25, 2**31 + 9)
    y = gen.adapter_pairs(300, 151, (100, 450), 0.005, ad, 25, 2**31 + 9)
    for (c1, q1), (c2, q2) in zip(x[:mates], y[:mates]):
        assert np.array_equal(c1, c2) and np.array_equal(q1, q2)
        raw = gen.fastq_bytes(c1, q1, b"p", b" 1:N:0")
        assert raw == gen.fastq_bytes(c2, q2, b"p", b" 1:N:0")
        assert raw.count(b"\n") == 4 * 300


def _classes(g, codes, t, walk):
    ind = np.flatnonzero(t["kind"] > 0)
    fwd = np.where((t["strand"][ind] == 1)[:, None], gen.revcomp(codes[ind]), codes[ind])
    return ind, gen.walk_class(gen.kmer_index(g, 13), fwd, t["start"][ind], t["ilen"][ind], walk)


def test_every_seed_walks_the_same_wide_windows():
    walk = dict(json.load(open(os.path.join(harness.HERE, "traffic", "se151_divergent.json")))["walk"],
                batch=1000, per_job={"2": 1, "3": 2})
    g = gen.genome(200_000, 6)
    for seed in (3, 2**31 + 7):
        codes, t = gen.genome_reads(g, 3000, 151, 0.01, 0.1, (1, 10), seed, walk=walk)
        plain, pt = gen.genome_reads(g, 3000, 151, 0.01, 0.1, (1, 10), seed)
        moved = t["start"] != pt["start"]
        assert 0 < moved.sum() < 30 and (t["kind"][moved] > 0).all()
        assert np.array_equal(codes[~moved], plain[~moved])
        ind, cls = _classes(g, codes, t, walk)
        per_batch = np.zeros((3, 4), np.int64)
        np.add.at(per_batch, (ind // 1000, cls), 1)
        assert per_batch[:, 2].max() <= 1 and per_batch[:, 2].sum() == 1
        assert per_batch[:, 3].max() <= 1 and per_batch[:, 3].sum() == 2
        assert per_batch[:, :2].sum() == 300 - 3


def test_the_window_classes_are_the_programs():
    """The copied seed rule gives each indel read the class of the
    cluster that the program's own seeding puts around its true site."""
    from bbtools_torch.models import bbmap

    walk = json.load(open(os.path.join(harness.HERE, "traffic", "se151_divergent.json")))["walk"]
    g = gen.genome(300_000, 9)
    codes, t = gen.genome_reads(g, 4000, 151, 0.01, 0.5, (1, 10), 2**31 + 3)
    ind, mine = _classes(g, codes, t, walk)
    with tempfile.TemporaryDirectory() as d:
        gen.write_fasta(os.path.join(d, "ref.fa"), b"genome", g)
        tool = bbmap.BBMap(bbmap.parse_args([f"ref={d}/ref.fa", "device=cpu"]))
    # the reader pads a batch of 151 bp reads to its length bucket
    padded = np.full((len(ind), walk["width"]), 4, np.uint8)
    padded[:, :151] = codes[ind]
    rd, diag, _, _, spread, _, _ = tool.candidates_for_batch(padded, np.full(len(ind), 151))
    width = np.zeros(len(ind), np.int64)
    for r, d0, sp in zip(rd.tolist(), diag.tolist(), spread.tolist()):
        s, il = int(t["start"][ind[r]]), int(t["ilen"][ind[r]])
        if d0 <= s + il and d0 + sp >= s - il:
            width[r] = max(width[r], sp)
    theirs = np.searchsorted(np.asarray(walk["spreads"]), width, "left")
    assert np.array_equal(mine, theirs)
    assert (mine >= 2).any()
