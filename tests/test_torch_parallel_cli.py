"""The port's tpshards=/shards= tools on a mesh of CPU copies (device=cpu):
each output byte-equal to the port's single-device run and to the JAX
package's own sharded run (on its 8 virtual CPU devices) on the same
files; SAM `@PG` lines aside. The inputs are tests/test_multichip.py's."""

import contextlib
import copy
import io
import re

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as tmain
from bbtools_torch.models import bbduk as tbbduk
from bbtools_torch.models import bbmap as tbbmap
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.models import bbmerge as jax_bbmerge

#: the JAX package's presets as published, copied at import
JAX_PRESETS = copy.deepcopy(jax_bbmerge.PRESETS)


@pytest.fixture(autouse=True)
def pristine_jax_presets(monkeypatch):
    """A fresh copy of the JAX package's BBMerge presets for every test
    (tests/test_torch_bbmerge.py: its BBMerge writes into them)."""
    monkeypatch.setattr(jax_bbmerge, "PRESETS", copy.deepcopy(JAX_PRESETS))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cli, argv):
    with contextlib.redirect_stderr(io.StringIO()):
        cli(argv)


def _three(tmp_path, tool, argv, outs, sharded):
    """The port on one device, the port sharded and the JAX package
    sharded; returns their output files' bytes."""
    res = {}
    for tag, cli, extra in (("one", tmain, ["device=cpu"]),
                            ("torch", tmain, ["device=cpu", sharded]),
                            ("jax", jmain, [sharded])):
        _run(cli, [tool, *(a.format(d=tmp_path / tag) for a in argv), *extra])
        res[tag] = [(tmp_path / o.format(d=tag)).read_bytes() for o in outs]
    return res


def _bbduk_input(tmp_path):
    rng = np.random.default_rng(17)
    scafs = [rng.integers(0, 4, 40).astype(np.uint8) for _ in range(40)]
    with open(tmp_path / "panel.fa", "w") as fh:
        for i, s in enumerate(scafs):
            fh.write(f">a{i}\n" + "".join("ACGT"[c] for c in s) + "\n")
    with open(tmp_path / "in.fq", "w") as fh:
        for i in range(700):
            r = rng.integers(0, 4, 151).astype(np.uint8)
            if i % 3 == 0:
                s = scafs[i % len(scafs)]
                p = int(rng.integers(20, 100))
                r[p : p + len(s)] = s
            fh.write(f"@r{i}\n" + "".join("ACGT"[c] for c in r) + f"\n+\n{'F' * 151}\n")


@pytest.mark.parametrize("shards", [8, 4])
def test_bbduk_tpshards_equals_single_and_jax(tmp_path, shards):
    """tpshards=8 (a 1x8 mesh) and tpshards=4 (2x4: the reads over dp,
    the last batch ragged)."""
    _bbduk_input(tmp_path)
    res = _three(tmp_path, "bbduk", [
        f"in={tmp_path}/in.fq", "out={d}.fq", f"ref={tmp_path}/panel.fa", "k=23",
        "mink=11", "hdist=1", "ktrim=r", "stats={d}.stats", "batchreads=300",
    ], ["{d}.fq", "{d}.stats"], f"tpshards={shards}")
    assert res["torch"] == res["one"] == res["jax"]
    assert res["one"][0].count(b"\n@") > 600


def test_bbmap_tpshards_equals_single_and_jax(tmp_path):
    """tpshards=8 over reads with planted indels, so the DP classes run."""
    from bbtools_torch.core.dna import CODE_TO_BASE
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.utils.synth import random_genome, write_reads

    write_fasta(str(tmp_path / "ref.fa"), random_genome(60_000, n_scaffolds=2, seed=91))
    ref = load_reference(str(tmp_path / "ref.fa"))
    gg = np.random.default_rng(17)
    recs = []
    for i in range(300):
        codes = ref.scaffold_codes(int(gg.integers(0, 2)))
        p = int(gg.integers(0, len(codes) - 140))
        r = codes[p : p + 140].copy()
        if i & 1:
            r = (3 - r[::-1]).astype(np.uint8)
        e = gg.random(140) < 0.01
        r[e] = (r[e] + gg.integers(1, 4, int(e.sum()))) % 4
        if i % 7 == 0:  # a planted indel so the DP classes run
            q = int(gg.integers(30, 100))
            r = np.concatenate([r[:q], r[q + 3 :], codes[p : p + 3]])[:140]
        recs.append((b"r%d" % i, CODE_TO_BASE[np.minimum(r, 4)].tobytes(), b"F" * 140))
    write_reads(str(tmp_path / "r.fq"), recs)
    res = _three(tmp_path, "bbmap", [f"ref={tmp_path}/ref.fa", f"in={tmp_path}/r.fq",
                                     "out={d}.sam", "nodisk"], ["{d}.sam"], "tpshards=8")
    body = {k: [ln for ln in v[0].splitlines() if not ln.startswith(b"@PG")]
            for k, v in res.items()}
    assert body["torch"] == body["one"] == body["jax"]
    assert sum(not ln.startswith(b"@") for ln in body["one"]) == 300


def test_bbmerge_tpshards_equals_single_and_jax(tmp_path):
    rng = np.random.default_rng(5)
    gen = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 20000)]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    with open(tmp_path / "m1.fq", "wb") as f1, open(tmp_path / "m2.fq", "wb") as f2:
        for i in range(301):
            ins = int(rng.integers(80, 260))
            p = int(rng.integers(0, 20000 - ins))
            frag = gen[p : p + ins].tobytes()
            q = bytes(rng.integers(53, 74, 150).astype(np.uint8))
            f1.write(b"@p%d\n%s\n+\n%s\n" % (i, (frag + b"A" * 150)[:150], q))
            f2.write(b"@p%d\n%s\n+\n%s\n" % (i, (frag[::-1].translate(comp) + b"A" * 150)[:150], q))
    outs = ["{d}.m.fq", "{d}.u1.fq", "{d}.u2.fq", "{d}.ih.txt"]
    res = _three(tmp_path, "bbmerge", [
        f"in1={tmp_path}/m1.fq", f"in2={tmp_path}/m2.fq", "out={d}.m.fq", "outu1={d}.u1.fq",
        "outu2={d}.u2.fq", "ihist={d}.ih.txt", "batchreads=128",
    ], outs, "tpshards=4")
    assert res["torch"] == res["one"] == res["jax"]
    assert res["one"][0].count(b"\n@") > 200


def test_kmercountexact_shards_equals_single_and_jax(tmp_path):
    g = np.random.default_rng(13)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = acgt[g.integers(0, 4, 150)].tobytes()
    with open(tmp_path / "r.fq", "wb") as f:
        for i in range(400):
            seq = base if i % 3 == 0 else acgt[g.integers(0, 4, 150)].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"F" * 150))
    res = _three(tmp_path, "kmercountexact", [
        f"in={tmp_path}/r.fq", "k=31", "khist={d}.h.txt", "dump={d}.d.fa",
    ], ["{d}.h.txt", "{d}.d.fa"], "shards=8")
    assert res["torch"] == res["one"] == res["jax"]
    assert b"\n134\t" in res["one"][0]


def test_tadpole_shards_equals_single_and_jax(tmp_path):
    g = np.random.default_rng(23)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = acgt[g.integers(0, 4, 8000)].tobytes()
    with open(tmp_path / "r.fq", "wb") as f:
        for i in range(600):
            p = int(g.integers(0, len(genome) - 100))
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, genome[p : p + 100], b"F" * 100))
    res = _three(tmp_path, "tadpole", [f"in={tmp_path}/r.fq", "out={d}.fa", "k=31"],
                 ["{d}.fa"], "shards=8")
    assert res["torch"] == res["one"] == res["jax"]
    assert res["one"][0].count(b">") >= 1


@pytest.mark.parametrize("tool", ["kmercountexact", "tadpole", "bbmerge"])
def test_shards_past_the_devices_raise_as_jax(tmp_path, tool):
    """shards=16 on 8 devices: the JAX package's mesh error, word for
    word."""
    fq = tmp_path / "r.fq"
    fq.write_text("@r\n" + "ACGT" * 20 + "\n+\n" + "F" * 80 + "\n")
    argv = [tool, f"in={fq}", f"out={tmp_path}/o.fa", "shards=16"]
    if tool == "bbmerge":
        argv = [tool, f"in1={fq}", f"in2={fq}", f"out={tmp_path}/o.fq", "tpshards=16"]
    with pytest.raises(ValueError) as j:
        _run(jmain, argv)
    assert "16x1 mesh does not cover 8 devices" in str(j.value)
    with pytest.raises(ValueError, match=re.escape(str(j.value))):
        _run(tmain, [*argv, "device=cpu"])


def test_tpshards_past_the_cards_raise_as_jax(monkeypatch, tmp_path):
    """tpshards=N on a CUDA device with fewer cards: the JAX package's
    messages (bbduk: N must divide the cards; bbmap: N must not exceed
    them), here on a count of 2 cards given by a patched device count."""
    fa = tmp_path / "ref.fa"
    fa.write_text(">s\n" + "ACGTTGCAAGCTTCGA" * 40 + "\n")
    duk = tbbduk.BBDuk(tbbduk.parse_args(["literal=AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
                                          "k=23", "device=cpu"]))
    bbm = tbbmap.BBMap(tbbmap.parse_args([f"ref={fa}", "in=r.fq", "nodisk", "device=cpu"]))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for tool in (duk, bbm):
        tool.device = torch.device("cuda")
    with pytest.raises(ValueError, match=re.escape("tpshards=4 does not divide 2 devices")):
        duk.enable_mesh(n_tp=4)
    with pytest.raises(ValueError, match=re.escape("tpshards=3 does not divide 2 devices")):
        duk.enable_mesh(n_tp=3)
    with pytest.raises(ValueError, match=re.escape("tpshards=4 exceeds 2 devices")):
        bbm.enable_mesh(4)
