"""The port's BBMerge flags beyond the defaults against the JAX package's
on the CPU, byte for byte: `ecco=t` (both mates take the consensus and
come out through out= and outu2=; a batch in which nothing merges falls
through to the normal writes), `extend2=N` (host Tadpole extension of
the unmerged pairs, then a second scan), `ecct=t` (Tadpole correction
before the scan, on k-mers counted on the device), tadpipe's merge stage
(`k=75 extend2=120 rem ecct`) and `nn=t` (the CellNet gate), plus
`bbmerge_nn_features`.

With nn=t the gate compares a float32 net score with the cutoff. The two
packages sum the net's float32 matmuls in different orders (numpy
against torch), which moves a score by a few ulps, so a pair whose score
lies that close to the cutoff may be merged by one and ambiguous in the
other. The nn=t tests allow exactly those pairs to differ: the pairs
whose JAX score lies within NN_NEAR (1e-5) of the cutoff, counted (none
are expected).

The JAX package's `BBMerge` writes `nn=t`'s max_ratio into its
module-level `PRESETS`, so each test runs against a fresh copy of them
(`pristine_jax_presets`, as in tests/test_torch_bbmerge.py)."""

import copy

import numpy as np
import pytest
import torch

from bbtools_torch.models import bbmerge as tbm
from bbtools_torch.ops import overlap as tov
from bbtools_torch.utils.fqdiff import differing_names
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.ml import cellnet as jcn
from bbtools_tpu.models import bbmerge as jbm
from bbtools_tpu.ops import overlap as jov
from test_torch_bbmerge import _write, make_pairs

COMP = bytes.maketrans(b"ACGT", b"TGCA")
JAX_PRESETS = copy.deepcopy(jbm.PRESETS)


@pytest.fixture(autouse=True)
def pristine_jax_presets(monkeypatch):
    """Every test sees a fresh copy of the JAX package's published
    BBMerge presets, whatever ran earlier in this process."""
    monkeypatch.setattr(jbm, "PRESETS", copy.deepcopy(JAX_PRESETS))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU runs: the suite runs several
    test processes on shared cores, where torch's thread pool, woken at
    each of the many small ops of the mate selection and the fills,
    stalls (as in tests/test_torch_bbmap.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_both(tmp, tag, ins, flags):
    """`bbmerge` in both packages with out/outu1/outu2/ihist; returns the
    port's tool and each package's four files."""
    files, tool = {}, None
    for pkg in ("jax", "torch"):
        outs = [tmp / f"{tag}.{pkg}.{x}" for x in ("m.fq", "u1.fq", "u2.fq", "ihist.txt")]
        argv = [*ins, *(f"{k}={o}" for k, o in zip(("out", "outu1", "outu2", "ihist"), outs)),
                *flags]
        if pkg == "jax":
            jmain(["bbmerge", *argv])
        else:
            tool = tbm.main([*argv, "device=cpu"])
        files[pkg] = [o.read_bytes() for o in outs]
    return tool, files


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """tests/test_torch_bbmerge.py's pairs: 400 pairs of 100 bp from
    inserts of 60-260 bp, adapters past the insert, phred-rate errors."""
    d = tmp_path_factory.mktemp("ext_pairs")
    recs = make_pairs(400, 11, L=100, lo=60, hi=260)
    return [f"in1={_write(d / 'r1.fq.gz', [p[0] for p in recs])}",
            f"in2={_write(d / 'r2.fq.gz', [p[1] for p in recs])}"]


@pytest.fixture(scope="module")
def genome_pairs(tmp_path_factory):
    """test_bbmerge.py's extend2 case at half its size: 600 pairs of 100
    bp from inserts of 230-270 bp of a 12 kb genome (a 30-70 bp gap that
    only extension closes), every 20th base of phred 12 and 0.5% of the
    bases substituted (at phred 12), so ecct has errors to correct."""
    d = tmp_path_factory.mktemp("ext_genome")
    rng = np.random.default_rng(61)
    g = bytes(b"ACGT"[c] for c in rng.integers(0, 4, 12_000))
    recs = ([], [])
    for i in range(600):
        ins = int(rng.integers(230, 271))
        s0 = int(rng.integers(0, len(g) - ins))
        frag = g[s0 : s0 + ins]
        for m, r in enumerate((frag[:100], frag[-100:].translate(COMP)[::-1])):
            s = np.frombuffer(r, np.uint8).copy()
            q = np.full(100, ord("F"), np.uint8)
            q[::20] = ord("-")
            err = rng.random(100) < 0.005
            s[err] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, err.sum())]
            q[err] = ord("-")
            recs[m].append((b"@p%d" % i, s.tobytes(), q.tobytes()))
    return [f"in1={_write(d / 'g1.fq.gz', recs[0])}", f"in2={_write(d / 'g2.fq.gz', recs[1])}"]


def test_bbmerge_nn_features_match_jax():
    rng = np.random.default_rng(4)
    B = 300
    f32 = np.float32
    stats = {
        "best_insert": rng.integers(-1, 400, B), "best_overlap": rng.integers(-1, 150, B),
        "best_bad": rng.uniform(0, 20, B).astype(f32),
        "best_ratio": rng.uniform(0, 1, B).astype(f32),
        "best_bad_int": rng.integers(-1, 20, B),
        "second_insert": rng.integers(-1, 400, B), "second_overlap": rng.integers(0, 150, B),
        "second_bad": rng.uniform(0, 200, B).astype(f32),
        "second_ratio": rng.uniform(0, 1, B).astype(f32),
        "second_bad_int": rng.integers(-1, 20, B),
    }
    args = (rng.integers(30, 151, B).astype(f32), rng.integers(30, 151, B).astype(f32),
            rng.integers(11, 30, B).astype(f32), rng.uniform(0, 3, B).astype(f32),
            rng.uniform(0, 3, B).astype(f32), stats, rng.uniform(0, 2, B).astype(f32),
            rng.uniform(0, 1, B).astype(f32))
    got = tov.bbmerge_nn_features(*args)
    want = jov.bbmerge_nn_features(*args)
    assert got.dtype == np.float32 and got.shape == (B, 23)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("flags", [["ecco=t"], ["ecco=t", "mix=t", "strict"]],
                         ids=["ecco", "tadpipe_ecco"])
def test_ecco_equals_jax(tmp_path, pairs, flags):
    tool, files = run_both(tmp_path, "ecco", pairs, flags)
    assert files["torch"] == files["jax"]
    # every pair comes out, corrected, through out= (r1) and outu2= (r2)
    assert files["torch"][0].count(b"\n") == files["torch"][2].count(b"\n") == 1600
    assert files["torch"][1] == b""
    assert tool.merged > 100


def test_ecco_fixes_planted_errors_equal_jax(tmp_path):
    """tests/test_tools.py's ecco case: an error of phred 2 in r1's
    overlap is replaced by r2's base."""
    rng = np.random.default_rng(5)
    recs = ([], [])
    mols = []
    for i in range(100):
        mol = rng.integers(0, 4, 140)
        mols.append(bytes(b"ACGT"[x] for x in mol[:100]))
        r1 = mol[:100].copy()
        r1[90] = (r1[90] + 1) % 4
        q1 = bytearray(b"F" * 100)
        q1[90] = ord("#")
        r2 = (3 - mol[40:][::-1]).copy()
        recs[0].append((b"@p%d" % i, bytes(b"ACGT"[x] for x in r1), bytes(q1)))
        recs[1].append((b"@p%d" % i, bytes(b"ACGT"[x] for x in r2), b"F" * 100))
    ins = [f"in1={_write(tmp_path / 'e1.fq.gz', recs[0])}",
           f"in2={_write(tmp_path / 'e2.fq.gz', recs[1])}"]
    tool, files = run_both(tmp_path, "fix", ins, ["ecco=t"])
    assert files["torch"] == files["jax"]
    out1 = files["torch"][0].splitlines()
    fixed = sum(out1[4 * i + 1] == mols[int(out1[4 * i][2:])] for i in range(len(out1) // 4))
    assert tool.merged >= 90 and fixed >= 85


def test_ecco_batch_with_nothing_merged_equals_jax(tmp_path):
    """The first batch's pairs do not overlap (inserts of 260-300 bp with
    100 bp reads), so no pair of it merges and it takes the normal
    merged/unmerged writes; the later batches take ecco's."""
    far = make_pairs(64, 31, L=100, lo=260, hi=300)
    near = make_pairs(128, 32, L=100, lo=80, hi=180)
    recs = far + near
    ins = [f"in1={_write(tmp_path / 'b1.fq.gz', [p[0] for p in recs])}",
           f"in2={_write(tmp_path / 'b2.fq.gz', [p[1] for p in recs])}"]
    tool, files = run_both(tmp_path, "none", ins, ["ecco=t", "batchreads=64"])
    assert files["torch"] == files["jax"]
    # the first batch's 64 pairs come out unmerged through outu1= and outu2=
    assert files["torch"][1].count(b"\n") == 4 * 64
    assert files["torch"][2].count(b"\n") == 4 * (64 + 128)
    assert 0 < tool.merged <= 128


@pytest.mark.parametrize("flags", [
    ["extend2=60"],
    ["ecct=t"],
    ["k=75", "extend2=120", "rem=t", "ecct=t"],  # tadpipe's merge stage
], ids=["extend2", "ecct", "tadpipe_merge"])
def test_extend2_ecct_equal_jax(tmp_path, genome_pairs, flags, monkeypatch):
    from bbtools_torch.models import tadpole_ecc

    corrected = []
    correct_batch = tadpole_ecc.EccEngine.correct_batch

    def counting(self, *a, **kw):
        nc = correct_batch(self, *a, **kw)
        corrected.append(int(nc.sum()))
        return nc

    monkeypatch.setattr(tadpole_ecc.EccEngine, "correct_batch", counting)
    tool, files = run_both(tmp_path, "ext", genome_pairs, flags)
    assert files["torch"] == files["jax"]
    if "extend2=60" in flags or "extend2=120" in flags:
        assert tool.merged_by_extension >= 300, tool.merged_by_extension
    else:
        assert tool.merged_by_extension == 0
    # ecct corrected bases of both mates of every batch before the scan
    # (the unmerged outputs keep the reads' original text, as in the JAX
    # package: the correction edits the codes only)
    assert (sum(corrected) > 50) == ("ecct=t" in flags), corrected


def _jax_scores(monkeypatch):
    """Record every score the JAX package's net gives, in call order."""
    scores = []
    apply = jcn.CellNet.apply

    def recording(self, x):
        out = apply(self, x)
        scores.append(np.asarray(out).reshape(-1))
        return out

    monkeypatch.setattr(jcn.CellNet, "apply", recording)
    return scores


def assert_nn_equal(files, scores, names, cutoff):
    """The port's files equal the JAX package's but for pairs whose JAX
    score lies within NN_NEAR of the cutoff; returns how many such pairs
    there are."""
    score = np.concatenate(scores)
    near = {names[i] for i in np.flatnonzero(np.abs(score - cutoff) <= tbm.NN_NEAR)}
    for got, want in zip(files["torch"], files["jax"]):
        if got != want:
            assert differing_names(got, want) <= near
    return len(near)


@pytest.mark.parametrize("extra", [[], ["netcutoff=0.5"], ["strict"]],
                         ids=["default", "cutoff", "strict"])
def test_nn_equals_jax_but_near_the_cutoff(tmp_path, pairs, monkeypatch, extra):
    scores = _jax_scores(monkeypatch)
    tool, files = run_both(tmp_path, "nn", pairs, ["nn=t", *extra])
    names = [b"p%d" % i for i in range(400)]
    assert assert_nn_equal(files, scores, names, np.float32(tool.net_cutoff)) == 0
    assert files["torch"] == files["jax"]
    assert len(tool.nn_near) == 0
    # the gate acts: the default run merges a different number of pairs
    assert tool.preset.max_ratio == 0.7
    assert tbm.PRESETS["default"].max_ratio == 0.09  # the port's table untouched
    default, _ = run_both(tmp_path, "nn_off", pairs, extra[-1:] if extra == ["strict"] else [])
    assert tool.merged != default.merged and tool.merged > 0


def test_nn_flag_changes_decisions_equal_jax(tmp_path, monkeypatch):
    """tests/test_cellnet.py's case: 150 pairs of 100 bp from inserts of
    120-170 bp of a 20 kb genome."""
    from bbtools_tpu.io.fasta import load_reference, write_fasta
    from bbtools_tpu.utils.synth import random_genome, random_reads, write_reads

    write_fasta(str(tmp_path / "g.fa"), random_genome(20_000, seed=33))
    ref = load_reference(str(tmp_path / "g.fa"))
    prs = random_reads(ref, 150, read_len=100, paired=True, insert_range=(120, 170),
                       snp_rate=0.0, seed=6)
    write_reads(str(tmp_path / "x1.fq"), [p[0] for p in prs])
    write_reads(str(tmp_path / "x2.fq"), [p[1] for p in prs])
    ins = [f"in1={tmp_path}/x1.fq", f"in2={tmp_path}/x2.fq"]
    scores = _jax_scores(monkeypatch)
    tool, files = run_both(tmp_path, "nn", ins, ["nn=t"])
    names = [p[0][0].split()[0] for p in prs]
    assert assert_nn_equal(files, scores, names, np.float32(tool.net_cutoff)) == 0
    assert files["torch"] == files["jax"]
    off, _ = run_both(tmp_path, "off", ins, [])
    assert tool.net is not None and 0 < tool.merged != off.merged
