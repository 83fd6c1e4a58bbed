"""The port's count-min sketch and its users against the JAX package's on
the CPU: `ops/cms.py` (slots, adds with duplicates and saturation,
queries), `python -m bbtools_torch bbcms ... device=cpu` (ecc=t, and the
depth filters mincount= hcf= tossjunk=) and BBMap's `bloomfilter=t`
prescreen, each byte-equal to the JAX package's on the same seeded
input."""

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as tmain
from bbtools_torch.ops import cms as tcms
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.io.fasta import load_reference, write_fasta
from bbtools_tpu.ops import cms as jcms
from bbtools_tpu.utils.synth import random_genome, random_reads, write_reads


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


def _keys(seed, n, dups, hi=1 << 62):
    """n random int64 keys, then `dups` repeats drawn from them and one
    key repeated 300 times."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, hi, n).astype(np.int64)
    return np.concatenate([keys, rng.choice(keys, dups), np.full(300, keys[0])])


@pytest.mark.parametrize("hashes", [1, 2, 3, 4])
def test_cms_slots_match_host_and_jax(hashes):
    keys = _keys(1, 4000, 500)
    keys[:4] = [0, 1, (1 << 62) - 1, (1 << 63) - 1]  # the extremes of the key range
    got = tcms.cms_slots(torch.as_tensor(keys), hashes, 1 << 16).numpy()
    sk = tcms.CountMinSketch(1 << 16, hashes, device="cpu")
    np.testing.assert_array_equal(got, sk._slots_np(keys))
    import jax.numpy as jnp

    want = np.asarray(jcms._slots_jnp(jnp.asarray(keys), hashes, 1 << 16))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cells,hashes,max_count,rounds", [
    (1 << 12, 3, 65535, 3),  # many collisions, no saturation
    (1 << 10, 2, 40, 4),  # saturation: the repeated key and crowded slots
    (1 << 16, 4, 7, 2),
])
def test_cms_add_query_match_jax(cells, hashes, max_count, rounds):
    t = tcms.CountMinSketch(cells, hashes, max_count=max_count, device="cpu")
    j = jcms.CountMinSketch(cells, hashes, max_count=max_count)
    for r in range(rounds):
        keys = _keys(10 + r, 3000, 700)
        t.add(keys)
        j.add(keys)
        np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
    assert t.table.dtype == torch.int32 and int(t.table.max()) <= max_count
    q = np.concatenate([_keys(10, 3000, 0), _keys(99, 1000, 0)])
    got = t.query(q)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, j.query(q))
    np.testing.assert_array_equal(t.query_t(torch.as_tensor(q)).numpy(), got)
    if max_count < 300:
        assert got[0] == max_count  # the repeated key saturated


def test_cms_empty_add_and_duplicates_accumulate():
    t = tcms.CountMinSketch(1 << 16, 2, device="cpu")
    t.add(np.zeros(0, np.int64))
    assert int(t.table.sum()) == 0
    t.add(np.array([7, 7, 7, 9], np.int64))
    got = t.query(np.array([7, 9], np.int64))
    assert got[0] >= 3 and got[1] >= 1
    assert int(t.table.sum()) == 2 * 4
    table = tcms.CMSTable(t, 25)
    np.testing.assert_array_equal(table.count_of([7, 9]), got)


def test_cms_runs_on_the_device_it_was_given():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tcms.CountMinSketch(1 << 10)
    before = tcms.cms_add.device_calls
    tcms.CountMinSketch(1 << 10, device="cpu").add(np.arange(5))
    assert tcms.cms_add.device_calls == before  # counts CUDA adds only


def _planted_error_reads(path, n, seed, junk=0, L=100, glen=1500):
    """test_ecc's data: deep reads of a random genome, every fourth with
    one substitution, then `junk` random reads."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, glen).astype(np.uint8)
    seqs = []
    for i in range(n):
        p = int(rng.integers(0, glen - L))
        codes = genome[p : p + L].copy()
        if i % 4 == 0:
            ep = int(rng.integers(10, L - 10))
            codes[ep] = (codes[ep] + 1 + int(rng.integers(3))) % 4
        seqs.append(codes)
    seqs += [rng.integers(0, 4, L).astype(np.uint8) for _ in range(junk)]
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f"@r{i}\n{bytes(b'ACGT'[c] for c in s).decode()}\n+\n{'D' * L}\n")
    return str(path)


BBCMS_CASES = {
    "ecc": ["k=25"],
    "filters": ["ecc=f", "mincount=2", "hcf=0.5", "tossjunk=t"],
    "ecc_filters": ["k=25", "mincount=3", "hcf=0.6", "cells=3000", "hashes=2"],
}


@pytest.mark.parametrize("case", list(BBCMS_CASES))
def test_bbcms_equals_jax(tmp_path, case):
    fin = _planted_error_reads(tmp_path / "in.fq", 600, 11, junk=20)
    files = {}
    for pkg, main in (("jax", jmain), ("torch", tmain)):
        outs = [tmp_path / f"{pkg}.{x}.fq" for x in ("out", "bad")]
        argv = ["bbcms", f"in={fin}", f"out={outs[0]}", f"outb={outs[1]}",
                *BBCMS_CASES[case]] + (["device=cpu"] if pkg == "torch" else [])
        main(argv)
        files[pkg] = [p.read_bytes() for p in outs]
    assert files["torch"] == files["jax"]
    kept = files["torch"][0].count(b"\n") // 4
    tossed = files["torch"][1].count(b"\n") // 4
    assert kept + tossed == 620
    if case != "ecc":
        assert 0 < tossed <= 40  # the junk reads go
    if case != "filters":
        truth = open(fin, "rb").read()
        assert files["torch"][0] != truth  # errors were corrected


def test_bbcms_paired_equals_jax(tmp_path):
    f1 = _planted_error_reads(tmp_path / "r1.fq", 300, 21)
    f2 = _planted_error_reads(tmp_path / "r2.fq", 300, 21)
    files = {}
    for pkg, main in (("jax", jmain), ("torch", tmain)):
        outs = [tmp_path / f"{pkg}.{m}.fq" for m in (1, 2)]
        main(["bbcms", f"in={f1}", f"in2={f2}", f"out={outs[0]}", f"out2={outs[1]}",
              "k=21", "mincount=2"] + (["device=cpu"] if pkg == "torch" else []))
        files[pkg] = [p.read_bytes() for p in outs]
    assert files["torch"] == files["jax"]
    assert files["torch"][0].count(b"\n") == 1200


@pytest.fixture(scope="module")
def bloom_data(tmp_path_factory):
    """test_bbmap_modes.py's bloom case on a 60 kb genome: 60 reads of the
    genome (some with substitutions), 40 foreign ones."""
    tmp = tmp_path_factory.mktemp("bloom")
    write_fasta(str(tmp / "ref.fa"), random_genome(60_000, n_scaffolds=1, seed=17))
    ref = load_reference(str(tmp / "ref.fa"))
    reads = random_reads(ref, 60, read_len=100, snp_rate=0.01, seed=5)
    rng = np.random.default_rng(3)
    reads += [(b"junk%d_scaf0_pos0_strand0_insert0" % i,
               bytes(b"ACGT"[c] for c in rng.integers(0, 4, 100)), b"F" * 100)
              for i in range(40)]
    write_reads(str(tmp / "r.fq"), reads)
    return tmp


@pytest.mark.parametrize("flags", [[], ["fused=f"]], ids=["fused", "staged"])
def test_bbmap_bloomfilter_equals_jax(bloom_data, flags):
    from bbtools_torch.models import bbmap as tbbmap

    files = {}
    for pkg in ("jax", "torch"):
        out = bloom_data / f"{pkg}{len(flags)}.sam"
        argv = [f"ref={bloom_data / 'ref.fa'}", f"in={bloom_data / 'r.fq'}", f"out={out}",
                "bloomfilter=t", "batchreads=64", *flags]
        if pkg == "jax":
            jmain(["bbmap", *argv])
        else:
            tool = tbbmap.main([*argv, "device=cpu"])
        files[pkg] = out.read_bytes()
    want = files["jax"]
    assert want.count(b"bbtools_tpu") == 2  # @PG ID and PN
    assert files["torch"] == want.replace(b"bbtools_tpu", b"bbtools_torch")
    assert tool.prescreened >= 40
    assert tool.reads_mapped >= 58 and tool.reads_in == 100
