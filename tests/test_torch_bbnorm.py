"""The port's BBNorm and ecc (`models/bbnorm.py`, `models/kmernorm_ecc.py`)
against the JAX package's on the CPU: `python -m bbtools_torch bbnorm`
and `ecc` with device=cpu write the same kept and tossed reads and
return the same counts as `python -m bbtools_tpu`, in
tests/test_tools.py's normalization case (with outt=, passes=2, other
percentiles) and tests/test_ecc.py's planted-error case (bbnorm ecc=t
keepall=t, and the ecc tool); `read_depths`' row sort on the device
picks the JAX package's percentile element."""

import contextlib
import io

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as tmain
from bbtools_torch.models import bbnorm as tnorm
from bbtools_torch.ops.cms import CountMinSketch as TCMS, cms_add
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.core.dna import CODE_TO_BASE
from bbtools_tpu.io.fasta import load_reference, write_fasta
from bbtools_tpu.models import bbnorm as jnorm
from bbtools_tpu.ops.cms import CountMinSketch as JCMS
from bbtools_tpu.utils.synth import random_genome, random_reads, write_reads


def _both(tmp, tool, argv, outs):
    """Run argv through both packages (outputs named {d}); compare the
    returns and every output file's bytes; return the torch files."""
    res = {}
    for d, fn, extra in (("jax", jmain, []), ("torch", tmain, ["device=cpu"])):
        with contextlib.redirect_stderr(io.StringIO()):
            fn([tool, *[x.format(d=d) for x in argv], *extra])
        res[d] = [(tmp / o.format(d=d)).read_bytes() for o in outs]
    assert res["jax"] == res["torch"]
    return res["torch"]


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """tests/test_tools.py's bbnorm input: 3,000 reads of 100 bp of a
    30 kb genome (~10x)."""
    tmp = tmp_path_factory.mktemp("bbnorm")
    write_fasta(str(tmp / "ref.fa"), random_genome(30_000, n_scaffolds=2, seed=13))
    ref = load_reference(str(tmp / "ref.fa"))
    write_reads(str(tmp / "deep.fq"),
                random_reads(ref, 3000, read_len=100, snp_rate=0.0, seed=77))
    return tmp


@pytest.mark.parametrize("flags", [
    ["target=5", "mindepth=1", "k=31"],
    ["target=4", "mindepth=3", "k=25", "dp=0.3", "seed=9"],
    ["target=5", "mindepth=1", "k=31", "passes=2"],
])
def test_bbnorm_equals_jax(deep, flags):
    files = _both(deep, "bbnorm", [f"in={deep}/deep.fq", f"out={deep}/n.{{d}}.fq",
                                   f"outt={deep}/t.{{d}}.fq", *flags],
                  ["n.{d}.fq", "t.{d}.fq"])
    kept = files[0].count(b"\n") // 4
    assert 200 < kept < 3000  # downsampled (the reference test's band)
    assert kept + files[1].count(b"\n") // 4 == 3000


def _planted_error_reads(n=900, L=100, glen=1500, err_every=4, seed=3):
    """tests/test_ecc.py's input: deep reads of a random genome, every
    err_every-th with one substitution at a known position."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, glen).astype(np.uint8)
    reads = []
    for i in range(n):
        p = int(rng.integers(0, glen - L))
        codes = genome[p : p + L].copy()
        if i % err_every == 0:
            ep = int(rng.integers(10, L - 10))
            codes[ep] = (codes[ep] + 1 + int(rng.integers(3))) % 4
        reads.append(codes)
    return reads


@pytest.mark.parametrize("tool,flags", [("bbnorm", ["ecc=t", "keepall=t", "k=25"]),
                                        ("ecc", ["k=25"])])
def test_ecc_equals_jax(tmp_path, tool, flags):
    with open(tmp_path / "in.fq", "w") as f:
        for i, r in enumerate(_planted_error_reads()):
            s = CODE_TO_BASE[r].tobytes().decode()
            f.write(f"@r{i}\n{s}\n+\n{'D' * len(s)}\n")
    files = _both(tmp_path, tool, [f"in={tmp_path}/in.fq", f"out={tmp_path}/o.{{d}}.fq",
                                   *flags], ["o.{d}.fq"])
    src = (tmp_path / "in.fq").read_bytes()
    assert files[0].count(b"\n") == src.count(b"\n") and files[0] != src  # corrected


def test_read_depths_pick_the_jax_element():
    """Counts with ties, reads with no valid k-mer (N runs, short) and
    every percentile edge."""
    rng = np.random.default_rng(2)
    bases = rng.integers(0, 4, (48, 60)).astype(np.uint8)
    bases[::7, 20:] = 4
    bases[3] = 4
    lengths = rng.integers(20, 61, 48).astype(np.int64)
    t, j = TCMS(1 << 12, 3, device="cpu"), JCMS(1 << 12, 3)
    keys = rng.integers(0, 1 << 30, 4000).astype(np.int64)
    t.add(keys)
    j.add(keys)
    from bbtools_tpu.ops.kmer_count import batch_kmers_jnp

    k = 11
    import jax.numpy as jnp

    kb = np.asarray(batch_kmers_jnp(jnp.asarray(bases), jnp.asarray(lengths), k))
    kb = kb[kb != np.iinfo(np.int64).max]
    t.add(np.repeat(kb, 3))  # so that the reads' own k-mers count
    j.add(np.repeat(kb, 3))
    for pct in (0.0, 0.3, 0.54, 0.999, 1.0):
        got = tnorm.read_depths(t, bases, lengths, k, pct)
        np.testing.assert_array_equal(got, jnorm.read_depths(j, bases, lengths, k, pct))
        assert got.dtype == np.int64 and got[3] == 0
    assert tnorm.read_depths.device_calls == 0 and cms_add.device_calls == 0
