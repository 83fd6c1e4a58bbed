"""The port's LogLog (`models/loglog.py`) against the JAX package's on
the CPU: the bucket maxima identical batch for batch, the same
cardinality through `python -m bbtools_torch loglog ... device=cpu` as
through `python -m bbtools_tpu loglog`, and the rank (trailing zeros on
int64 bits) equal to the JAX package's bit loop on hashes past the sign
bit."""

import contextlib
import io

import numpy as np
import pytest
import torch

from bbtools_torch.cli import main as tmain
from bbtools_torch.models import loglog as tll
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.io.fasta import load_reference, write_fasta
from bbtools_tpu.models import loglog as jll
from bbtools_tpu.utils.synth import random_genome, random_reads, write_reads


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """tests/test_tools.py's data: 500 reads of 100 bp, 1% SNPs, of a
    30 kb genome in two scaffolds."""
    tmp = tmp_path_factory.mktemp("loglog")
    write_fasta(str(tmp / "ref.fa"), random_genome(30_000, n_scaffolds=2, seed=13))
    ref = load_reference(str(tmp / "ref.fa"))
    write_reads(str(tmp / "reads.fq"),
                random_reads(ref, 500, read_len=100, snp_rate=0.01, seed=14))
    return str(tmp / "reads.fq")


def _quiet(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(argv)
    return res, out.getvalue()


@pytest.mark.parametrize("flags", [["k=31"], ["k=21", "buckets=256"], ["k=25", "buckets=16384"]])
def test_loglog_cli_equals_jax(reads, flags):
    got, got_out = _quiet(tmain, ["loglog", f"in={reads}", *flags, "device=cpu"])
    want, want_out = _quiet(jmain, ["loglog", f"in={reads}", *flags])
    assert got_out == want_out and got == 0 == want
    if flags == ["k=31"]:
        card = int(got_out.split()[-1])
        assert 15_000 < card < 80_000  # the reference test's band


def test_loglog_maxima_equal_jax(reads):
    """Batch for batch: the file's batch, then its rows reversed, then
    the first half (bases and lengths as numpy arrays, as the CLI passes
    them)."""
    from bbtools_tpu.io.stream import read_batches

    b = next(iter(read_batches(reads)))
    t = tll.LogLog(buckets=1024, k=31, device="cpu")
    j = jll.LogLog(buckets=1024, k=31)
    half = b.bases[:250].copy()
    half[:, 50:] = 4  # windows cut short by N
    for bases, lengths in ((b.bases, b.lengths), (b.bases[::-1].copy(), b.lengths[::-1].copy()),
                           (np.concatenate([half, half]), b.lengths)):
        t.add_batch(bases, lengths)
        j.add_batch(bases, lengths)
        np.testing.assert_array_equal(t.maxima.numpy(), j.maxima)
    assert t.maxima.dtype == torch.int64 and t.cardinality() == j.cardinality()
    assert tll.loglog_update.device_calls == 0


@pytest.mark.parametrize("p", [1, 4, 11, 20])
def test_rank_equals_the_bit_loop(p):
    rng = np.random.default_rng(p)
    keys = rng.integers(-(1 << 63), (1 << 63) - 1, 5000, dtype=np.int64)
    keys[:4] = [0, 1, -1, 1 << 40]
    m = 1 << p
    t = torch.zeros(m, dtype=torch.int64)
    tll.loglog_update(t, torch.from_numpy(keys), p)
    j = jll.LogLog(buckets=m)
    j.hash_kmers(keys)
    np.testing.assert_array_equal(t.numpy(), j.maxima)
    # hashes whose top 64-p bits are 0 rank 64-p+1; the low bit set ranks 1
    h = torch.tensor([0, 5 << p, (1 << p) - 1, 1 << 62, -(1 << 63)], dtype=torch.int64)
    np.testing.assert_array_equal(
        tll.loglog_rank(h, p).numpy(), [65 - p, 1, 65 - p, 63 - p, 64 - p])
