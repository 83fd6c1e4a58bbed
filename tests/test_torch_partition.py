"""partition and partitionreads (scalar/PartitionReads) on the CPU after
ROADMAP C7: FASTQ input is dealt round-robin into `ways=` files byte for
byte as the JAX package deals it; FASTA input, which the JAX package
reads as FASTQ (its quality bytes unset), is dealt as FASTA records,
the same bytes on every run, each output the input records
round-robin, wrapped as write_fasta wraps them."""

import gzip

import numpy as np
import pytest

from bbtools_torch.cli import main as tmain
from bbtools_torch.io.fasta import iter_fasta
from bbtools_tpu.cli import main as jmain
from bbtools_tpu.io.fasta import write_fasta
from torch_parity import capture, warm_native_codecs  # noqa: F401  (autouse)

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """FASTQ and FASTA inputs made once from seed 7."""
    d = tmp_path_factory.mktemp("partition_in")
    rng = np.random.default_rng(7)
    seqs = [ACGT[rng.integers(0, 4, int(rng.integers(1, 240)))].tobytes() for _ in range(61)]
    seqs[5] = b""
    seqs[9] = seqs[9][:3] + b"NNNN" + seqs[9][3:]
    fq = b"".join(b"@r%d desc %d\n%s\n+\n%s\n" % (i, i, s, bytes(33 + rng.integers(2, 41, len(s))
                                                               .astype(np.uint8)))
                  for i, s in enumerate(seqs) if s)
    (d / "r.fq").write_bytes(fq)
    with gzip.open(d / "r.fq.gz", "wb") as fh:
        fh.write(fq)
    fa = b"".join(b">s%d some text\n%s\n" % (i, s) for i, s in enumerate(seqs))
    (d / "r.fa").write_bytes(fa)
    # the same records wrapped at 60 columns, gzipped
    wrapped = b"".join(b">s%d some text\n%s" % (i, b"".join(s[j:j + 60] + b"\n"
                                                             for j in range(0, len(s), 60)))
                       for i, s in enumerate(seqs))
    with gzip.open(d / "w.fa.gz", "wb") as fh:
        fh.write(wrapped)
    return d


@pytest.mark.parametrize("tool,src,ways", [("partition", "r.fq", 3),
                                           ("partitionreads", "r.fq.gz", 4),
                                           ("partition", "r.fq", 1)])
def test_fastq_partition_equals_jax(inputs, tmp_path, tool, src, ways):
    got = {}
    for d, cli in (("jax", jmain), ("torch", tmain)):
        (tmp_path / d).mkdir()
        err = capture(cli, [tool, f"in={inputs / src}", f"out={tmp_path / d}/p_%.fq",
                            f"ways={ways}"])[1]
        got[d] = (err, [(tmp_path / d / f"p_{w}.fq").read_bytes() for w in range(ways)])
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "Partitioned 60 reads %d ways\n" % ways


@pytest.mark.parametrize("tool,src,ways", [("partition", "r.fa", 3),
                                           ("partitionreads", "w.fa.gz", 2),
                                           ("partition", "r.fa", 7)])
def test_fasta_partition_deals_records_round_robin(inputs, tmp_path, tool, src, ways):
    """Two runs give the same bytes, and output w holds records w, w +
    ways, ... of the input as FASTA."""
    runs = []
    for run in range(2):
        out = tmp_path / str(run)
        out.mkdir()
        err = capture(tmain, [tool, f"in={inputs / src}", f"out={out}/p_%.fa", f"ways={ways}"])[1]
        assert err == "Partitioned 61 reads %d ways\n" % ways
        runs.append([(out / f"p_{w}.fa").read_bytes() for w in range(ways)])
    assert runs[0] == runs[1]
    recs = [(r.name, r.seq) for r in iter_fasta(str(inputs / src))]
    assert len(recs) == 61
    for w in range(ways):
        write_fasta(str(tmp_path / f"want_{w}.fa"), recs[w::ways])
        assert runs[0][w] == (tmp_path / f"want_{w}.fa").read_bytes()
        assert [(r.name, r.seq) for r in iter_fasta(str(tmp_path / "0" / f"p_{w}.fa"))] \
            == recs[w::ways]
