"""The port's Tadpole against the JAX package's on the CPU, on the cases
of tests/test_tadpole.py: shave/rinse before the contig walk, and the
read modes, `mode=extend` (el=/er=) and `mode=correct`. `python -m
bbtools_torch tadpole ... device=cpu` writes files byte-equal to
`python -m bbtools_tpu tadpole ...`."""

import numpy as np
import pytest

from bbtools_tpu.io.fasta import load_reference, write_fasta
from bbtools_tpu.utils.synth import random_genome

from test_torch_tadpole import ACGT, run_both


def _hair_reads(tmp_path):
    """test_shave_removes_hair: 10x backbone plus one diverging read."""
    rng = np.random.default_rng(61)
    genome = ACGT[rng.integers(0, 4, 3000)].tobytes()
    reads = [genome[i : i + 100] for i in range(0, 2900, 10) for _ in range(10)]
    reads.append(genome[1500:1550] + ACGT[rng.integers(0, 4, 50)].tobytes())
    with open(tmp_path / "r.fq", "wb") as f:
        for i, r in enumerate(reads):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)))
    return str(tmp_path / "r.fq")


@pytest.mark.parametrize("flags", [[], ["shave=t"], ["rinse=t"],
                                   ["shave=t", "rinse=t", "shavedepth=2"]])
def test_shave_rinse_equal_jax(tmp_path, flags):
    fq = _hair_reads(tmp_path)
    tool, _, _ = run_both(tmp_path, "hair", [f"in={fq}", "k=31", "mincount=1", *flags])
    if "shave=t" in flags:
        assert max(len(c) for c in tool.contigs) >= 2900


def test_mode_extend_equal_jax(tmp_path):
    """test_mode_extend: er=50 el=20 through the k-mer graph."""
    rng = np.random.default_rng(77)
    genome = ACGT[rng.integers(0, 4, 2000)].tobytes()
    with open(tmp_path / "r.fq", "wb") as f:
        for i in range(0, 1900, 8):
            r = genome[i : i + 80]
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)))
    _, _, out = run_both(tmp_path, "ext", [f"in={tmp_path / 'r.fq'}", "k=31",
                                           "mincount=1", "er=50", "el=20"], "fq")
    seqs = out.splitlines()[1::4]
    assert len(seqs[len(seqs) // 2]) == 150


def test_mode_correct_equal_jax(tmp_path):
    """test_ecc_corrects_substitutions at half its size: 300 reads of a
    4 kb genome, a fifth of them with one substitution mid-read."""
    from bbtools_tpu.core.dna import CODE_TO_BASE

    write_fasta(str(tmp_path / "g.fa"), random_genome(4_000, n_scaffolds=1, seed=21))
    codes = load_reference(str(tmp_path / "g.fa")).scaffold_codes(0)
    rng = np.random.default_rng(3)
    with open(tmp_path / "in.fq", "wb") as fh:
        for i in range(300):
            s0 = int(rng.integers(0, len(codes) - 110))
            r = codes[s0 : s0 + 100].copy()
            if i % 5 == 0:
                p = int(rng.integers(40, 60))
                r[p] = (r[p] + 1) % 4
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, CODE_TO_BASE[np.minimum(r, 4)].tobytes(),
                                             b"F" * 100))
    tool, jtool, _ = run_both(tmp_path, "ecc", [f"in={tmp_path / 'in.fq'}", "mode=correct",
                                                "k=31"], "fq")
    assert tool.errors_corrected == jtool.errors_corrected >= 0.7 * 60
    assert tool.ecc.stats == jtool.ecc.stats
