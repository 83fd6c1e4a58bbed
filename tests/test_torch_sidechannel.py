"""The port's phiX side channel against the JAX package's on the CPU: the
micro-aligner's two batch functions array for array (ops/microalign.py),
and BBDuk's `align=t alignout=` writing the JAX package's FASTQ and side
SAM byte for byte, but for the program name of the SAM's @PG line."""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest

from bbtools_torch.cli import main as torch_main
from bbtools_tpu.cli import main as jax_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHIX = os.path.join(REPO, "bbtools_tpu", "resources", "phix2.fa.gz")


def phix_codes():
    from bbtools_tpu.core.dna import encode

    with gzip.open(PHIX, "rb") as fh:
        lines = fh.read().splitlines()
    return encode(b"".join(ln.strip() for ln in lines if not ln.startswith(b">")))


def micro_reads(ref, rng, n=96, L=120):
    """Reads from the reference (either strand, a few substitutions and
    Ns), reads hanging off its start and its end, random reads and reads
    shorter than the padded width: codes uint8 [n, L], lengths int32."""
    G = len(ref)
    bases = np.full((n, L), 4, np.uint8)
    lengths = rng.integers(40, L + 1, n).astype(np.int32)
    for i in range(n):
        ln = int(lengths[i])
        kind = i % 6
        if kind == 0:  # off the start
            cut = int(rng.integers(5, ln // 2))
            read = np.concatenate([rng.integers(0, 4, cut), ref[: ln - cut]])
        elif kind == 1:  # off the end
            cut = int(rng.integers(5, ln // 2))
            read = np.concatenate([ref[G - (ln - cut):], rng.integers(0, 4, cut)])
        elif kind == 2:  # random
            read = rng.integers(0, 4, ln)
        else:
            p = int(rng.integers(0, G - ln))
            read = ref[p : p + ln].copy()
            sub = rng.integers(0, ln, int(rng.integers(0, 6)))
            read[sub] = (read[sub] + 1) % 4
            if kind == 4:
                read[int(rng.integers(0, ln))] = 4
        read = np.asarray(read, np.uint8)
        if i % 2:
            read = np.where(read < 4, 3 - read, 4)[::-1]
        bases[i, :ln] = read
    return bases, lengths


@pytest.mark.parametrize("k,mm,minid", [(17, 1, 0.66), (13, 0, 0.56)])
def test_micro_map_and_quick_align_equal_jax(k, mm, minid):
    """micro_map_batch and quick_align_batch on the k1 and the k2 index of
    the side channel: every array equal to the JAX package's, for every
    read, those without a hit too."""
    import torch

    from bbtools_torch.ops import microalign as tm
    from bbtools_tpu.ops import microalign as jm

    ref = phix_codes()
    bases, lengths = micro_reads(ref, np.random.default_rng(k))
    jidx = jm.MicroIndex.build(ref, k, mm, minid)
    tidx = tm.MicroIndex.build(ref, k, mm, minid)
    assert tidx.cfg == tm.MicroCfg(**vars(jidx.cfg))
    kt, it, rd = jidx.device_tables()
    jhit, joff, jst = jm.micro_map_batch(jidx.cfg, kt, it, jnp.asarray(bases),
                                         jnp.asarray(lengths))
    jqa = jm.quick_align_batch(jidx.cfg, rd, jnp.asarray(bases), jnp.asarray(lengths),
                               joff, jst)
    tkt, tit, trd = tidx.device_tables("cpu")
    tb, tl = torch.from_numpy(bases), torch.from_numpy(lengths)
    thit, toff, tst = tm.micro_map_batch(tidx.cfg, tkt, tit, tb, tl)
    tqa = tm.quick_align_batch(tidx.cfg, trd, tb, tl, toff, tst)
    for j, t in ((jhit, thit), (joff, toff), (jst, tst)):
        assert t.numpy().dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert set(tqa) == set(jqa)
    for key in jqa:
        assert tqa[key].numpy().dtype == np.asarray(jqa[key]).dtype, key
        np.testing.assert_array_equal(tqa[key].numpy(), np.asarray(jqa[key]), key)
    hit = thit.numpy()
    # reads on both strands and off both ends of the reference hit
    assert hit[3::6].mean() > 0.8 and hit[::6].any() and hit[1::6].any()
    assert (tqa["clip"].numpy()[hit] > 0).any()
    assert not hit[2::6].any()


def side_reads(path, n=2000, seed=11, paired=False):
    """n reads of 100 bp (pairs with paired=True), one in ten from phiX
    (either strand, one substitution), the rest random; returns the
    number of phiX reads (pairs)."""
    rng = np.random.default_rng(seed)
    ref = phix_codes()
    code_base = np.frombuffer(b"ACGTN", np.uint8)
    recs = ([], [])
    n_phix = 0
    for i in range(n):
        mates = []
        phix = i % 10 == 0
        n_phix += phix
        p = int(rng.integers(0, len(ref) - 400))
        for m in range(2 if paired else 1):
            if phix:
                read = ref[p + 250 * m : p + 250 * m + 100].copy()
                read[10] = (read[10] + 1) % 4
                if (i // 10 + m) % 2:
                    read = (3 - read)[::-1]
            else:
                read = rng.integers(0, 4, 100)
            mates.append(code_base[read].tobytes())
        for m, seq in enumerate(mates):
            recs[m].append(b"@r%d/%d\n%s\n+\n%s\n" % (i, m + 1, seq, b"F" * 100))
    paths = []
    for m in range(2 if paired else 1):
        fq = path / f"in{m + 1}.fq"
        fq.write_bytes(b"".join(recs[m]))
        paths.append(fq)
    return paths, n_phix


@pytest.mark.parametrize("paired", [False, True])
def test_bbduk_align_equals_jax(tmp_path, paired):
    """tests/test_bbduk.py's side-channel case at 2,000 reads (or pairs):
    align=t maps the planted phiX reads to the bundled phix2 reference,
    writes them to alignout= and keeps every read in out=; the FASTQ, the
    side SAM and the summary line equal the JAX package's."""
    import contextlib
    import io

    fqs, n_phix = side_reads(tmp_path, paired=paired)
    outs = {}
    for pkg, run in (("jax", jax_main), ("torch", torch_main)):
        argv = ["bbduk", f"in={fqs[0]}", f"out={tmp_path / f'{pkg}.1.fq'}",
                "align=t", f"alignout={tmp_path / f'{pkg}.side.sam'}", "k=27",
                "literal=ACGTACGTACGTACGTACGTACGTACGTAC"]
        if paired:
            argv += [f"in2={fqs[1]}", f"out2={tmp_path / f'{pkg}.2.fq'}"]
        if pkg == "torch":
            argv.append("device=cpu")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            run(argv)
        side = [ln for ln in err.getvalue().splitlines() if ln.startswith("Aligned reads")]
        files = [tmp_path / f"{pkg}.{x}" for x in ("1.fq", "side.sam")]
        if paired:
            files.append(tmp_path / f"{pkg}.2.fq")
        outs[pkg] = ([f.read_bytes() for f in files], side)
    (jfiles, jside), (tfiles, tside) = outs["jax"], outs["torch"]
    assert jfiles[1].count(b"bbtools_tpu-side") == 2
    jfiles[1] = jfiles[1].replace(b"bbtools_tpu-side", b"bbtools_torch-side")
    assert tfiles == jfiles and tside == jside and len(tside) == 1
    assert tfiles[0].count(b"\n") == 4 * 2000  # every read kept
    recs = [ln.split(b"\t") for ln in tfiles[1].splitlines() if not ln.startswith(b"@")]
    mapped = [r for r in recs if not int(r[1]) & 4]
    planted = [r for r in mapped if int(r[0][1:].split(b"/")[0]) % 10 == 0]
    assert len(planted) == n_phix * (2 if paired else 1)
    assert all(r[2] == b"phiX174" and r[5] != b"*" for r in mapped)
    if paired:
        # read 2 maps with the k2 index (k=13, minid 0.56), whose glocal
        # fallback places a few random reads
        assert len(mapped) - len(planted) <= 0.02 * len(planted)
        assert sum(int(r[1]) & 2 != 0 for r in planted) >= len(planted) * 0.9
    else:
        assert len(mapped) == len(planted)
