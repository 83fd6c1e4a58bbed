"""The port's last host copies against the JAX package's, on the CPU:
2-bit packing (`ops/encode.py` `pack_bases_np`, and `unpack_bases` as
torch ops against `unpack_bases_jnp`), run metadata (`utils/metadata.py`
`write_metadata`, equal but for the host, time and program fields) and
icecream's per-read host check (`check_read`, `_finish_read`)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbtools_torch.models import icecream as tic
from bbtools_torch.ops import encode as tenc
from bbtools_torch.utils import metadata as tmeta
from bbtools_tpu.models import icecream as jic
from bbtools_tpu.ops import encode as jenc
from bbtools_tpu.utils import metadata as jmeta


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (16, 151), (3, 64), (2, 8)])
def test_pack_and_unpack_equal_jax(shape):
    rng = np.random.default_rng(shape[1])
    codes = rng.integers(0, 4, shape).astype(np.uint8)
    codes[rng.random(shape) < 0.1] = 4
    packed, nmask = tenc.pack_bases_np(codes)
    jpacked, jnmask = jenc.pack_bases_np(codes)
    np.testing.assert_array_equal(packed, jpacked)
    np.testing.assert_array_equal(nmask, jnmask)
    got = tenc.unpack_bases(torch.from_numpy(packed), torch.from_numpy(nmask), shape[1])
    want = np.asarray(jenc.unpack_bases_jnp(jnp.asarray(jpacked), jnp.asarray(jnmask),
                                            shape[1]))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.minimum(codes, 4))


@pytest.mark.parametrize("name", ["run.tsv", "run.json"])
def test_write_metadata_equals_jax(tmp_path, name):
    kw = dict(reads_in=1000, bases_in=151_000, reads_out=990, bases_out=140_000)
    got = tmeta.write_metadata(str(tmp_path / f"t.{name}"), **kw)
    want = jmeta.write_metadata(str(tmp_path / f"j.{name}"), **kw)
    assert got["program"] == "bbtools_torch" and want["program"] == "bbtools_tpu"
    masked = ("host", "time", "program")
    assert {k: v for k, v in got.items() if k not in masked} == \
        {k: v for k, v in want.items() if k not in masked}
    texts = []
    for side in "tj":
        text = (tmp_path / f"{side}.{name}").read_text()
        fields = json.loads(text) if name.endswith(".json") else dict(
            line.split("\t", 1) for line in text.splitlines())
        assert list(fields) == list(got)
        for k in masked:
            text = text.replace(str(fields[k]), k.upper())
        texts.append(text)
    assert texts[0] == texts[1]


def test_check_read_equals_jax_and_check_batch():
    """Inverted repeats at and off mid-read in every other read of 250-
    420 bp, one read too short to check: the per-read host check of both
    packages and the port's batched check give the same verdicts."""
    rng = np.random.default_rng(33)
    reads = []
    for i in range(8):
        n = int(rng.integers(250, 420))
        r = rng.integers(0, 4, n).astype(np.uint8)
        if i % 2 == 0:
            half = n // 2 + (i % 5 - 2) * 15
            r[half:] = np.where(r[: n - half] < 4, 3 - r[: n - half], 4)[::-1]
        reads.append(r)
    reads.append(rng.integers(0, 4, 200).astype(np.uint8))
    got = [tic.check_read(r, tic.ICConfig(device="cpu")) for r in reads]
    assert got == [jic.check_read(r, jic.ICConfig()) for r in reads]
    assert got == tic.check_batch(reads, tic.ICConfig(device="cpu"))
    assert any(v[0] for v in got) and not got[-1][0]
