"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked `cuda`: they skip where torch finds no CUDA device, and run
on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from bbtools_torch.ops import lane_index, scan

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _lane_tables(rng, n, hi_bits):
    top = 62 if hi_bits else 44
    keys = np.unique(
        rng.integers(0, 1 << top, 4 * n, dtype=np.int64) | (np.int64(1) << top)
    )[:n]
    lo = 1 << 17 if hi_bits else 1
    ids = rng.integers(lo, lo + 1000, len(keys), dtype=np.int32)
    idx = lane_index.LaneKmerIndex.build(keys, ids)
    assert idx is not None and idx.packed == (not hi_bits)
    return keys, idx


@pytest.mark.parametrize("hi_bits", [False, True])
@pytest.mark.parametrize("shape", [(0,), (1,), (3, 1001), (16384, 151)])
def test_lane_kernel_matches_plain(cuda, hi_bits, shape):
    rng = np.random.default_rng(len(shape) + hi_bits)
    keys, idx = _lane_tables(rng, 3000, hi_bits)
    n = int(np.prod(shape))
    q = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    q[::3] = keys[rng.integers(0, len(keys), len(q[::3]))]
    q = torch.from_numpy(q.reshape(shape)).to(cuda)
    args = (*idx.device_arrays(cuda), *idx.static_params())
    before = lane_index.lane_lookup.launches
    got = lane_index.lane_lookup(*args, q)
    want = lane_index.lookup_plain(*args, q)
    assert torch.equal(got, want)
    assert lane_index.lane_lookup.launches == before + (n > 0)
    np.testing.assert_array_equal(got.cpu().numpy(), idx.lookup_np(q.cpu().numpy()))


@pytest.mark.parametrize("n", [0, 1, 31, 4095, 4096, 4097, (1 << 20) + 3, 5_000_000])
def test_cummax_kernel_matches_plain(cuda, n):
    gen = torch.Generator().manual_seed(n)
    v = torch.randint(-(2**63), 2**63 - 1, (n,), generator=gen, dtype=torch.int64)
    v[::7] = -(2**63)
    v = v.to(cuda)
    before = scan.cummax_i64.launches
    got = scan.cummax_i64(v)
    assert torch.equal(got, scan.cummax_plain(v))
    assert scan.cummax_i64.launches == before + (n > 0)


def test_cummax_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError):
        scan.cummax_i64(torch.zeros(8, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        scan.cummax_i64(torch.zeros((4, 4), dtype=torch.int64, device=cuda))


@pytest.mark.parametrize("panel", ["ref=adapters", "literal=AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"])
def test_bbduk_cuda_equals_cpu(cuda, tmp_path, panel):
    from bbtools_torch.cli import main

    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    adapter = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    with open(tmp_path / "in.fq", "wb") as fh:
        for i in range(3000):
            L = int(rng.integers(40, 152))
            seq = acgt[rng.integers(0, 5 if i % 9 == 0 else 4, L)].copy()
            if i % 2 == 0:
                p = int(rng.integers(0, L))
                seq[p:] = np.frombuffer((adapter * 5)[: L - p], np.uint8)
            q = (33 + rng.integers(2, 41, L)).astype(np.uint8)
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), q.tobytes()))
    outs = {}
    for dev in ("cuda", "cpu"):
        out, st = tmp_path / f"{dev}.fq", tmp_path / f"{dev}.txt"
        main(["bbduk", f"in={tmp_path / 'in.fq'}", f"out={out}", f"stats={st}",
              panel, "k=23", "mink=11", "hdist=1", "ktrim=r", "minlen=40",
              f"device={dev}"])
        outs[dev] = (out.read_bytes(), st.read_bytes())
    assert outs["cuda"] == outs["cpu"]
