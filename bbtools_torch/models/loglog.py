"""LogLog — streaming distinct-kmer cardinality (cardinality/LogLog16).

The PyTorch port of bbtools_tpu/models/loglog.py, the production-variant
equivalent of cardinality/CardinalityTracker.java:25 (`loglog` flags
across tools): a 64-bit hash per k-mer, bucketed by its low bits,
tracking the max rank of the first set bit above them per bucket;
harmonic-mean HyperLogLog estimate with small/large-range corrections.

On the run's device (`device=`, cuda by default) each batch's k-mers
(`batch_kmers`), their splitmix64 (`mix64_t`, int64 bits), the rank (a
count of trailing zeros by halving, on logical shifts) and the bucket
maxima (`scatter_reduce` amax) stay on the device; the maxima come to
the host once, for the estimate. `hash_kmers` takes keys made on the
host (the cardinality harness's) to the device the same way.
`loglog_update.device_calls` counts batches hashed on CUDA tensors.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..core.parser import tokenize
from ..device import resolve_device
from ..io.stream import read_batches
from ..ops.kmer_count import PAD, batch_keys
from ..ops.kmer_index import _srl, mix64_t


def loglog_rank(h: torch.Tensor, p: int) -> torch.Tensor:
    """1 + the trailing zeros of h's top 64-p bits (64-p+1 where they
    are all 0), int64."""
    rest = _srl(h, p) if p else h
    rank = torch.ones_like(rest)
    zero = rest == 0
    x = rest
    for s in (32, 16, 8, 4, 2, 1):
        low_clear = (x & ((1 << s) - 1)) == 0
        rank += low_clear.to(torch.int64) * s
        x = torch.where(low_clear, _srl(x, s), x)
    return torch.where(zero, 64 - p + 1, rank)


def loglog_update(maxima: torch.Tensor, keys: torch.Tensor, p: int):
    """Raise each bucket's max rank by the int64 keys (in place)."""
    if keys.device.type == "cuda":
        loglog_update.device_calls += 1
    h = mix64_t(keys)
    bucket = h & (maxima.shape[0] - 1)
    maxima.scatter_reduce_(0, bucket, loglog_rank(h, p), reduce="amax")


#: calls on CUDA tensors since the count was last set to 0
loglog_update.device_calls = 0


class LogLog:
    def __init__(self, buckets: int = 2048, k: int = 31,
                 device: str | torch.device = "cuda"):
        assert buckets & (buckets - 1) == 0
        self.p = int(np.log2(buckets))
        self.m = buckets
        self.k = k
        self.device = resolve_device(str(device))
        self.maxima = torch.zeros(buckets, dtype=torch.int64, device=self.device)

    def hash_kmers(self, keys: np.ndarray):
        """Raise the bucket maxima by int64 keys given on the host."""
        if len(keys):
            loglog_update(self.maxima, torch.as_tensor(keys, dtype=torch.int64,
                                                       device=self.device), self.p)

    def add_batch(self, bases, lengths):
        keys = batch_keys(bases, lengths, self.k, self.device)
        keys = keys[keys != int(PAD)]
        if keys.numel():
            loglog_update(self.maxima, keys, self.p)

    def cardinality(self) -> int:
        maxima = self.maxima.cpu().numpy()
        m = self.m
        alpha = 0.7213 / (1 + 1.079 / m)
        est = alpha * m * m / np.sum(2.0 ** -maxima.astype(np.float64))
        zeros = int((maxima == 0).sum())
        if est <= 2.5 * m and zeros > 0:
            est = m * np.log(m / zeros)
        return int(round(est))


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    in1 = a.get("in", "in1")
    k = a.get_int("k", default=31)
    buckets = a.get_int("buckets", default=2048)
    ll = LogLog(buckets=buckets, k=k, device=a.get("device", default="cuda"))
    reader = read_batches(in1)
    for b in reader:
        ll.add_batch(b.bases, b.lengths)
    card = ll.cardinality()
    print(f"Cardinality:         \t{card}")
    return card


if __name__ == "__main__":
    main()
