"""Several processes, one answer: the join and the global merges.

The counterpart of bbtools_tpu/parallel/distributed.py. Each process runs
the same tool on its own input shard (per-host FASTQ shards feed each
process's own devices, so reads never cross processes); `initialize`
joins them into one `torch.distributed` process group, and the tools
merge what must be global: BBDuk's stats vectors (`global_sum_array`),
kmercountexact's spectrum (`global_spectrum`). What crosses processes is
small host data, so the group runs gloo on CPU tensors; each merge then
runs on the process's own device. gloo takes two ranks on one card, or
on the CPU, where NCCL refuses two ranks on one device.

The JAX package's variables map onto `torchrun`'s:

  JAX_COORDINATOR=host:port -> MASTER_ADDR=host, MASTER_PORT=port
  JAX_NUM_PROCESSES=n       -> WORLD_SIZE=n
  JAX_PROCESS_ID=i          -> RANK=i

A tool's `tpshards=` mesh spans the devices of its own process; a mesh
across processes is not built here.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops.kmer_count import PAD, _boundaries, _compact


def initialize() -> bool:
    """Join the process group that MASTER_ADDR, MASTER_PORT, WORLD_SIZE
    and RANK describe (init_method="env://", gloo). Returns True if this
    process is in a group of more than one, False when WORLD_SIZE is
    unset or 1. Joining twice is a no-op."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method="env://")
    return True


def world_size() -> int:
    """The processes of the group, 1 outside one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 outside a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def global_sum_array(vec) -> np.ndarray:
    """Sum an integer vector over all processes (all_reduce SUM of an
    int64 CPU tensor). Every process returns the same global vector; one
    process returns it unchanged."""
    v = np.asarray(vec, np.int64)
    if world_size() == 1:
        return v
    t = torch.from_numpy(v.copy())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


def merge(keys, *payloads):
    """Sort-reduce of a flat int64 key tensor and payload tensors of the
    same length: (sorted keys, each payload's per-run sums front-compacted
    in run order with zeros after the last run, the bool boundary that
    marks each run's first key). With one payload this is the spectrum
    merge; with more, every counter summed per key (VarMap's merge,
    var2/VarMap.java:278-298). Runs on the tensors' device, with no
    scatter of duplicate indices (ops/kmer_count.py `_compact`)."""
    ks, order = torch.sort(keys.reshape(-1), stable=True)
    boundary = torch.cat([torch.ones(1, dtype=torch.bool, device=ks.device),
                          ks[1:] != ks[:-1]])
    tots = []
    for p in payloads:
        c = p.reshape(-1)[order]
        tots.append(_compact(ks, boundary, torch.cumsum(c, 0) - c, c.sum())[1])
    return (ks, *tots, boundary)


def global_spectrum(keys, counts, device="cpu"):
    """Merge the processes' (k-mer, count) spectra into one global
    spectrum, the same on every process: all_gather of the sizes, then of
    the keys and counts padded to the largest (PAD keys, count 0), and
    one sort-reduce on `device`. One process returns its own."""
    keys = np.asarray(keys, np.int64)
    counts = np.asarray(counts, np.int64)
    n = world_size()
    if n == 1:
        return keys, counts
    size = torch.tensor([len(keys)], dtype=torch.int64)
    sizes = [torch.zeros_like(size) for _ in range(n)]
    dist.all_gather(sizes, size)
    cap = max(1, max(int(s) for s in sizes))
    pk = torch.full((cap,), int(PAD), dtype=torch.int64)
    pc = torch.zeros(cap, dtype=torch.int64)
    pk[: len(keys)] = torch.from_numpy(keys)
    pc[: len(counts)] = torch.from_numpy(counts)
    gk = [torch.empty_like(pk) for _ in range(n)]
    gc = [torch.empty_like(pc) for _ in range(n)]
    dist.all_gather(gk, pk)
    dist.all_gather(gc, pc)
    ks, tot, _ = merge(torch.cat(gk).to(device), torch.cat(gc).to(device))
    live, _ = _boundaries(ks)
    n_runs = int(live.sum())
    return ks[live].cpu().numpy(), tot[:n_runs].cpu().numpy()
