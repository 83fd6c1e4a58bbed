"""The (dp, tp) device mesh of the port.

The counterpart of bbtools_tpu/parallel/mesh.py. The reference's
parallelism maps onto two mesh axes:

  dp — read-batch data parallelism: a batch's rows cut into slabs, one
       per row of the mesh, and the per-slab outputs concatenated in slab
       order (per-slab counts summed);
  tp — hash-shard parallelism: the k-mer table's leading axis cut by
       `key % tp` (kmer/KmerTableSet.java:273), each shard looked up on
       its own device and the partial results combined on the dp row's
       first device (a miss contributes 0 and exactly one shard can hit,
       so the sum is the select).

A mesh is a grid of torch devices. JAX's `shard_map` becomes plain
functions (parallel/sharded_*.py) that cut tensors into per-device slabs,
launch every slab, and only then combine; CUDA launches are asynchronous,
so slabs on different cards overlap. A device may repeat (`[cuda:0] * 4`,
or N copies of the CPU), the counterpart of the JAX tests' virtual CPU
devices: outputs are the same bytes, and the work runs one slab after
another.
"""

from __future__ import annotations

import numpy as np
import torch

#: the devices of a `device=cpu` mesh: the JAX package's tests run on this
#: many virtual CPU devices (tests/conftest.py), so `tpshards=N
#: device=cpu` takes the meshes that `tpshards=N` takes there
CPU_DEVICES = 8


class Mesh:
    """A (dp, tp) grid of torch devices: `devices` is a numpy object array
    of shape (dp, tp), `shape` the axis sizes by name."""

    def __init__(self, devices):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2:
            raise ValueError(f"a mesh is a (dp, tp) grid, not {self.devices.shape}")
        self.shape = {"dp": self.devices.shape[0], "tp": self.devices.shape[1]}

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.ravel()]})"

    def row(self, d: int):
        """The dp row's first device: where its slab lives and its tp
        shards combine."""
        return self.devices[d, 0]


def local_devices(device) -> list:
    """The devices a tool's mesh may span in this process: cuda:0..N-1 of
    the N cards torch sees for a CUDA device, CPU_DEVICES copies of the
    CPU for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * CPU_DEVICES


def make_mesh(n_dp: int | None = None, n_tp: int = 1, devices=None) -> Mesh:
    """Build a (dp, tp) mesh. Defaults to all of `devices` (CPU_DEVICES
    copies of the CPU when none are given) on the dp axis."""
    devices = list(devices) if devices is not None else local_devices("cpu")
    n = len(devices)
    if n_dp is None:
        n_dp = n // n_tp
    if n_dp * n_tp != n:
        raise ValueError(f"{n_dp}x{n_tp} mesh does not cover {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(n_dp, n_tp))


def slabs(n: int, parts: int) -> list[slice]:
    """The `parts` equal row slabs of n rows (n divides by parts; callers
    pad first)."""
    if n % parts:
        raise ValueError(f"{n} rows do not cut into {parts} equal slabs")
    step = n // parts
    return [slice(i * step, (i + 1) * step) for i in range(parts)]
