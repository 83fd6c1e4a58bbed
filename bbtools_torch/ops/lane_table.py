"""Small constant-table lookups: `out = table[idx]` for tables of at most
2,048 entries (the f32 quality and increment tables of BBMerge, whose
values encode sequential-f32 rounding, so no closed form exists).

The counterpart of bbtools_tpu/ops/lane_table.py. There the TPU resolves
the gather with lane-row selects (its kernel `_kernel`); on the GPU the
kernel of csrc/lane_table.cu stages the table in shared memory and moves
the indices and words in 16-byte vectors. `lookup` is the wrapper: a CPU
tensor runs `lookup_plain`, a CUDA tensor launches the kernel, anything
else raises.
Indices outside the table read 0, as the TPU kernel's row select gives.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

LANES = 128
MAX_ENTRIES = 2048


def pack_table(table: np.ndarray):
    """Host-side: pad a 1-D table to [ceil(n/128), 128] for lookup()."""
    table = np.asarray(table)
    n = len(table)
    assert n <= 2048, "lane table capped at 16 rows"
    rows = (n + LANES - 1) // LANES
    out = np.zeros((rows, LANES), table.dtype)
    out.reshape(-1)[:n] = table
    return out


def lookup_plain(table2d, idx):
    """Plain torch version: table2d.reshape(-1)[idx], 0 out of range."""
    flat = table2d.reshape(-1)
    idx = idx.to(torch.int64)
    ok = (idx >= 0) & (idx < flat.numel())
    return torch.where(ok, flat[idx.clamp(0, flat.numel() - 1)],
                       torch.zeros((), dtype=flat.dtype, device=flat.device))


def lookup(table2d, idx):
    """out[...] = table2d.reshape(-1)[idx] for int32 idx of any shape and
    a 32-bit table (f32 or int32) of at most 2,048 entries.

    CPU tensors run `lookup_plain`; CUDA tensors launch the kernel of
    csrc/lane_table.cu, or raise."""
    if idx.device.type == "cpu":
        return lookup_plain(table2d, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"lane_table.lookup: unsupported device {idx.device}")
    out = _launch("lookup", "lane_table", table2d, idx)
    if idx.numel():
        lookup.launches += 1
    return out


#: kernel launches since the count was last set to 0
lookup.launches = 0

#: measurement variants of csrc/lane_table.cu (`lane_table_variant`): the
#: main kernel, and the original one (one 4-byte index per thread per
#: iteration)
VARIANTS = {"main": 0, "scalar": 1}


def lookup_variant(variant: str, table2d, idx):
    """One of VARIANTS on CUDA tensors, for timing beside `lookup`. No
    path of the port calls it, and it does not count in
    `lookup.launches`."""
    if idx.device.type != "cuda":
        raise ValueError(f"lane_table.lookup_variant: needs a CUDA tensor, "
                         f"not {idx.device}")
    return _launch("lookup_variant", "lane_table_variant", table2d, idx,
                   VARIANTS[variant])


def _launch(name: str, entry: str, table2d, idx, *extra):
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"lane_table.{name}: idx must be contiguous int32")
    if (table2d.device != idx.device or table2d.element_size() != 4
            or not table2d.is_contiguous()
            or table2d.numel() > MAX_ENTRIES):
        raise ValueError(
            f"lane_table.{name}: the table must be a contiguous 32-bit "
            f"tensor of at most {MAX_ENTRIES} entries on {idx.device}"
        )
    out = torch.empty(idx.shape, dtype=table2d.dtype, device=idx.device)
    n = idx.numel()
    if n == 0:
        return out
    from ..kernels.build import check, library

    fn = getattr(library(), entry)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        rc = fn(idx.data_ptr(), out.data_ptr(), n, table2d.data_ptr(),
                table2d.numel(), *extra, ctypes.c_void_p(stream))
    check(rc, entry)
    return out
