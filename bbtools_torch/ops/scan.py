"""Inclusive int64 cummax over a flat vector, and its kernel.

The counterpart of bbtools_tpu/ops/scan_pallas.py. `cummax_i64` is the
kernel wrapper: on a CUDA tensor it launches the scan of
csrc/cummax_i64.cu, on a CPU tensor it runs `cummax_plain`
(torch.cummax). The TPU kernel's split of int64 into int32 halves is not
carried over: the GPU compares int64 natively.
"""

from __future__ import annotations

import ctypes

import torch


def cummax_plain(v: torch.Tensor) -> torch.Tensor:
    """Plain torch version: inclusive cummax of int64 [N]."""
    return torch.cummax(v, 0).values


def cummax_i64(v: torch.Tensor) -> torch.Tensor:
    """Inclusive cummax of int64 [N]. CPU tensors run `cummax_plain`;
    CUDA tensors launch the kernel, or raise."""
    if v.device.type == "cpu":
        return cummax_plain(v)
    if v.device.type != "cuda":
        raise ValueError(f"cummax_i64: unsupported device {v.device}")
    if v.dtype != torch.int64 or v.dim() != 1 or not v.is_contiguous():
        raise ValueError(
            f"cummax_i64: expected contiguous 1-D int64, got {v.dtype} "
            f"of shape {tuple(v.shape)}"
        )
    out = torch.empty_like(v)
    n = v.numel()
    if n == 0:
        return out
    from ..kernels.build import check, library

    lib = library()
    tile = lib.cummax_i64_tile()
    scratch = torch.empty(-(-n // tile), dtype=torch.int64, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.cummax_i64(
            v.data_ptr(), out.data_ptr(), n, scratch.data_ptr(),
            ctypes.c_void_p(stream),
        )
    check(rc, "cummax_i64")
    cummax_i64.launches += 1
    return out


#: kernel launches since the count was last set to 0
cummax_i64.launches = 0
