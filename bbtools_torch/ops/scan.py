"""Inclusive int64 cummax over a flat vector, and its kernel.

The counterpart of bbtools_tpu/ops/scan_pallas.py. `cummax_i64` is the
kernel wrapper: on a CUDA tensor it launches the one-pass scan of
csrc/cummax_i64.cu, on a CPU tensor it runs `cummax_plain`
(torch.cummax). The TPU kernel's split of int64 into int32 halves is not
carried over: the GPU compares int64 natively.

The one-pass scan keeps its tiles' records in a scratch buffer that
stays allocated: the records carry the call's epoch, so a buffer is
zeroed only when it is allocated. Eager calls keep one buffer per
(device, stream). A call made while a CUDA graph is captured takes one
per (device, stream, capture): the graph records its zeroing, so each
replay starts from zeroed records (one memset a replay, however many
calls the graph holds), and graphs captured on one stream may be
replayed at the same time on different streams.
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
    out = _launch("cummax_i64", v, 0)
    if v.numel():
        cummax_i64.launches += 1
    return out


#: kernel launches since the count was last set to 0
cummax_i64.launches = 0

#: measurement variants of csrc/cummax_i64.cu (`cummax_i64_variant`): the
#: main one-pass kernel, and the first port's three-launch kernel
VARIANTS = {"main": 0, "three_pass": 1}


def cummax_i64_variant(variant: str, v: torch.Tensor) -> torch.Tensor:
    """One of VARIANTS on a CUDA tensor, for timing beside `cummax_i64`.
    No path of the port calls it, and it does not count in
    `cummax_i64.launches`."""
    if v.device.type != "cuda":
        raise ValueError(f"cummax_i64_variant: needs a CUDA tensor, not {v.device}")
    return _launch("cummax_i64_variant", v, VARIANTS[variant])


#: the one-pass kernel's scratch for eager calls, by (device index,
#: stream handle)
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}
#: its scratch for calls inside a graph capture, by (device index, stream
#: handle): the capture's id and the buffer, which the graph's memory pool
#: holds once a later capture replaces it here
_CAPTURED: dict[tuple[int, int], tuple[int, torch.Tensor]] = {}


def _one_pass_scratch(lib, device: torch.device, stream: int, words: int) -> torch.Tensor:
    key = (device.index, stream)
    capture = lib.cummax_i64_capture_id(ctypes.c_void_p(stream))
    if capture:
        held, scratch = _CAPTURED.get(key, (0, None))
        if held != capture or scratch.numel() < words:
            scratch = torch.zeros(words, dtype=torch.int64, device=device)
            _CAPTURED[key] = (capture, scratch)
        return scratch
    scratch = _SCRATCH.get(key)
    if scratch is None or scratch.numel() < words:
        scratch = torch.zeros(words, dtype=torch.int64, device=device)
        _SCRATCH[key] = scratch
    return scratch


def _launch(name: str, v: torch.Tensor, variant: int) -> torch.Tensor:
    if v.dtype != torch.int64 or v.dim() != 1 or not v.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous 1-D int64, got {v.dtype} "
            f"of shape {tuple(v.shape)}"
        )
    out = torch.empty_like(v)
    n = v.numel()
    if n == 0:
        return out
    from ..kernels.build import check, library

    lib = library()
    words = lib.cummax_i64_scratch(n, variant)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        if variant == VARIANTS["three_pass"]:
            # its tile maxima would overwrite the records: scratch of its own
            scratch = torch.empty(words, dtype=torch.int64, device=v.device)
        else:
            scratch = _one_pass_scratch(lib, v.device, stream, words)
        args = (v.data_ptr(), out.data_ptr(), n, scratch.data_ptr())
        if name == "cummax_i64":
            rc = lib.cummax_i64(*args, ctypes.c_void_p(stream))
        else:
            rc = lib.cummax_i64_variant(*args, variant, ctypes.c_void_p(stream))
    check(rc, name)
    return out
