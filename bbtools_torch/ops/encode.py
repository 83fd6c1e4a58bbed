"""2-bit base packing for host->device transfer.

The wire format for base codes: 4 bases/byte (2-bit codes) plus a
1-bit/base N-mask — 2.7x smaller than byte codes. Packing is host numpy
(or the threaded native packer); unpacking is a handful of shifts on the
device, torch ops on the packed tensors' device. The reference's
ChromosomeArray had the same motivation (dna/ChromosomeArray.java:15 —
byte arrays there, but 2-bit on disk). `pack_bases_np` is a copy of
bbtools_tpu/ops/encode.py's.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_bases_np(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """codes uint8 [B, L] (0..3, >=4 undefined) ->
    (packed uint8 [B, ceil(L/4)], nmask uint8 [B, ceil(L/8)]).

    Routed through the threaded native packer when available (the numpy
    path measures ~150 Mbases/s — below the device scan rate)."""
    try:
        from ..native import pack_2bit_native

        res = pack_2bit_native(codes)
        if res is not None:
            return res
    except Exception:
        pass
    B, L = codes.shape
    L4 = -(-L // 4) * 4
    L8 = -(-L // 8) * 8
    c = np.zeros((B, L4), dtype=np.uint8)
    base2 = np.where(codes < 4, codes, 0).astype(np.uint8)
    c[:, :L] = base2
    c = c.reshape(B, L4 // 4, 4)
    packed = c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)
    n = np.zeros((B, L8), dtype=np.uint8)
    n[:, :L] = (codes >= 4).astype(np.uint8)
    n = n.reshape(B, L8 // 8, 8)
    nmask = np.zeros(n.shape[:2], dtype=np.uint8)
    for bit in range(8):
        nmask |= n[..., bit] << bit
    return packed, nmask


def unpack_bases(packed: torch.Tensor, nmask: torch.Tensor, L: int) -> torch.Tensor:
    """Inverse of pack_bases_np on the tensors' device -> uint8 codes
    [B, L]."""
    B = packed.shape[0]
    p = packed.to(torch.uint8)
    codes = torch.stack([(p >> (2 * i)) & 3 for i in range(4)], dim=-1)
    codes = codes.reshape(B, 4 * p.shape[1])[:, :L]
    m = nmask.to(torch.uint8)
    nm = torch.stack([(m >> i) & 1 for i in range(8)], dim=-1).reshape(B, 8 * m.shape[1])[:, :L]
    return torch.where(nm == 1, 4, codes).to(torch.uint8)
