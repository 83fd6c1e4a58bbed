"""BBMerge insert scan: per read pair and candidate insert, the good /
bad / overlap-length counts of read a against the reverse complement of
read b (jgi/BBMergeOverlapper.java:428-446).

The counterpart of bbtools_tpu/ops/overlap_pallas.py (the TPU kernel
`_kernel`) and of `overlap_counts_jnp` in its ops/overlap.py. For insert
`ins`, read position i of a faces position j = i + blen - ins of rc(b)
over the window max(ins - blen, 0) <= i < min(alen, ins): `good` counts
equal non-N codes, `bad` unequal codes, and the window length is the
overlap. Two Ns are equal but not good.

`overlap_counts` is the wrapper: a CPU tensor runs `overlap_counts_plain`
(overlap_counts_jnp's algorithm: right-justify rc(b) once, then one
static shifted slice per insert), a CUDA tensor launches the bit-sliced
kernel of csrc/overlap_scan.cu, anything else raises. Counts are
integers, so both are exact in any order. Like the TPU kernel and the
plain version, the kernel compares any uint8 codes, not only 0-4.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F


def overlap_counts_plain(a, b_rc, alens, blens, min_insert0: int,
                         n_inserts: int):
    """(good, bad, olen) int32 [B, n_inserts] for codes a, b_rc [B, L]
    (b already reverse-complemented, left-aligned) and lengths [B];
    column d is insert min_insert0 + d."""
    B, L = a.shape
    dev = a.device
    ai = a.to(torch.int32)
    alens = alens.to(torch.int64)
    blens = blens.to(torch.int64)
    i_idx = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    # right-justify: b_rj[:, L-1-t] = b_rc[:, blen-1-t]
    src = (i_idx - (L - blens[:, None])).clamp(0, L - 1)
    b_rj = torch.gather(b_rc.to(torch.int32), 1, src)
    max_ins = min_insert0 + n_inserts - 1
    P = max(max_ins - L, 0) + 1  # left pad: largest insert's slice start
    R = max(L - min_insert0, 0) + 1  # right pad: smallest insert's tail
    b_pad = F.pad(b_rj, (P, R), value=9)
    a_lt4 = ai < 4
    good, bad, olen = [], [], []
    for d in range(n_inserts):
        ins = min_insert0 + d
        # b_rj column of read position i is i + L - ins
        s = P + L - ins
        bseg = b_pad[:, s : s + L]
        valid = (i_idx < alens.clamp(max=ins)[:, None]) & (
            i_idx >= (ins - blens).clamp(min=0)[:, None]
        )
        eq = ai == bseg
        good.append((valid & eq & a_lt4).sum(dim=1, dtype=torch.int32))
        bad.append((valid & ~eq).sum(dim=1, dtype=torch.int32))
        olen.append(valid.sum(dim=1, dtype=torch.int32))
    if n_inserts == 0:
        z = torch.zeros((B, 0), dtype=torch.int32, device=dev)
        return z, z.clone(), z.clone()
    return (torch.stack(good, 1), torch.stack(bad, 1), torch.stack(olen, 1))


def overlap_counts(a, b_rc, alens, blens, min_insert0: int, n_inserts: int):
    """The insert scan of `overlap_counts_plain`. CPU tensors run the
    plain version; CUDA tensors launch the kernel of csrc/overlap_scan.cu
    (a, b_rc contiguous uint8 [B, L]; alens, blens contiguous int32 [B]),
    or raise."""
    if a.device.type == "cpu":
        return overlap_counts_plain(a, b_rc, alens, blens, min_insert0,
                                    n_inserts)
    if a.device.type != "cuda":
        raise ValueError(f"overlap_counts: unsupported device {a.device}")
    outs = _launch("overlap_counts", a, b_rc, alens, blens, min_insert0, n_inserts, 0)
    if a.shape[0] and n_inserts > 0:
        overlap_counts.launches += 1
    return outs


#: kernel launches since the count was last set to 0
overlap_counts.launches = 0

#: measurement variants of csrc/overlap_scan.cu (`overlap_scan_variant`):
#: the bit-sliced kernel, and the first port's kernel (a byte at a time)
VARIANTS = {"main": 0, "byte": 1}


def overlap_counts_variant(variant: str, a, b_rc, alens, blens, min_insert0: int,
                           n_inserts: int):
    """One of VARIANTS on CUDA tensors, for timing beside
    `overlap_counts`. No path of the port calls it, and it does not count
    in `overlap_counts.launches`."""
    if a.device.type != "cuda":
        raise ValueError(f"overlap_counts_variant: needs a CUDA tensor, not {a.device}")
    return _launch("overlap_counts_variant", a, b_rc, alens, blens, min_insert0,
                   n_inserts, VARIANTS[variant])


def _launch(name: str, a, b_rc, alens, blens, min_insert0: int, n_inserts: int,
            variant: int):
    B, L = a.shape
    for t, arg, dt, shape in ((a, "a", torch.uint8, (B, L)),
                              (b_rc, "b_rc", torch.uint8, (B, L)),
                              (alens, "alens", torch.int32, (B,)),
                              (blens, "blens", torch.int32, (B,))):
        if (t.device != a.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {arg} must be a contiguous {dt} tensor "
                f"of shape {shape} on {a.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )
    outs = tuple(torch.empty((B, n_inserts), dtype=torch.int32,
                             device=a.device) for _ in range(3))
    if B == 0 or n_inserts <= 0:
        return outs
    from ..kernels.build import check, library

    lib = library()
    with torch.cuda.device(a.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream)
        args = (a.data_ptr(), b_rc.data_ptr(), alens.data_ptr(), blens.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
                B, L, min_insert0, n_inserts)
        if variant == 0:
            rc = lib.overlap_scan(*args, stream)
        else:
            rc = lib.overlap_scan_variant(*args, variant, stream)
    check(rc, "overlap_scan")
    return outs
