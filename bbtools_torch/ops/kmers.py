"""Rolling canonical k-mer extraction — batched, vectorized, device-ready.

Replicates the reference's rolling scan semantics bit-for-bit
(bbduk/BBDukProcessorS.countSetKmers :1534-1596 and the loader scan
bbduk/BBDukIndexAndLoader.addToMap :618-700):

  - forward kmer:  kmer  = ((kmer << 2) | x ) & mask,  x  = code, N -> 0
  - reverse kmer:  rkmer = ((rkmer >> 2) | (x2 << 2(k-1))) & mask,
                   x2 = complement code, N -> 0
  - an undefined base resets `len` to 0 AND rkmer to 0 (the forward kmer is
    NOT reset — N contributes code 0, i.e. 'A', to later windows)
  - canonical key = (max(kmer, rkmer) & middle_mask) | length_mask, where
    length_mask = 1 << 2k tags the k-mer length (BBDukIndexMod.toValue :529)
  - a window ending at i is eligible when len >= minlen2 and i >= k-1

Instead of a sequential scan, positions are computed independently:
  fwd[i]  = sum_j code0[i-j] << 2j                    (j = 0..k-1)
  rkm[i]  = sum_j comp0[i-j] * [i-j > lastN[i]] << 2(k-1-j)
  len[i]  = i - lastN[i]
where lastN[i] is the most recent undefined position <= i.

The numpy host versions (oracle, index building) are copies of
bbtools_tpu/ops/kmers.py; `rolling_kmers` and `rolling_kmers_plain` are
the torch counterparts of its `rolling_kmers_jnp` and
`rolling_kmers_plain_jnp`, as int64 shifts and ORs on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dna import N_CODE


def kmer_mask(k: int) -> int:
    return (1 << (2 * k)) - 1


def length_mask(k: int) -> int:
    """Single bit to the left of the kmer; tags keys with their length."""
    return 1 << (2 * k)


def middle_mask(k: int, mid_mask_len: int) -> int:
    """maskMiddle bitmask (BBDukParser.java:303-308): zero `mid_mask_len`
    bases centered at shift ((k-mid)/2)*2; -1 (all ones) when disabled."""
    if mid_mask_len <= 0:
        return -1
    bits = 2 * mid_mask_len
    shift = ((k - mid_mask_len) // 2) * 2
    return ~(((1 << bits) - 1) << shift)


def mid_mask_len_default(k: int, mask_middle: bool) -> int:
    """Default midMaskLen = 2-(k&1) when maskMiddle (BBDukParser.java:233)."""
    return (2 - (k & 1)) if mask_middle else 0


def rc_kmer(kmer: int, k: int) -> int:
    """Reverse complement of a packed 2-bit kmer (host scalar)."""
    out = 0
    for _ in range(k):
        out = (out << 2) | (3 - (kmer & 3))
        kmer >>= 2
    return out


def rc_kmer_np(kmers: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement of packed kmers (int64 array)."""
    out = np.zeros_like(kmers)
    x = kmers.copy()
    for _ in range(k):
        out = (out << 2) | (3 - (x & 3))
        x >>= 2
    return out


def _code_planes_np(codes: np.ndarray, dtype=np.int64):
    defined = codes < N_CODE
    code0 = np.where(defined, codes, 0).astype(dtype)
    comp0 = np.where(defined, 3 - codes.astype(dtype), 0)
    return code0, comp0, defined


def _last_undef_np(defined: np.ndarray) -> np.ndarray:
    """Per position, the index of the most recent undefined base (<= i),
    or -1. Shape-preserving over the last axis."""
    idx = np.arange(defined.shape[-1], dtype=np.int64)
    marked = np.where(defined, np.int64(-1), idx)
    return np.maximum.accumulate(marked, axis=-1)


def rolling_kmers_np(codes: np.ndarray, k: int, dtype=np.int64):
    """Host oracle: per-position (fwd, rkm, runlen) for codes [..., L].

    fwd/rkm are the rolling register values the reference loop would hold
    after consuming position i; runlen is its `len` counter. Pass
    dtype=np.int32 when 2*k <= 31 to halve memory traffic (the seed
    phase's k=13 keys fit easily)."""
    assert 2 * k <= 8 * np.dtype(dtype).itemsize - 2
    codes = np.atleast_2d(codes)
    code0, comp0, defined = _code_planes_np(codes, dtype)
    L = codes.shape[-1]
    lastn = _last_undef_np(defined)
    fwd = np.zeros(codes.shape, dtype=dtype)
    rkm = np.zeros(codes.shape, dtype=dtype)
    src = np.empty_like(code0)
    tmp = np.empty_like(code0)
    idx = np.arange(L, dtype=np.int64)
    for j in range(k):
        # in-place shifted copy + OR: no fresh large allocations per step
        src[..., :j] = 0
        src[..., j:] = code0[..., : L - j]
        np.left_shift(src, dtype(2 * j), out=tmp)
        np.bitwise_or(fwd, tmp, out=fwd)
        src[..., :j] = 0
        src[..., j:] = comp0[..., : L - j]
        # contribution only if source position (i-j) is after the last N
        live = (idx - j) > lastn
        np.left_shift(src, dtype(2 * (k - 1 - j)), out=tmp)
        tmp[~live] = 0
        np.bitwise_or(rkm, tmp, out=rkm)
    runlen = (idx - lastn).astype(np.int32)
    return fwd, rkm, np.broadcast_to(runlen, codes.shape).copy()


def canonical_keys_np(
    fwd: np.ndarray,
    rkm: np.ndarray,
    k: int,
    mid_mask: int = -1,
    rcomp: bool = True,
) -> np.ndarray:
    """toValue: (max(kmer, rkmer) & middleMask) | lengthMask."""
    mx = np.maximum(fwd, rkm) if rcomp else fwd
    return (mx & np.int64(mid_mask)) | np.int64(length_mask(k))


def rolling_kmers_plain(codes: torch.Tensor, k: int):
    """Per-position rolling registers of codes [B, L] (uint8).

    Returns (fwd, rkm, rkm_plain) int64 [B, L] and runlen int32 [B, L].
    rkm_plain is the reverse window without the reset at N, which the
    reference's short-kmer end scans use (their loops have no N handling,
    BBDukProcessorS Scanning4/5). The reset (rolling register zeroed,
    BBDukProcessorS:1549) is reproduced by masking the low 2*(k - runlen)
    bits of rkm_plain: exactly the positions at or before the last
    undefined base. Windows are combined by log-doubling (O(log k)
    shifted ORs instead of k)."""
    codes = codes.to(torch.int32)
    defined = codes < int(N_CODE)
    code0 = torch.where(defined, codes, 0).to(torch.int64)
    comp0 = torch.where(defined, 3 - codes, 0).to(torch.int64)
    L = codes.shape[-1]
    idx = torch.arange(L, dtype=torch.int32, device=codes.device)
    marked = torch.where(defined, -1, idx[None, :])
    lastn = torch.cummax(marked, dim=-1).values
    runlen = idx[None, :] - lastn
    fwd = _window_fwd(code0, k)
    rkm_plain = _window_rev(comp0, k)
    t = torch.clamp(runlen, max=k).to(torch.int64)
    ones = torch.full_like(t, -1)
    keep = torch.where(t >= k, ones, ones << (2 * (k - t)))
    rkm = rkm_plain & keep
    return fwd, rkm, rkm_plain, runlen.to(torch.int32)


def rolling_kmers(codes: torch.Tensor, k: int):
    """(fwd int64 [B,L], rkm int64 [B,L], runlen int32 [B,L]) for codes
    [B, L] (uint8); see rolling_kmers_plain."""
    fwd, rkm, _, runlen = rolling_kmers_plain(codes, k)
    return fwd, rkm, runlen


def _window_fwd(vals: torch.Tensor, k: int) -> torch.Tensor:
    """w[i] = sum_{j<k} vals[i-j] << 2j, by combining power-of-2 blocks."""
    powers = {1: vals}
    m = 1
    while m * 2 <= k:
        s = powers[m]
        powers[m * 2] = s | (shift_right_zero(s, m) << (2 * m))
        m *= 2
    acc = None
    off = 0
    bit = 1
    while bit <= k:
        if k & bit:
            blk = shift_right_zero(powers[bit], off) << (2 * off)
            acc = blk if acc is None else acc | blk
            off += bit
        bit <<= 1
    return acc


def _window_rev(vals: torch.Tensor, k: int) -> torch.Tensor:
    """w[i] = sum_{j<k} vals[i-j] << 2(k-1-j) (newest source at the top)."""
    powers = {1: vals}
    m = 1
    while m * 2 <= k:
        s = powers[m]
        # newer block of size m on top of older block of size m
        powers[m * 2] = (s << (2 * m)) | shift_right_zero(s, m)
        m *= 2
    acc = None
    newer = 0  # sources already placed (newest ones, top bits)
    bit = 1 << (k.bit_length() - 1)
    while bit >= 1:
        if k & bit:
            # block covers sources [i-newer-bit+1 .. i-newer], occupying
            # bits [2*(k-newer-bit), 2*(k-newer))
            blk = shift_right_zero(powers[bit], newer) << (2 * (k - newer - bit))
            acc = blk if acc is None else acc | blk
            newer += bit
        bit >>= 1
    return acc


def shift_right_zero(x: torch.Tensor, j: int) -> torch.Tensor:
    """x shifted right by j along the last axis, zero-filled (static j)."""
    if j == 0:
        return x
    if j >= x.shape[-1]:  # a window longer than the rows: all zero
        return torch.zeros_like(x)
    pad = torch.zeros(x.shape[:-1] + (j,), dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-j]], dim=-1)
