"""Lane-layout k-mer hash table for small panels (adapters, artifacts,
primers), and its lookup kernel.

Layout (built on the host, identical to bbtools_tpu/ops/lane_index.py):
`nb = groups * 128` buckets, `slots` entries per bucket. Bucket b lives
at lane `b & 127` of lane-group `b >> 7`; each (group, slot) cell is one
128-lane row of three int32 planes (key_lo, key_hi, id). Empty slots have
id == 0; stored keys are unique (first-wins dedup happens in
build_ref_keys), so at most one slot matches.

Hash: 32-bit multiply-xor-multiply with a build-chosen salt; build
retries salts (and then grows nb) until every bucket fits in `slots`
entries.

`lane_lookup` is the kernel wrapper: on a CUDA tensor it launches a
CUDA kernel of csrc/lane_lookup.cu (the counterpart of the TPU's
`_lane_kernel`), on a CPU tensor it runs `lookup_plain`, the torch port
of the JAX package's `_lookup_xla`. Of the two kernels, a table that
fits in a block's shared memory (the device's opt-in limit, 227 KB on an
H100) takes the one that stages it there; a larger one takes the kernel
that probes it in L2.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

C1 = np.int32(-1640531527)  # 0x9E3779B9 golden-ratio odd constant
C2 = np.int32(-862048943)  # 0xCC9E2D51 (murmur3 c1)
C3 = np.int32(461845907)  # 0x1B873593 (murmur3 c2)

LANES = 128
_M32 = 0xFFFFFFFF


def _hash32_np(lo: np.ndarray, hi: np.ndarray, salt: int, nb: int) -> np.ndarray:
    """Bucket index; int32 wraparound arithmetic, identical to the kernel."""
    with np.errstate(over="ignore"):
        h = (
            lo.astype(np.int32) * C1
            + hi.astype(np.int32) * C2
            + np.int32(salt)
        )
        h = h ^ ((h >> np.int32(15)) & np.int32(0x1FFFF))
        h = h * C3
        sh = 32 - int(nb).bit_length() + 1
        return (h >> np.int32(sh)) & np.int32(nb - 1)


@dataclass
class LaneKmerIndex:
    """Lane-layout hash table; see module docstring.

    `packed` mode (hi < 2**15 and 0 <= id < 2**16, true for adapter-scale
    panels) stores thi = (hi << 16) | id and drops the tid plane.
    """

    tlo: np.ndarray  # int32 [groups * rows, LANES]
    thi: np.ndarray  # int32 [groups * rows, LANES] (packed: hi<<16 | id)
    tid: np.ndarray  # int32 [groups * rows, LANES] (packed: empty [8, LANES])
    nb: int
    groups: int
    slots: int
    rows: int  # slots padded to a multiple of 8
    salt: int
    packed: bool
    n: int

    #: the largest groups*slots product the build accepts; bigger panels
    #: go to the sorted join. Kept equal to the JAX package's cap so both
    #: packages pick the same backend for a panel.
    MAX_COST = 1280
    MAX_SLOTS = 24

    @staticmethod
    def supports(n_keys: int) -> bool:
        """Rough pre-check; build() may still return None."""
        return n_keys <= LaneKmerIndex.MAX_COST * LANES

    @staticmethod
    def build(keys: np.ndarray, ids: np.ndarray) -> "LaneKmerIndex | None":
        """Returns None if no layout lands under MAX_COST."""
        n = len(keys)
        if n == 0:
            return None
        keys = np.asarray(keys, dtype=np.int64)
        ids = np.asarray(ids, dtype=np.int32)
        lo = (keys & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        hi = (keys >> 32).astype(np.int32)
        # kernel cost per query tile = groups * slots gather passes; search
        # nb for the minimum product among layouts whose max occupancy
        # respects the VMEM slot cap
        best = None
        nb = LANES
        while nb <= LANES << 10:
            for salt in range(8):
                b = _hash32_np(lo, hi, salt, nb)
                occ = np.bincount(b, minlength=nb)
                mo = int(occ.max(initial=0))
                if mo > LaneKmerIndex.MAX_SLOTS:
                    continue
                cost = (nb // LANES) * max(mo, 1)
                if best is None or cost < best[0]:
                    best = (cost, nb, salt, mo)
            nb *= 2
        if best is None or best[0] > LaneKmerIndex.MAX_COST:
            return None
        _, nb, salt, mo = best
        groups = nb // LANES
        slots = max(mo, 1)
        rows = (slots + 7) // 8 * 8
        packed = bool((hi < (1 << 15)).all() and (ids >= 0).all()
                      and (ids < (1 << 16)).all())
        b = _hash32_np(lo, hi, salt, nb)
        tlo = np.zeros((groups * rows, LANES), np.int32)
        thi = np.zeros((groups * rows, LANES), np.int32)
        order = np.argsort(b, kind="stable")
        bs = b[order]
        rank = np.arange(n) - np.searchsorted(bs, bs)
        g = bs // LANES
        lane = bs % LANES
        row = g * rows + rank
        tlo[row, lane] = lo[order]
        if packed:
            thi[row, lane] = (hi[order] << 16) | ids[order]
            tid = np.zeros((8, LANES), np.int32)
        else:
            thi[row, lane] = hi[order]
            tid = np.zeros((groups * rows, LANES), np.int32)
            tid[row, lane] = ids[order]
        return LaneKmerIndex(
            tlo, thi, tid, nb, groups, slots, rows, int(salt), packed, n
        )

    @staticmethod
    def from_arrays(tlo, thi, tid, nb: int, groups: int, slots: int,
                    rows: int, salt: int, packed: bool) -> "LaneKmerIndex":
        """An index over tables built elsewhere (the JAX package's
        LaneKmerIndex fields), so both packages can share one table."""
        tlo = np.ascontiguousarray(tlo, dtype=np.int32)
        thi = np.ascontiguousarray(thi, dtype=np.int32)
        tid = np.ascontiguousarray(tid, dtype=np.int32)
        if tlo.shape != (groups * rows, LANES) or thi.shape != tlo.shape:
            raise ValueError(f"lane tables of shape {tlo.shape}, {thi.shape}")
        n = int(np.count_nonzero(thi & 0xFFFF if packed else tid))
        return LaneKmerIndex(tlo, thi, tid, int(nb), int(groups), int(slots),
                             int(rows), int(salt), bool(packed), n)

    def device_arrays(self, device):
        return tuple(
            torch.from_numpy(a).to(device) for a in (self.tlo, self.thi, self.tid)
        )

    def lookup_np(self, query: np.ndarray) -> np.ndarray:
        qlo = (query & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        qhi = (query >> 32).astype(np.int32)
        b = _hash32_np(qlo, qhi, self.salt, self.nb)
        g = b // LANES
        lane = b % LANES
        out = np.zeros(query.shape, np.int32)
        for s in range(self.slots):
            row = g * self.rows + s
            clo = self.tlo[row, lane]
            chi = self.thi[row, lane]
            if self.packed:
                cid = chi & 0xFFFF
                chi = chi >> 16
            else:
                cid = self.tid[row, lane]
            hit = (clo == qlo) & (chi == qhi) & (cid != 0)
            out = np.where(hit & (out == 0), cid, out)
        return out

    def static_params(self):
        """(nb, groups, slots, rows, salt, packed) for lane_lookup."""
        return (self.nb, self.groups, self.slots, self.rows, self.salt,
                self.packed)


def _mul32(a, c: int):
    """(a * c) mod 2**32 for int64 a in [0, 2**32) and a 32-bit constant c,
    with every intermediate below 2**49 (no int64 overflow)."""
    c &= _M32
    return (((((a >> 16) * c) & 0xFFFF) << 16) + (a & 0xFFFF) * c) & _M32


def _to_int32(u):
    """int64 holding an unsigned 32-bit value -> int32 of the same bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def lookup_plain(tlo, thi, tid, nb: int, groups: int, slots: int, rows: int,
                 salt: int, packed: bool, query):
    """Plain torch version of the lookup (the JAX package's `_lookup_xla`):
    query int64 [...] -> id int32 [...], first match wins. The hash runs
    on int64 holding unsigned 32-bit values, masked after every step, so
    it depends on no integer overflow behaviour."""
    lo = query & _M32
    hi = (query >> 32) & _M32
    h = (_mul32(lo, int(C1)) + _mul32(hi, int(C2)) + salt) & _M32
    h = h ^ ((h >> 15) & 0x1FFFF)
    h = _mul32(h, int(C3))
    sh = 32 - int(nb).bit_length() + 1
    b = (h >> sh) & (nb - 1)
    cell0 = (b >> 7) * (rows * LANES) + (b & (LANES - 1))
    qlo, qhi = _to_int32(lo), _to_int32(hi)
    flo, fhi, fid = tlo.reshape(-1), thi.reshape(-1), tid.reshape(-1)
    out = torch.zeros(query.shape, dtype=torch.int32, device=query.device)
    for s in range(slots):
        cell = cell0 + s * LANES
        clo = flo[cell]
        chi = fhi[cell]
        if packed:
            cid = chi & 0xFFFF
            chi = chi >> 16
        else:
            cid = fid[cell]
        hit = (clo == qlo) & (chi == qhi) & (cid != 0)
        out = torch.where(hit & (out == 0), cid, out)
    return out


def _check_table(t, query, name):
    if t.device != query.device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(
            f"lane_lookup: {name} must be a contiguous int32 tensor on "
            f"{query.device}, got {t.dtype} on {t.device}"
        )


def lane_lookup(tlo, thi, tid, nb: int, groups: int, slots: int, rows: int,
                salt: int, packed: bool, query):
    """Lane-table lookup, query int64 [...] -> id int32 [...].

    CPU tensors run `lookup_plain`; CUDA tensors launch a kernel of
    csrc/lane_lookup.cu, or raise: the shared-memory kernel where the
    table fits (`fits_shared`), else the L2 probe."""
    if query.device.type == "cpu":
        return lookup_plain(tlo, thi, tid, nb, groups, slots, rows, salt,
                            packed, query)
    if query.device.type != "cuda":
        raise ValueError(f"lane_lookup: unsupported device {query.device}")
    shared = fits_shared(query.device, nb, slots, rows, packed)
    out = _launch("lane_lookup", VARIANTS["shared" if shared else "scalar"], tlo, thi,
                  tid, nb, groups, slots, rows, salt, packed, query)
    if query.numel():
        lane_lookup.launches += 1
        lane_lookup.l2_launches += not shared
    return out


#: kernel launches since the counts were last set to 0; `l2_launches`
#: counts those of the L2-probe kernel, for tables too large for shared
#: memory
lane_lookup.launches = 0
lane_lookup.l2_launches = 0

#: kernels of csrc/lane_lookup.cu: the shared-memory kernel, and the
#: original kernel (one query per thread, probes in L2), which serves the
#: tables too large for shared memory and is the measurement variant
#: "scalar"
VARIANTS = {"shared": 0, "scalar": 1}


def fits_shared(device, nb: int, slots: int, rows: int, packed: bool) -> bool:
    """Whether the table fits the shared-memory kernel on `device`: its
    planes, its filter and a word per bucket within the opt-in limit of
    one block."""
    from ..kernels.build import check, library

    need, limit = ctypes.c_int64(), ctypes.c_int()
    with torch.cuda.device(device):
        check(library().lane_lookup_shared_bytes(rows, nb, int(packed), ctypes.byref(need),
                                                 ctypes.byref(limit)),
              "lane_lookup_shared_bytes")
    return need.value <= limit.value


def lane_lookup_variant(variant: str, tlo, thi, tid, nb: int, groups: int, slots: int,
                        rows: int, salt: int, packed: bool, query):
    """One of VARIANTS on CUDA tensors, for timing beside `lane_lookup`.
    No path of the port calls it, and it counts in no launch count."""
    if query.device.type != "cuda":
        raise ValueError(f"lane_lookup_variant: needs a CUDA tensor, not {query.device}")
    return _launch("lane_lookup_variant", VARIANTS[variant], tlo, thi, tid, nb, groups,
                   slots, rows, salt, packed, query)


def _launch(name: str, variant: int, tlo, thi, tid, nb: int, groups: int, slots: int,
            rows: int, salt: int, packed: bool, query):
    if query.dtype != torch.int64 or not query.is_contiguous():
        raise ValueError(f"{name}: query must be contiguous int64")
    for t, tname in ((tlo, "tlo"), (thi, "thi"), (tid, "tid")):
        _check_table(t, query, tname)
    if tlo.shape != (groups * rows, LANES) or thi.shape != tlo.shape:
        raise ValueError(f"{name}: tables of shape {tuple(tlo.shape)}")
    if not packed and tid.shape != tlo.shape:
        raise ValueError(f"{name}: tid of shape {tuple(tid.shape)}")
    out = torch.empty(query.shape, dtype=torch.int32, device=query.device)
    n = query.numel()
    if n == 0:
        return out
    from ..kernels.build import check, library

    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        rc = library().lane_lookup(
            query.data_ptr(), out.data_ptr(), n, tlo.data_ptr(),
            thi.data_ptr(), tid.data_ptr(), rows, slots, nb,
            32 - int(nb).bit_length() + 1, salt, int(packed), variant,
            ctypes.c_void_p(stream),
        )
    check(rc, name)
    return out
