"""IndelFreeAligner — exhaustive substitution-only alignment (indelfree.sh,
ifa/IndelFreeAligner4.java).

The PyTorch port of bbtools_tpu/models/indelfree.py. Queries
(spacers/primers/probes, held in memory) align to every position of
streamed reference sequences allowing up to `subs` substitutions and NO
indels; hits emit SAM records.

The search runs on the run's device (`device=`, cuda by default): the
windows of a reference chunk (a strided view, no copy) compare against
the query panel in a [rows, C, L] masked compare. The JAX package holds
the whole panel at once; at 1,024 query rows of up to 55 bp that is 3.7
G booleans a chunk, so the port walks the query rows in tiles under
SEARCH_BUDGET bytes (`search_bytes` counts them), each tile's counts
written into the chunk's [Q, C] result. The hits are taken on the
device from the whole [Q, C], query major as `np.argwhere` takes them,
and only they come to the host.
`_device_search.device_calls` counts chunks searched on CUDA tensors.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..core.dna import encode
from ..core.parser import tokenize
from ..device import resolve_device
from ..io.fasta import iter_fasta
from ..io.fileformat import Format, test_input
from ..io.readwrite import open_output

CHUNK = 1 << 16  # reference positions per device call

#: bytes one chunk's search may hold on its device (`search_bytes`)
SEARCH_BUDGET = 1 << 30


def search_bytes(Q: int, C: int, L: int, rows: int) -> int:
    """Device bytes of one chunk's search at `rows` query rows a tile:
    the [Q, C] int32 counts and the [Q, C] bool of the hits the caller
    takes from them, and a tile's compare [rows, C, L] (bool) with its
    sums: uint8 [rows, C] while L < 256 (the counts fit), else an int32
    copy of the compare."""
    return 5 * Q * C + rows * C * (L + 1 if L < 256 else 5 * L)


def tile_rows(Q: int, C: int, L: int, budget: int | None = None) -> int:
    """The most query rows a tile may take with `search_bytes` within
    the budget (at least one, whatever the budget)."""
    budget = SEARCH_BUDGET if budget is None else budget
    per_row = search_bytes(Q, C, L, 1) - search_bytes(Q, C, L, 0)
    return max(1, min(Q, (budget - search_bytes(Q, C, L, 0)) // per_row))


def _device_search(queries, qlens, ref_chunk, device, budget: int | None = None):
    """mismatches [Q, C] int32 on `device` for every query at every
    chunk offset, C = len(ref_chunk) - L; the query rows in tiles of
    `tile_rows`."""
    dev = torch.device(device)
    if dev.type == "cuda":
        _device_search.device_calls += 1
    q = torch.from_numpy(np.ascontiguousarray(queries, np.uint8)).to(dev)
    ql = torch.from_numpy(np.asarray(qlens, np.int64)).to(dev)
    rc = torch.from_numpy(np.ascontiguousarray(ref_chunk, np.uint8)).to(dev)
    Q, L = q.shape
    C = rc.shape[0] - L  # valid window starts
    win = rc.unfold(0, L, 1)[:C]  # [C, L]: win[d, i] = rc[d + i]
    valid_q = torch.arange(L, device=dev)[None, :] < ql[:, None]  # [Q, L]
    mism = torch.empty((Q, C), dtype=torch.int32, device=dev)
    t = tile_rows(Q, C, L, budget)
    for r0 in range(0, Q, t):
        ne = q[r0:r0 + t, None, :] != win[None]  # [t, C, L]
        ne &= valid_q[r0:r0 + t, None, :]
        if L < 256:  # summed as bytes: no int32 copy of the compare
            mism[r0:r0 + t] = ne.view(torch.uint8).sum(2, dtype=torch.uint8)
        else:
            mism[r0:r0 + t] = ne.sum(2, dtype=torch.int32)
        del ne
    return mism


#: chunks searched on CUDA tensors since the count was last set to 0
_device_search.device_calls = 0


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    device = resolve_device(a.get("device", default="cuda"))
    in1 = a.get("in", "in1")
    ref = a.get("ref")
    out = a.get("out")
    max_subs = a.get_int("subs", "s", default=5)
    minid = a.get_float("minid", default=0.85)
    minqlen = a.get_int("minqlen", default=1)
    t0 = time.time()

    # load queries (+ reverse complements)
    names: list[bytes] = []
    seqs: list[np.ndarray] = []
    if test_input(in1).format is Format.FASTA:
        for rec in iter_fasta(in1):
            if len(rec.seq) >= minqlen:
                names.append(rec.name.split()[0])
                seqs.append(encode(rec.seq))
    else:
        from ..io.fastq import FastqReader

        for b in FastqReader(in1):
            for i in range(b.n):
                if int(b.lengths[i]) >= minqlen:
                    names.append(b.ids[i].split()[0])
                    seqs.append(b.bases[i, : int(b.lengths[i])].copy())
    nq = len(seqs)
    L = max((len(s) for s in seqs), default=1)
    Q = 2 * nq  # forward + rc rows
    queries = np.full((Q, L), 4, np.uint8)
    qlens = np.zeros(Q, np.int32)
    for i, s in enumerate(seqs):
        queries[2 * i, : len(s)] = s
        rc = np.where(s < 4, 3 - s, 4)[::-1]
        queries[2 * i + 1, : len(s)] = rc
        qlens[2 * i] = qlens[2 * i + 1] = len(s)
    # allowed subs per query: min(subs, qlen*(1-minid))
    allowed = np.minimum(
        max_subs, np.floor(qlens * (1.0 - minid)).astype(np.int32)
    ) if minid > 0 else np.full(Q, max_subs, np.int32)
    allowed = np.maximum(allowed, 0)
    allowed_t = torch.from_numpy(allowed.astype(np.int32)).to(device)

    n_hits = 0
    fh = open_output(out) if out else None
    scaf_names = []
    records = []
    for rec in iter_fasta(ref):
        scaf_names.append((rec.name.split()[0], len(rec.seq)))
        codes = encode(rec.seq)
        S = len(codes)
        for c0 in range(0, max(S - 1, 1), CHUNK):
            chunk = np.full(CHUNK + L, 4, np.uint8)
            seg = codes[c0 : c0 + CHUNK + L]
            chunk[: len(seg)] = seg
            mism = _device_search(queries, qlens, chunk, device)
            hit = torch.nonzero(mism <= allowed_t[:, None])  # query major
            nms = mism[hit[:, 0], hit[:, 1]].cpu().numpy()
            del mism  # before the next chunk's search allocates its own
            for (qi, off), nm in zip(hit.cpu().numpy().tolist(), nms.tolist()):
                pos = c0 + int(off)
                if pos + int(qlens[qi]) > S:
                    continue
                strand = qi & 1
                name = names[qi // 2]
                records.append(
                    (name, strand, scaf_names[-1][0], pos + 1,
                     int(qlens[qi]), nm, qi // 2)
                )
                n_hits += 1
    if fh is not None:
        fh.write(b"@HD\tVN:1.4\tSO:unsorted\n")
        for nm, ln in scaf_names:
            fh.write(b"@SQ\tSN:%s\tLN:%d\n" % (nm, ln))
        for name, strand, rname, pos, qlen, nm, qidx in records:
            s = seqs[qidx]
            if strand:
                s = np.where(s < 4, 3 - s, 4)[::-1]
            from ..core.dna import CODE_TO_BASE

            fh.write(
                b"%s\t%d\t%s\t%d\t%d\t%dM\t*\t0\t0\t%s\t*\tNM:i:%d\n"
                % (
                    name, 16 if strand else 0, rname, pos,
                    max(2, 40 - 4 * nm), qlen,
                    CODE_TO_BASE[np.minimum(s, 4)].tobytes(), nm,
                )
            )
        fh.close()
    print(f"Queries:             \t{nq}", file=sys.stderr)
    print(f"Hits:                \t{n_hits}", file=sys.stderr)
    print(f"Time:                \t{time.time()-t0:.3f} seconds.",
          file=sys.stderr)
    return records
