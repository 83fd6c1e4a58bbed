"""KmerCountExact — exact k-mer spectrum, khist, and k-mer dump.

The PyTorch port of bbtools_tpu/models/kmercountexact.py, a re-design
of jgi/KmerCountExact.java over kmer/KmerTableSet (BASELINE config #2:
k=31 exact spectrum + khist). On a CUDA device, k <= 31 counts into the
device-resident `DeviceSpectrum` (one merge sort per batch; only the
histogram, or the spectrum once for dump=, comes back), and k > 31
counts each batch with the W-word device sort into the host
`WordSpectrum`; on the CPU, k <= 31 takes the host `KmerSpectrum`. It
writes:

  khist=  — "#Depth\tCount" rows (AbstractKmerTableSet.makeKhist
            :563-634; cols=2, optional zeros)
  dump=   — fasta of kmers, count as header (AbstractKmerTable
            dumpKmersAsBytes semantics, mincounttodump filter)
  peaks=  — coverage peak calls (CallPeaks; subset: peak list with
            center/volume via local maxima of the smoothed histogram)

With shards=N (k <= 31) the spectrum is hash-sharded over N devices
(parallel/sharded_spectrum.py), with the same output bytes. In a process
group (parallel/distributed.py) each process counts its own input and
the spectra merge into one global answer, written by every process.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..core.dna import kmer_to_text
from ..core.parser import tokenize
from ..device import resolve_device
from ..io.stream import read_batches
from ..io.readwrite import open_output
from ..ops.kmer_count import DeviceSpectrum, KmerSpectrum, count_batch


def run(argv: list[str]):
    a = tokenize(argv)
    in1 = a.get("in", "in1")
    in2 = a.get("in2")
    k = a.get_int("k", default=31)
    khist = a.get("khist", "hist")
    dump = a.get("dump", "out")
    peaks = a.get("peaks")
    hist_max = a.get_int("histmax", "histlen", "khistlen", default=100000)
    print_zeros = a.get_bool("printzeros", default=True)
    min_count_dump = a.get_int("mincounttodump", "mincount", default=1)
    batch_reads = a.get_int("batchreads", default=16384)
    device = resolve_device(a.get("device"))
    big = k > 31
    if big:
        from ..ops.kmers2 import MAX_K, WordSpectrum, count_batchw_exact

        if k > MAX_K:
            raise ValueError(f"k={k} exceeds max supported k={MAX_K}")
    shards = a.get_int("shards", "tpshards", default=0)
    t0 = time.time()
    on_card = device.type == "cuda"
    if shards > 1 and not big:
        # hash-sharded multi-device spectrum: kmer % shards ownership over
        # a dp mesh (kmer/KmerTableSet.java:273-285)
        from ..parallel.mesh import local_devices, make_mesh
        from ..parallel.sharded_spectrum import ShardedSpectrum

        mesh = make_mesh(n_dp=shards, devices=local_devices(device)[:shards])
        spec = ShardedSpectrum(mesh, k)
    elif big:
        spec = WordSpectrum(k)
    elif on_card:
        # device-resident accumulation: the spectrum never crosses to
        # the host per batch (one scalar does, every sync_every batches);
        # khist finalizes on the device, dump pulls the spectrum once
        spec = DeviceSpectrum(k, device=device)
    else:
        spec = KmerSpectrum(k)
    reads = bases = 0
    for path in [p for p in (in1, in2) if p]:
        # compute-only: the raw-byte plane is never re-emitted here
        reader = read_batches(path, batch_reads=batch_reads,
                              with_ascii=False, with_quals=False)
        for b in reader:
            if big:
                keys, c = count_batchw_exact(
                    b.bases, b.lengths.astype(np.int64), k, device
                )
                spec.add_batch(keys, c)
            elif shards > 1 or on_card:
                spec.add_batch(b.bases, b.lengths)
            else:
                v, c = count_batch(b.bases, b.lengths, k, device)
                spec.add_batch(v, c)
        reads += reader.reads_in
        bases += reader.bases_in
    spec.flush()
    from ..parallel.distributed import global_spectrum, global_sum_array, world_size

    if world_size() > 1 and not big:
        # several processes: each read its own input shard; merge into
        # ONE global spectrum (the same on every process), so khist, dump,
        # peaks and stats are the single global answer
        if hasattr(spec, "spectrum"):
            lk, lc = spec.spectrum()
        else:
            lk, lc = spec.keys, spec.counts
        gk, gc = global_spectrum(lk, lc, device)
        spec = KmerSpectrum(k)
        spec.keys, spec.counts = gk, gc
        reads, bases = (
            int(x) for x in global_sum_array(np.array([reads, bases]))
        )
    elapsed = time.time() - t0
    if khist:
        h = spec.histogram(hist_max)
        with open_output(khist) as fh:
            fh.write(b"#Depth\tCount\n")
            for depth in range(1, len(h)):
                if print_zeros or h[depth] > 0:
                    fh.write(b"%d\t%d\n" % (depth, h[depth]))
    if dump:
        with open_output(dump) as fh:
            if big:
                from ..ops.kmers2 import WORD_BASES, bytes_to_words

                W = spec.W
                t_top = k - WORD_BASES * (W - 1)
                words = bytes_to_words(spec.keys, W)
                for row, cnt in zip(words, spec.counts):
                    if cnt >= min_count_dump:
                        text = kmer_to_text(int(row[W - 1]), t_top)
                        for w in range(W - 2, -1, -1):
                            text += kmer_to_text(int(row[w]), WORD_BASES)
                        fh.write(b">%d\n%s\n" % (cnt, text.encode()))
            else:
                if hasattr(spec, "spectrum"):
                    dk, dc = spec.spectrum()
                else:
                    dk, dc = spec.keys, spec.counts
                for key, cnt in zip(dk, dc):
                    if cnt >= min_count_dump:
                        fh.write(
                            b">%d\n%s\n"
                            % (cnt, kmer_to_text(int(key), k).encode())
                        )
    if peaks:
        _write_peaks(peaks, spec.histogram(hist_max), k)
    print(
        f"Unique Kmers:               \t{spec.n_unique}",
        file=sys.stderr,
    )
    print(
        f"Reads Processed:    {reads:>10}\t"
        f"{reads / max(elapsed, 1e-9) / 1000:.2f}k reads/sec",
        file=sys.stderr,
    )
    return spec


def _write_peaks(path: str, hist: np.ndarray, k: int):
    """Minimal CallPeaks-style output: local maxima of the smoothed
    histogram with start/center/stop/volume columns."""
    h = hist.astype(np.float64)
    # light smoothing (radius 1) to suppress noise
    sm = h.copy()
    sm[1:-1] = (h[:-2] + h[1:-1] + h[2:]) / 3
    rows = []
    i = 2
    while i < len(sm) - 1:
        if sm[i] > sm[i - 1] and sm[i] >= sm[i + 1] and h[i] > 0:
            lo = i
            while lo > 1 and sm[lo - 1] < sm[lo]:
                lo -= 1
            hi = i
            while hi < len(sm) - 1 and sm[hi + 1] < sm[hi]:
                hi += 1
            vol = int(hist[lo : hi + 1].sum())
            rows.append((lo, i, hi, int(hist[i]), vol))
            i = hi + 1
        else:
            i += 1
    with open_output(path) as fh:
        fh.write(b"#k\t%d\n" % k)
        fh.write(b"#start\tcenter\tstop\tmax\tvolume\n")
        for r in rows:
            fh.write(("\t".join(str(x) for x in r) + "\n").encode())


def main(argv=None):
    return run(argv if argv is not None else sys.argv[1:])


if __name__ == "__main__":
    main()
