"""Exact k-mer counting — device extraction + sort-reduce, merged spectra.

The PyTorch port of bbtools_tpu/ops/kmer_count.py, the counting half of
kmer/KmerTableSet.java (the LoadThread scan :397-484 + HashArray1D
increment): instead of a mutable hash table, each batch's canonical
k-mers are sorted on the device and reduced to (unique, count) runs.
Sorting replaces atomics — deterministic and collision-free.

Canonicalization matches the loader exactly: kmer windows with len >= k
(no undefined base in window), key = max(kmer, rkmer) — counting tables
use the PLAIN canonical kmer, no length-tag bit (kmer/KmerTableSet.java
uses toValue without masks).

The device functions are torch ops on any device: `batch_kmers`,
`sort_reduce` (a sort, then run boundaries compacted by a scatter to
distinct slots: no atomics, no pull of the run count), `merge_spectra`
and `DeviceSpectrum`, the device-resident merged spectrum. Counts are
int64 throughout. `KmerSpectrum` and `count_batch_np` are host copies.
`device_calls` on `sort_reduce`, `merge_spectra` counts their calls on
CUDA tensors: the proof that a path counted on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .kmers import length_mask, rolling_kmers, rolling_kmers_np

#: sentinel larger than any 62-bit kmer, sorts last
PAD = np.int64(0x7FFFFFFFFFFFFFFF)


def batch_kmers(bases: torch.Tensor, lengths: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical kmers of all valid windows, padded with PAD. [B*L] i64."""
    fwd, rkm, runlen = rolling_kmers(bases, k)
    i_idx = torch.arange(bases.shape[1], device=bases.device)[None, :]
    valid = (runlen >= k) & (i_idx < lengths[:, None])
    keys = torch.where(valid, torch.maximum(fwd, rkm), int(PAD))
    return keys.reshape(-1)


def batch_keys(bases, lengths, k: int, device) -> torch.Tensor:
    """batch_kmers of a batch's host arrays (codes [B, L], lengths [B])
    on `device`."""
    return batch_kmers(torch.as_tensor(np.asarray(bases), device=device),
                       torch.as_tensor(np.asarray(lengths), device=device), k)


def read_keys_t(bases, lengths, k: int, device, canonical: bool = True):
    """The valid k-mer keys of a batch's reads on `device`, flat in read
    order (row-major, as `keys[valid]` takes them on the host), and the
    count of each read's (host int64 [B]). canonical: the JAX package's
    `canonical_keys_np` (the larger strand | the length bit); else the
    larger strand alone."""
    keys = batch_keys(bases, lengths, k, device).view(len(lengths), -1)
    valid = keys != int(PAD)
    flat = keys[valid]
    if canonical:
        flat = flat | length_mask(k)
    return flat, valid.sum(1).cpu().numpy()


def _compact(s, boundary, excl, total):
    """Runs of the sorted keys s ([n], or [n, W] rows of words) ->
    (values, counts, n_runs), padded to n rows (PAD / 0 past n_runs).
    boundary marks each run's first row; excl is the count summed before
    each row and total the sum of all, so a run's count is the next
    run's excl less its own. Each run's first row is scattered to its
    own slot (rows that start no run go to a dropped slot n): no
    atomics, and n_runs stays on the device."""
    n = s.shape[0]
    dev = s.device
    n_runs = boundary.sum()
    slot = torch.where(boundary, torch.cumsum(boundary, 0) - 1, n)
    values = torch.full((n + 1, *s.shape[1:]), int(PAD), dtype=torch.int64, device=dev)
    values = values.scatter(0, slot.view(-1, *[1] * (s.dim() - 1)).expand_as(s), s)[:n]
    ex = torch.zeros(n + 1, dtype=torch.int64, device=dev).scatter(0, slot, excl)[:n]
    iota = torch.arange(n, device=dev)
    nxt = torch.cat([ex[1:], torch.zeros(1, dtype=torch.int64, device=dev)])
    counts = torch.where(iota < n_runs - 1, nxt - ex, total - ex)
    live = iota < n_runs
    return values, torch.where(live, counts, 0), n_runs


def _boundaries(s):
    """Run starts of the sorted keys s [n] (PAD rows start none) and the
    live rows."""
    live_row = s != int(PAD)
    first = torch.ones(1, dtype=torch.bool, device=s.device)
    return torch.cat([first, s[1:] != s[:-1]]) & live_row, live_row


def sort_reduce(keys: torch.Tensor):
    """Sort keys and reduce to run (values, counts, n_runs). Padded output
    tensors of the same length; rows >= n_runs are PAD/0; n_runs is a
    device scalar."""
    if keys.device.type == "cuda":
        sort_reduce.device_calls += 1
    s = torch.sort(keys).values
    boundary, live_row = _boundaries(s)
    iota = torch.arange(s.shape[0], device=s.device)
    return _compact(s, boundary, iota, live_row.sum())


def count_batch(bases, lengths, k: int, device="cuda"):
    """Counting for one batch -> host (values, counts) arrays.

    On CUDA the sort-reduce runs on the card and only the runs come
    back; on the CPU the keys go through np.unique, as the JAX package
    does on a CPU platform. Both produce identical (values, counts)."""
    dev = torch.device(device)
    keys = batch_keys(bases, lengths, k, dev)
    if dev.type != "cpu":
        values, counts, n_runs = sort_reduce(keys)
        n = int(n_runs)
        return values[:n].cpu().numpy(), counts[:n].cpu().numpy()
    keys = keys.numpy()
    keys = keys[keys != PAD]
    return np.unique(keys, return_counts=True)


def merge_spectra(spec_keys, spec_counts, batch_keys):
    """Merge a spectrum ([C] PAD-padded sorted keys + counts) with a raw
    batch key stream ([M], PAD-padded, count 1 each): one sort of the
    C+M keys, then a run-sum of the counts. Returns ([C+M] keys, counts,
    n_runs); the caller slices back to capacity."""
    if spec_keys.device.type == "cuda":
        merge_spectra.device_calls += 1
    all_k = torch.cat([spec_keys, batch_keys])
    all_c = torch.cat([spec_counts, (batch_keys != int(PAD)).to(torch.int64)])
    s, order = torch.sort(all_k)
    c = all_c[order]
    boundary, _ = _boundaries(s)
    return _compact(s, boundary, torch.cumsum(c, 0) - c, c.sum())


#: calls on CUDA tensors since the counts were last set to 0
sort_reduce.device_calls = 0
merge_spectra.device_calls = 0


def _accumulate_batch(bases, lengths, spec_keys, spec_counts, k):
    """Per-batch spectrum accumulate: extract + merge + slice back to the
    carry capacity. n_runs may exceed the capacity (the caller grows and
    replays; the sliced tensors are then invalid and discarded)."""
    keys = batch_kmers(bases, lengths, k)
    nk, nc, n_runs = merge_spectra(spec_keys, spec_counts, keys)
    cap = spec_keys.shape[0]
    return nk[:cap], nc[:cap], n_runs


class DeviceSpectrum:
    """Device-resident exact spectrum: the merged (keys, counts) tensors
    live on the device across batches and only one scalar (the unique
    count) comes back, every `sync_every` batches; the full spectrum
    transfers once, at the end, via spectrum(). Capacity doubles on
    overflow (ScheduleMaker's resize schedule role,
    kmer/ScheduleMaker.java:16).

    The carry is rebuilt by every batch and never written in place, so
    holding the tensors of the last synced carry is the checkpoint: a
    LATE overflow (an unsynced batch's run count past the capacity)
    restores it, grows past the largest count seen, and replays the
    batches kept since."""

    def __init__(self, k: int, cap: int = 1 << 21, sync_every: int = 8,
                 device="cuda"):
        self.k = k
        self.cap = cap
        self.device = torch.device(device)
        self.keys = torch.full((cap,), int(PAD), dtype=torch.int64, device=self.device)
        self.counts = torch.zeros(cap, dtype=torch.int64, device=self.device)
        self.n = 0
        self.sync_every = max(1, sync_every)
        self._pending: list = []  # per-batch n_runs device scalars
        self._replay: list = []  # (bases, lengths) since the checkpoint
        self._ckpt = (self.keys, self.counts)
        self._host = None

    def _grow(self, need: int | None = None):
        while True:
            # cap is always derived from the live tensor (a checkpoint
            # restore may have rolled the carry back below self.cap)
            pad = int(self.keys.shape[0])
            self.cap = 2 * pad
            self.keys = torch.cat([self.keys, torch.full_like(self.keys, int(PAD))])
            self.counts = torch.cat([self.counts, torch.zeros_like(self.counts)])
            if need is None or self.cap >= need:
                return

    def add_batch(self, bases, lengths):
        """bases [B, L] uint8 (numpy or tensor), lengths [B]."""
        bases = torch.as_tensor(bases, device=self.device)
        lengths = torch.as_tensor(lengths, device=self.device)
        self.keys, self.counts, n_runs = _accumulate_batch(
            bases, lengths, self.keys, self.counts, self.k,
        )
        self._host = None
        self._pending.append(n_runs)
        self._replay.append((bases, lengths))
        if len(self._pending) >= self.sync_every:
            self._sync()

    def _sync(self):
        if not self._pending:
            return
        ns = torch.stack(self._pending).tolist()  # one pull for the window
        if max(ns) <= self.cap:
            self.n = ns[-1]
            self._ckpt = (self.keys, self.counts)
            self._pending.clear()
            self._replay.clear()
            return
        # late overflow: restore the checkpointed carry, grow past the
        # largest observed run count, and replay the kept batches
        self.keys, self.counts = self._ckpt
        self.cap = int(self.keys.shape[0])
        replay = self._replay
        self._pending = []
        self._replay = []
        self._grow(need=max(ns))
        for b, ln in replay:
            self.add_batch(b, ln)
        self._sync()

    def flush(self):
        self._sync()

    def spectrum(self):
        """One final readback: (sorted int64 keys [n], counts [n])."""
        self._sync()
        if self._host is None:
            self._host = (
                self.keys[: self.n].cpu().numpy(),
                self.counts[: self.n].cpu().numpy(),
            )
        return self._host

    @property
    def host_keys(self):
        return self.spectrum()[0]

    @property
    def host_counts(self):
        return self.spectrum()[1]

    @property
    def n_unique(self):
        self._sync()
        return self.n

    def histogram(self, hist_max: int) -> np.ndarray:
        """Histogram on the device: only [hist_max+1] int64 returns to
        the host (khist= never pays the spectrum transfer)."""
        self._sync()
        cl = self.counts[: self.n].clamp(0, hist_max)
        h = torch.bincount(cl, minlength=hist_max + 1).cpu().numpy()
        h = h.astype(np.int64)
        h[0] = 0
        return h


class KmerSpectrum:
    """Host-side merged exact spectrum: sorted kmers + int64 counts."""

    def __init__(self, k: int):
        self.k = k
        self.keys = np.zeros(0, dtype=np.int64)
        self.counts = np.zeros(0, dtype=np.int64)
        self._pending: list[tuple[np.ndarray, np.ndarray]] = []
        self._pending_size = 0

    def add_batch(self, values: np.ndarray, counts: np.ndarray):
        self._pending.append((values, counts))
        self._pending_size += len(values)
        if self._pending_size > max(4 * len(self.keys), 1 << 22):
            self.flush()

    def flush(self):
        if not self._pending:
            return
        all_k = np.concatenate([self.keys] + [p[0] for p in self._pending])
        all_c = np.concatenate([self.counts] + [p[1] for p in self._pending])
        order = np.argsort(all_k, kind="stable")
        all_k = all_k[order]
        all_c = all_c[order]
        boundary = np.ones(len(all_k), dtype=bool)
        boundary[1:] = all_k[1:] != all_k[:-1]
        idx = np.cumsum(boundary) - 1
        self.keys = all_k[boundary]
        self.counts = np.zeros(len(self.keys), dtype=np.int64)
        np.add.at(self.counts, idx, all_c)
        self._pending = []
        self._pending_size = 0

    @property
    def n_unique(self) -> int:
        self.flush()
        return len(self.keys)

    def histogram(self, hist_max: int) -> np.ndarray:
        """hist[c] = number of distinct kmers with count c; counts > max
        accumulate in the last bin (HistogramMaker semantics)."""
        self.flush()
        h = np.zeros(hist_max + 1, dtype=np.int64)
        np.add.at(h, np.minimum(self.counts, hist_max), 1)
        h[0] = 0
        return h


def count_batch_np(bases, lengths, k: int):
    """Host oracle for tests."""
    fwd, rkm, runlen = rolling_kmers_np(bases, k)
    i_idx = np.arange(bases.shape[1])[None, :]
    valid = (runlen >= k) & (i_idx < lengths[:, None])
    keys = np.maximum(fwd, rkm)[valid]
    values, counts = np.unique(keys, return_counts=True)
    return values, counts.astype(np.int64)
