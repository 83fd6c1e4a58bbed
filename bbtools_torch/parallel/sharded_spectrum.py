"""Hash-sharded exact k-mer spectrum over a dp mesh.

The counterpart of bbtools_tpu/parallel/sharded_spectrum.py. The
reference scales its k-mer tables by hash-sharding: every thread owns the
k-mers with `kmer % WAYS == way` and no locks are needed
(kmer/KmerTableSet.java:273-285). Here every device of the mesh's dp axis
owns the k-mers with `kmer % n == d`. Each batch's rows are cut into one
slab per device; each slab's canonical k-mers are sorted by owner (PAD,
the empty window, goes to a virtual owner n and is never sent), every
owner receives its groups from every slab in slab order, and merges them
into its device-resident sorted (keys, counts) with the single-device
sort-reduce (ops/kmer_count.py `merge_spectra`). Owners hold disjoint
keys, so the spectrum is a global sort of their live rows and the
histogram the sum of theirs: the bytes of the single-device spectrum.

The JAX package's fixed capacities and grow-and-retry loop exist for
XLA's static shapes; here the carries take the size the merge gives
them. One pull a batch, after every slab is launched: the owners' group
bounds, with the run counts of the previous batch's merges, which trim
the carries.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kmer_count import PAD, batch_kmers, merge_spectra
from .mesh import Mesh, slabs


class ShardedSpectrum:
    """KmerSpectrum/DeviceSpectrum-compatible facade over the mesh."""

    def __init__(self, mesh: Mesh, k: int):
        self.mesh = mesh
        self.k = k
        self.n_dp = int(mesh.shape["dp"])
        self.devices = [mesh.row(d) for d in range(self.n_dp)]
        self.keys = [torch.zeros(0, dtype=torch.int64, device=d) for d in self.devices]
        self.counts = [torch.zeros(0, dtype=torch.int64, device=d) for d in self.devices]
        #: each owner's run count: a host int, or the device scalar of a
        #: merge not pulled yet
        self._runs: list = [0] * self.n_dp

    def add_batch(self, bases, lengths):
        bases = np.asarray(bases)
        lengths = np.asarray(lengths).astype(np.int32)
        B, L = bases.shape
        n = self.n_dp
        if B % n:
            padr = n - B % n
            bases = np.concatenate(
                [bases, np.full((padr, L), 4, bases.dtype)]
            )
            lengths = np.concatenate([lengths, np.zeros(padr, np.int32)])
        bases, lengths = torch.from_numpy(bases), torch.from_numpy(lengths)
        # every slab's k-mers, sorted by owner, and each owner's bounds
        sent = []
        for dev, sl in zip(self.devices, slabs(bases.shape[0], n)):
            keys = batch_kmers(bases[sl].to(dev), lengths[sl].to(dev), self.k)
            owner = torch.where(keys == int(PAD), n, keys % n)
            owner_s, order = torch.sort(owner, stable=True)
            bounds = torch.searchsorted(
                owner_s, torch.arange(n + 1, dtype=owner_s.dtype, device=dev))
            sent.append((keys[order], bounds))
        self._trim()
        bounds = [b.tolist() for _, b in sent]
        # each owner merges what every slab sends it, in slab order
        for t, dev in enumerate(self.devices):
            recv = torch.cat([key_s[b[t] : b[t + 1]].to(dev)
                              for (key_s, _), b in zip(sent, bounds)])
            self.keys[t], self.counts[t], self._runs[t] = merge_spectra(
                self.keys[t], self.counts[t], recv)

    def _trim(self):
        """Pull the run counts of merges not pulled yet, and cut each
        carry to its live runs."""
        for t, r in enumerate(self._runs):
            if isinstance(r, torch.Tensor):
                self._runs[t] = int(r)
                self.keys[t] = self.keys[t][: self._runs[t]]
                self.counts[t] = self.counts[t][: self._runs[t]]

    def flush(self):
        self._trim()

    def histogram(self, hist_max: int) -> np.ndarray:
        """hist[c] = distinct k-mers seen c times (the last bin takes
        every count past hist_max): each owner's bincount, summed on the
        mesh's first device."""
        self._trim()
        dev0 = self.devices[0]
        h = torch.zeros(hist_max + 1, dtype=torch.int64, device=dev0)
        for c in self.counts:
            h += torch.bincount(c.clamp(0, hist_max), minlength=hist_max + 1).to(dev0)
        h = h.cpu().numpy().astype(np.int64)
        h[0] = 0
        return h

    def spectrum(self):
        """One final readback; owners hold disjoint keys, so a global
        sort of their rows is the exact spectrum."""
        self._trim()
        kk = np.concatenate([k.cpu().numpy() for k in self.keys])
        cc = np.concatenate([c.cpu().numpy() for c in self.counts])
        o = np.argsort(kk, kind="stable")
        return kk[o], cc[o]

    @property
    def host_keys(self):
        return self.spectrum()[0]

    @property
    def host_counts(self):
        return self.spectrum()[1]

    @property
    def n_unique(self):
        self._trim()
        return int(sum(self._runs))
