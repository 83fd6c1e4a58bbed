"""BBDuk in the benchmark: set-up, one job, the calls a traced run
wraps, and the comparison with the plain reference.

A job is one `BBDuk.run()` over the run's input file(s), its outputs
written to the run's work directory and overwritten by the next job.
"""

from __future__ import annotations

import os

import numpy as np

from portbench import gen
from portbench.reference import bbduk as ref


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, workdir: str,
                 device: str, control: str | None = None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.workdir, self.device = workdir, device
        self.flags = list(config["flags"]) + list(config.get("controls", {}).get(control, []))
        self.paired = traffic["mates"] == 2

    # -- set-up --------------------------------------------------------
    def setup(self):
        from bbtools_torch.models import bbduk

        t = self.traffic
        mates = gen.adapter_pairs(t["pairs_per_job"], t["read_len"], t["insert_range"],
                                  t["sub_rate"], t["adapters"], t["n_every"], self.seed)
        self.inputs = mates[: t["mates"]]
        self.n = t["pairs_per_job"]
        self.in_paths, self.out_paths = [], []
        for m, (codes, quals) in enumerate(self.inputs):
            path = os.path.join(self.workdir, f"in{m + 1}.fq")
            suffix = f" {m + 1}:N:0".encode() if self.paired else b""
            prefix = b"p" if self.paired else b"r"
            with open(path, "wb") as fh:
                fh.write(gen.fastq_bytes(codes, quals, prefix, suffix))
            self.in_paths.append(path)
            self.out_paths.append(os.path.join(self.workdir, f"out{m + 1}.fq"))
        self.bases_per_job = sum(int(c.shape[0] * c.shape[1]) for c, _ in self.inputs)
        self.reads_per_job = self.n * len(self.inputs)
        argv = self.flags + [f"in={self.in_paths[0]}", f"out={self.out_paths[0]}",
                             f"device={self.device}"]
        if self.paired:
            argv += [f"in2={self.in_paths[1]}", f"out2={self.out_paths[1]}"]
        cfg = bbduk.parse_args(argv)
        self.tool = bbduk.BBDuk(cfg)
        self.batch = cfg.batch_reads
        self._ref = None
        self.adapter_paths = [bbduk.resolve_ref_keyword(r) for r in cfg.ref]

    def run_job(self):
        self.tool.run()

    def signature(self):
        """What two jobs of one run must agree on: the output sizes."""
        return tuple(os.path.getsize(p) for p in self.out_paths)

    # -- tracing -------------------------------------------------------
    def instrument(self, spans):
        """Spans around the tool's calls: compute (process_pair) and io
        (the reader's batches, the writers' add and close)."""
        from bbtools_torch.io import fastq
        from bbtools_torch.models import bbduk

        spans.wrap_method(self.tool, "process_pair", "compute")
        spans.wrap_iterator_method(fastq, "paired_reader", "io")
        base = bbduk.FastqWriter

        class TimedWriter(base):
            def add(self, *a, **k):
                with spans.span("io"):
                    return super().add(*a, **k)

            def close(self):
                with spans.span("io"):
                    return super().close()

        spans.patch(bbduk, "FastqWriter", TimedWriter)

    def counters(self) -> dict:
        from bbtools_torch.ops import lane_index, lane_table, mm_match, overlap_scan, scan

        return {
            "lane_lookup.launches": lane_index.lane_lookup.launches,
            "cummax_i64.launches": scan.cummax_i64.launches,
            "overlap_counts.launches": overlap_scan.overlap_counts.launches,
            "lookup.launches": lane_table.lookup.launches,
            "mm_lookup.launches": mm_match.mm_lookup.launches,
        }

    def release(self):
        self.tool = None

    # -- faults (tests and the control's readings only) ------------------
    def plant(self, fault: str):
        """Break the timed path underneath: `drop_half` removes the second
        half of every batch, `alter` shortens one kept read of every
        batch by one base where it is produced."""
        inner = self.tool.process_pair

        def broken(b1, b2):
            b1, b2, keep, s1, s2 = inner(b1, b2)
            if fault == "drop_half":
                keep = keep.copy()
                keep[len(keep) // 2:] = False
            elif fault == "alter":
                i = int(np.flatnonzero(keep)[0])
                b1.lengths[i] -= 1
            return b1, b2, keep, s1, s2

        self.tool.process_pair = broken

    # -- correctness ---------------------------------------------------
    def _reference(self):
        """The reference's answer for the run's inputs, worked out once:
        each mate's kept lengths, the removed reads, and the lengths
        that tbo saw."""
        if self._ref is None:
            c = self.config["reference"]
            keys = ref.ref_keys([s for p in self.adapter_paths for s in ref.read_fasta_codes(p)],
                                c["k"], c["mink"], c["hdist"])
            r1 = self.inputs[0][0]
            lens = np.full(self.n, r1.shape[1], np.int64)
            if self.paired:
                self._ref = ref.trim(r1, lens, self.inputs[1][0], lens, keys, c["k"], c["mink"],
                                     c["minlen"], c["tpe"], c["tbo"])
            else:
                self._ref = ref.trim(r1, lens, None, None, keys, c["k"], c["mink"],
                                     c["minlen"], False, False)
        return self._ref

    def check(self):
        """Every record of the last job's output(s) against the
        reference's: which reads are kept, their lengths, their bytes."""
        n1, n2, removed, _ = self._reference()
        wrong = np.zeros(self.n, bool)
        for m, n_keep in enumerate([n1, n2][:len(self.inputs)]):
            codes, quals = self.inputs[m]
            want = _records(codes, quals, n_keep, ~removed, self.paired, m)
            wrong |= _differ(want, _read_fastq(self.out_paths[m]), self.n)
        return {"records_differ": int(wrong.sum())}, self.reads_per_job

    def work(self) -> dict:
        """Per kernel, the shapes of its calls in one job, worked out from
        the inputs and the reference's lengths (so the same whatever
        implements them): B5's insert scan, once per batch of pairs at
        tbo, over inserts from 13 to the batch's longest pair."""
        at_tbo = self._reference()[3]
        if at_tbo is None:
            return {}
        n1, n2 = at_tbo
        b = self.batch
        width = self.inputs[0][0].shape[1]
        calls = [{"pairs": len(n1[i:i + b]), "width": width,
                  "inserts": int((n1[i:i + b] + n2[i:i + b]).max()) - ref.TBO["min_insert0"] + 1}
                 for i in range(0, self.n, b)]
        return {"overlap_scan": calls}


def _records(codes, quals, n_keep, keep, paired, mate):
    """name -> record bytes for every kept read, as BBDuk writes them."""
    out = {}
    for i in np.flatnonzero(keep):
        ln = int(n_keep[i])
        name = (b"p%08d %d:N:0" % (i, mate + 1)) if paired else (b"r%08d" % i)
        out[i] = (b"@" + name + b"\n" + gen.ASCII[codes[i, :ln]].tobytes() + b"\n+\n"
                  + (quals[i, :ln] + 33).astype(np.uint8).tobytes() + b"\n")
    return out


def _read_fastq(path):
    """Index -> record bytes of a FASTQ file the tool wrote."""
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    out = {}
    for j in range(0, len(lines) - 3, 4):
        head = lines[j]
        i = int(head[2:10]) if head[1:2] in (b"p", b"r") and head[2:10].isdigit() else -1
        out[i] = b"\n".join(lines[j:j + 4]) + b"\n"
    return out


def _differ(want: dict, got: dict, n: int) -> np.ndarray:
    bad = np.zeros(n, bool)
    for i in set(want) | set(got):
        if want.get(i) != got.get(i):
            if 0 <= i < n:
                bad[i] = True
            else:
                bad[0] = True
    return bad
