"""BBMap in the benchmark: set-up, one job, the calls a traced run
wraps, and the comparison with the plain reference.

A job is one `BBMap.run()` over the run's reads against the genome that
set-up indexed once; the SAM is written to the run's work directory and
overwritten by the next job.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from portbench import gen
from portbench.reference import bbmap as ref


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, workdir: str,
                 device: str, control: str | None = None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.workdir, self.device = workdir, device
        self.flags = list(config["flags"]) + list(config.get("controls", {}).get(control, []))

    # -- set-up --------------------------------------------------------
    def setup(self):
        from bbtools_torch.models import bbmap

        t, g = self.traffic, self.config["genome"]
        self.genome = gen.genome(g["length"], self.seed)
        ref_path = os.path.join(self.workdir, "ref.fa")
        gen.write_fasta(ref_path, b"genome", self.genome)
        self.reads, self.truth = gen.genome_reads(
            self.genome, t["reads_per_job"], t["read_len"], t["sub_rate"],
            t["indel_frac"], t["indel_range"], self.seed, walk=t.get("walk"))
        quals = np.full(self.reads.shape, t["quality"], np.uint8)
        in_path = os.path.join(self.workdir, "reads.fq")
        with open(in_path, "wb") as fh:
            fh.write(gen.fastq_bytes(self.reads, quals, b"r"))
        self.out_path = os.path.join(self.workdir, "out.sam")
        self.n = t["reads_per_job"]
        self.bases_per_job = int(self.reads.size)
        self.reads_per_job = self.n
        cfg = bbmap.parse_args(self.flags + [f"ref={ref_path}", f"in={in_path}",
                                             f"out={self.out_path}", f"device={self.device}"])
        self.tool = bbmap.BBMap(cfg)
        self._count_walks()

    def _count_walks(self):
        """Count the fused step's traceback walks (R + Cc steps each) by
        the module attribute it calls; `release` puts it back."""
        from bbtools_torch.ops import map_fused

        inner = self._walk = map_fused.msa_walk
        self.walks = self.walk_steps = 0

        def counted(R, Cc, *a, **k):
            self.walks += 1
            self.walk_steps += R + Cc
            return inner(R, Cc, *a, **k)

        map_fused.msa_walk = counted

    def run_job(self):
        self.tool.run()

    def signature(self):
        return (os.path.getsize(self.out_path),)

    # -- tracing -------------------------------------------------------
    def instrument(self, spans):
        """Spans around the tool's calls: compute (map_batch), seed_wait
        (the main loop's wait on the seeding worker's next batch), io
        (reading batches, SAM encoding, the writer's writes)."""
        from bbtools_torch.models import bbmap

        spans.wrap_method(self.tool, "map_batch", "compute")
        spans.wrap_method(self.tool, "to_sam", "io")
        spans.wrap_iterator_method(self.tool, "_prefetch_candidates", "seed_wait")
        spans.wrap_iterator_method(self.tool, "_read_batches", "io")
        base = bbmap.SamWriter

        class TimedWriter(base):
            def add_batch(self, *a, **k):
                with spans.span("io"):
                    return super().add_batch(*a, **k)

            def close(self):
                with spans.span("io"):
                    return super().close()

        spans.patch(bbmap, "SamWriter", TimedWriter)

    def counters(self) -> dict:
        from bbtools_torch.ops import msa_fill

        tool = self.tool
        return {
            "msa_fill.launches": msa_fill.msa_fill.launches,
            "msa_fill.band_launches": msa_fill.msa_fill.band_launches,
            "msa_fill.block_launches": msa_fill.msa_fill.block_launches,
            "fused_overflows": tool.fused_overflows,
            "plane_groups": tool.plane_groups,
            "index_seconds": tool.index_seconds,
            "walks": self.walks,
            "walk_steps": self.walk_steps,
        }

    def release(self):
        from bbtools_torch.ops import map_fused

        map_fused.msa_walk = self._walk
        self.tool = None

    # -- faults (tests only) -------------------------------------------
    def plant(self, fault: str):
        """Break the timed path underneath: `drop_half` leaves the second
        half of every batch unmapped, `alter` moves one mapped read of
        every batch by one base where it is produced."""
        inner = self.tool.map_batch

        def broken(batch, cand=None, prep=None):
            results = inner(batch, cand, prep)
            if fault == "drop_half":
                for r in results[len(results) // 2:]:
                    r.mapped = False
            elif fault == "alter":
                r = next(r for r in results if r.mapped)
                r.flat_start += 1
            return results

        self.tool.map_batch = broken

    # -- correctness ---------------------------------------------------
    def check(self):
        """Every record of the last job's SAM against the reference's
        alignment of its read at the true locus: flag (mapped, strand),
        position, CIGAR and AS. The reference's fill runs on the run's
        device, after the window."""
        c = self.config["reference"]
        hi = int(self.traffic["indel_range"][1])
        want = ref.expected(self.genome, self.reads, self.truth["start"], self.truth["strand"],
                            c["pad"], np.maximum(self.truth["ilen"], hi), device=self.device)
        got = _read_sam(self.out_path)
        bad = [i for i, w in enumerate(want) if got.get(i) != w]
        for i in bad[:5]:
            t = {k: int(v[i]) for k, v in self.truth.items()}
            print(f"portbench: read {i} {t}: wrote {got.get(i)}, reference {want[i]}", file=sys.stderr)
        wrong = len(bad) + len(set(got) - set(range(self.n)))
        return {"reads_differ": int(wrong)}, self.reads_per_job

    def work(self) -> dict:
        return {}


def _read_sam(path):
    """Read index -> (flag, pos, cigar, AS) of the primary records."""
    out = {}
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b"@"):
                continue
            f = line.rstrip(b"\n").split(b"\t")
            flag = int(f[1])
            if flag & 0x100:
                continue
            score = next((int(x[5:]) for x in f[11:] if x.startswith(b"AS:i:")), None)
            i = int(f[0][1:]) if f[0][1:].isdigit() else -1
            out[i] = (flag, int(f[3]), f[5].decode(), score)
    return out
