"""Small sizes of the cells' mixes for runs on the CPU."""

import time

from portbench import harness

SMALL = {"bbmap.se151_reseq": 96, "bbduk.pe151_adapters": 1500, "bbduk.se151_adapters": 3000}
#: BBMap's indel mix, kept for its cell once the program's traceback ties
#: follow traceback2 (PERF.md, Open questions); run here in the reseq cell
INDEL_MIX = "se151_divergent"


def small_traffic(workload: str, n: int | None = None, mix: str | None = None) -> dict:
    cell = harness.resolve(workload)
    t = dict(harness.read_json(harness.HERE, "traffic", f"{mix}.json") if mix else cell.traffic)
    key = "pairs_per_job" if "pairs_per_job" in t else "reads_per_job"
    t[key] = n or SMALL[workload]
    return t


def run_small(workload: str, seed: int = 2**31 + 11, trace: bool = False, mix: str | None = None,
              **kw) -> dict:
    return harness.run_cell(workload, seed, 0.0, trace, time.perf_counter(), device="cpu",
                            traffic=small_traffic(workload, mix=mix), **kw)
