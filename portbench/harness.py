"""One run of one cell: set-up, the measured window, the traced job, the
comparison with the plain reference, and the result line.

Everything a cell needs is found by name: `BENCHMARK.json` names the
cell's configuration and traffic; `configs/<config>.json` names its
tool, `tools/<tool>.py` drives it; `traffic/<traffic>.json` sizes its
inputs; `metrics/<metric>.py` reads each per-layer metric. Adding a
cell, a mix or a metric adds files and edits none.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules that must not be loaded in the process that prints
#: the result (whole names, the part before the first dot)
FORBIDDEN = ("jax", "jaxlib", "flax", "bbtools_tpu")


def load(kind: str, name: str):
    """The module `<kind>/<name>.py` under the benchmark's folder."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def resolve(workload: str, bench: dict | None = None) -> SimpleNamespace:
    """The cell's entry, configuration, traffic and metrics by name."""
    bench = bench or read_json(ROOT, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = read_json(ROOT, entry["file"])
    traffic = read_json(HERE, "traffic", f"{cell['traffic']}.json")

    def here(m):
        return "workloads" not in m or workload in m["workloads"]

    return SimpleNamespace(
        name=workload, cell=cell, config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if here(m)],
        per_layer=[m for m in bench["per_layer"] if here(m)])


def cpu_seconds() -> float:
    t = os.times()
    return t.user + t.system


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", traffic: dict | None = None, fault: str | None = None,
             control: str | None = None, log=sys.stderr) -> dict:
    """Run the cell and return the result object (not yet printed).
    `traffic` replaces the cell's mix (the tests' small sizes); `fault`
    breaks the timed path and `control` runs the configuration's control
    flags: both for the readings that set the limits, never in a
    benchmark run."""
    import torch

    from portbench import spans as spans_mod
    from portbench import trace as trace_mod

    cell = resolve(workload)
    if traffic is not None:
        cell.traffic = traffic
    tool = load("tools", cell.config["tool"])
    on_card = device.startswith("cuda")
    work = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
    try:
        driver = tool.Driver(cell.config, cell.traffic, seed, work, device, control=control)
        driver.setup()
        if fault:
            driver.plant(fault)
        spans = spans_mod.Spans()
        profile = trace and on_card
        if profile:
            trace_mod.warm_profiler()
        if trace:
            driver.instrument(spans)
        t0 = time.perf_counter()
        driver.run_job()  # warm-up: every kernel and shape this cell uses
        if on_card:
            torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        print(f"portbench: warm-up job {warm:.3f} s; counters {json.dumps(driver.counters())}",
              file=log)
        sig0 = driver.signature()
        spans.events.clear()
        # the window: whole jobs back to back until `seconds` have passed
        jobs = Jobs()
        w0 = time.perf_counter()
        setup_s = w0 - t_start
        sig_ok = True
        while not jobs.n or time.perf_counter() - w0 < seconds:
            with jobs.timed():
                driver.run_job()
                if on_card:
                    torch.cuda.synchronize()
            sig_ok &= driver.signature() == sig0
        w1 = time.perf_counter()
        window = w1 - w0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        print(f"portbench: {jobs.n} jobs in {window:.4f} s; counters {json.dumps(driver.counters())}",
              file=log)
        jobs.report(log)
        tot = spans_mod.totals(spans.events, w0, w1)
        # the traced run profiles one more job, after the window
        traced = None
        if profile:
            k0 = driver.counters()
            traced = trace_mod.profile_job(driver.run_job, spans)
            k1 = driver.counters()
            traced["counters"] = {k: k1[k] - k0[k] for k in k0}
            sig_ok &= driver.signature() == sig0
            print(f"portbench: profiled job {traced['wall_s']:.4f} s against the window's median "
                  f"job {jobs.median_wall():.4f} s", file=log)
        spans.restore()
        driver.release()
        if on_card:
            torch.cuda.empty_cache()
        # the comparison, after the window and with the program's state freed
        r0 = time.perf_counter()
        checks, per_job = driver.check()
        limits = cell.config["limits"]
        print(f"portbench: reference {time.perf_counter() - r0:.3f} s", file=log)
        mbp = driver.bases_per_job * jobs.n / 1e6
        metrics = {}
        device_info = {"platform": "gpu" if on_card else "cpu",
                       "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                       "count": int(cell.cell["chips"]), "memory_peak_bytes": int(peak)}
        breakdown = None
        if not trace:
            values = {"mbp_per_s": mbp / window, "setup_s": setup_s}
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        else:
            names = trace_mod.port_kernel_names(ROOT)
            if traced is not None:
                print(f"portbench: profiled job: launch counters {json.dumps(traced['counters'])}; "
                      f"trace kernel events of the port "
                      f"{_by_name(traced['kernels'], names)}", file=log)
            ctx = SimpleNamespace(
                spans=tot, span_wall=window, span_cpu=jobs.cpu, mbp_measured=mbp,
                trace=traced, job_wall=jobs.median_wall(),
                mbp_traced=driver.bases_per_job / 1e6, peak_bytes=peak,
                work=driver.work(), peaks=read_json(HERE, "peaks.json"),
                counts=lambda n: load("counts", n),
                kernels_of=lambda src: _kernels_of(src, trace_mod),
                is_port_kernel=lambda n, s=None: trace_mod.is_port_kernel(n, names if s is None else s))
            for m in cell.per_layer:
                v = load("metrics", m["name"]).read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            if traced is not None:
                device_info["busy_s"] = traced["busy_s"]
                device_info["window_s"] = traced["wall_s"]
                breakdown = {"device_ops": [[n[:160], s] for n, s in traced["device_ops"][:10]],
                             "idle_gaps": [[n, s] for n, s in traced["idle_gaps"][:10]]}
        if not sig_ok:
            checks["jobs_disagree"] = 1
            limits = dict(limits, jobs_disagree=0)
        correct = all(checks[k] <= limits[k] for k in checks)
        failed = sum(checks.values())
        result = {"correct": bool(correct), "attempted": int(per_job * jobs.n),
                  "failed": int(failed), "metrics": metrics, "device": device_info}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in checks}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


class Jobs:
    """Each job of the window: its wall and CPU seconds (user and system,
    every thread) and the seconds Python's garbage collector took in
    it."""

    def __init__(self):
        self.rows: list[tuple[float, float, float]] = []
        self._gc = 0.0
        self._gc_t0 = None

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self._gc += time.perf_counter() - self._gc_t0
            self._gc_t0 = None

    @contextlib.contextmanager
    def timed(self):
        c0, g0 = cpu_seconds(), self._gc
        gc.callbacks.append(self._on_gc)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            wall = time.perf_counter() - t0
            gc.callbacks.remove(self._on_gc)
            self.rows.append((wall, cpu_seconds() - c0, self._gc - g0))

    @property
    def n(self) -> int:
        return len(self.rows)

    @property
    def cpu(self) -> float:
        return sum(r[1] for r in self.rows)

    def median_wall(self) -> float:
        return statistics.median(r[0] for r in self.rows)

    def report(self, log):
        for i, name in enumerate(("job seconds", "job cpu seconds", "job gc seconds")):
            print(f"portbench: {name} {[round(r[i], 4) for r in self.rows]}", file=log)


def _kernels_of(source: str, trace_mod) -> set[str]:
    """The __global__ functions of one of the program's CUDA sources."""
    return trace_mod.kernel_names([os.path.join(ROOT, "bbtools_torch", "csrc", source)])


def _by_name(kernels, names) -> str:
    """Launches of each of the port's kernels among the trace's events."""
    counts: dict[str, int] = {}
    for n, _ in kernels:
        for k in names:
            if k in n:
                counts[k] = counts.get(k, 0) + 1
    return json.dumps(counts, sort_keys=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
