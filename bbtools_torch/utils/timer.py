"""Phase timing and device profiling (SURVEY §5.1).

PhaseTimer mirrors the reference's shared/Timer.java usage pattern —
per-phase splits printed in the tool summary ("xtime"/"showtimes"
output of BBDuk/BBMap) — and `device_profile` wraps a block in a
torch.profiler trace (profile= flags), written as a Chrome/Kineto JSON
trace into a directory (chrome://tracing, Perfetto or TensorBoard).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time


class PhaseTimer:
    """Named phase splits; print like the reference's timing block."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.phases: list[tuple[str, float]] = []

    def split(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self.last
        self.phases.append((name, dt))
        self.last = now
        return dt

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.phases.append((name, time.perf_counter() - start))
            self.last = time.perf_counter()

    def total(self) -> float:
        return time.perf_counter() - self.t0

    def report(self, stream=None):
        # resolve sys.stderr at call time so stream redirection
        # (including pytest capture) is honored
        stream = stream if stream is not None else sys.stderr
        for name, dt in self.phases:
            print(f"{name+':':<22s}\t{dt:.3f} seconds.", file=stream)
        print(f"{'Total Time:':<22s}\t{self.total():.3f} seconds.",
              file=stream)


def trace_path(path: str) -> str:
    """The trace file device_profile writes into the directory `path`:
    one a process, named by its rank under WORLD_SIZE > 1."""
    rank = int(os.environ.get("RANK", "0"))
    return os.path.join(path, f"trace.rank{rank}.pt.trace.json")


@contextlib.contextmanager
def device_profile(path: str | None, device="cuda"):
    """torch.profiler trace around a block when `path` is set (profile=
    flag); no-op otherwise. Records the host's torch ops, and the card's
    kernels and copies when `device` is CUDA (CUPTI); shapes and stacks
    are left out to keep the trace small. Raises when a CUDA run's trace
    holds no device event: without CUPTI the profiler only warns."""
    if not path:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities, record_shapes=False, with_stack=False) as prof:
        yield
        if on_card:
            torch.cuda.synchronize(device)
    os.makedirs(path, exist_ok=True)
    out = trace_path(path)
    prof.export_chrome_trace(out)
    if on_card and not device_events(out):
        raise RuntimeError(f"{out}: the trace holds no CUDA event (is CUPTI missing?)")
    print(f"Device profile written to {path}", file=sys.stderr)


def device_events(trace: str) -> list[dict]:
    """The events of a device_profile trace that ran on the card:
    kernels, copies and memsets, in file order."""
    import json

    with open(trace) as fh:
        events = json.load(fh).get("traceEvents", [])
    return [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def kernel_table(trace: str) -> list[tuple[str, int, float]]:
    """The kernel table of a device_profile trace: (kernel name, launches,
    total device microseconds), the most time first."""
    table: dict[str, list] = {}
    for e in device_events(trace):
        if e.get("cat") == "kernel":
            row = table.setdefault(e.get("name", "?"), [0, 0.0])
            row[0] += 1
            row[1] += float(e.get("dur", 0.0))
    return sorted(((n, c, us) for n, (c, us) in table.items()), key=lambda r: -r[2])
