"""One job under torch.profiler (CUDA activity), and what the trace
says: the device's kernels, copies and memsets, their union (busy time),
the idle gaps between them labelled by the harness span open on the
host, and the kernels of the port's own CUDA sources.
"""

from __future__ import annotations

import glob
import os
import re
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def warm_profiler():
    """Start the profiler once on nothing: its start-up (seconds, once a
    process) then falls in set-up and not in the traced job."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def _kind(name: str) -> str:
    """The event's kind by its name: torch's kineto events name copies
    and memsets, and carry no activity type."""
    return ("gpu_memcpy" if name.startswith("Memcpy") else
            "gpu_memset" if name.startswith("Memset") else "kernel")


def profile_job(run_job, spans) -> dict:
    """Run one job under the profiler (CUDA activity only, so the host
    pays little for it) and return its reduced trace. The device's
    events carry the wall clock in ns; the job's bounds and the harness
    spans are put on that clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0, e0 = time.perf_counter(), time.time_ns()
        run_job()
        torch.cuda.synchronize()
        t1, e1 = time.perf_counter(), time.time_ns()
    events = [(_kind(e.name()), e.name(), e.start_ns(), e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    off = e0 - t0 * 1e9
    host = [(n, a * 1e9 + off, b * 1e9 + off) for n, a, b in spans.events if a >= t0 and b <= t1]
    red = reduce(events, e0, e1, host)
    red["host_t0"], red["host_t1"] = t0, t1
    return red


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events, j0: float, j1: float, host) -> dict:
    """The numbers the per-layer readers take from one job's device
    events (kind, name, start ns, duration ns) between j0 and j1, with
    the host spans (name, start ns, end ns) open meanwhile."""
    dev = [e for e in events if e[0] in DEVICE_CATS]
    if dev and not any(j0 <= s <= j1 for _, _, s, _ in dev):
        raise RuntimeError("the device's events lie outside the job: the clocks disagree")
    merged = _union([(max(s, j0), min(s + d, j1)) for _, _, s, d in dev if min(s + d, j1) > max(s, j0)])
    busy_ns = sum(b - a for a, b in merged)
    gaps = []
    edges = [j0] + [x for ab in merged for x in ab] + [j1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a <= 0:
            continue
        mid = (a + b) / 2
        open_ = [(e - s, n) for n, s, e in host if s <= mid <= e]
        gaps.append((min(open_)[1] if open_ else "loop", (b - a) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    ops: dict[str, float] = {}
    for _, name, _, d in dev:
        ops[name] = ops.get(name, 0.0) + d / 1e9
    return {
        "wall_s": (j1 - j0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernels": [(name, d / 1e9) for kind, name, _, d in dev if kind == "kernel"],
        "device_ops": sorted(ops.items(), key=lambda kv: -kv[1]),
        "idle_gaps": gaps,
    }


def port_kernel_names(root: str) -> set[str]:
    """The `__global__` functions of the program's CUDA sources."""
    return kernel_names(glob.glob(os.path.join(root, "bbtools_torch", "csrc", "*.cu")))


def kernel_names(sources) -> set[str]:
    """The `__global__` functions of CUDA sources: after each
    `__global__`, the first name followed by "(" once any
    `__launch_bounds__(...)` is skipped."""
    names = set()
    for src in sources:
        with open(src) as fh:
            text = fh.read()
        for m in re.finditer(r"__global__", text):
            i = m.end()
            while True:
                t = re.compile(r"\s*([A-Za-z_]\w*)\s*(\(?)").match(text, i)
                if not t:
                    break
                if t.group(1) == "__launch_bounds__":
                    depth, i = 0, t.end() - 1
                    while i < len(text):
                        depth += {"(": 1, ")": -1}.get(text[i], 0)
                        i += 1
                        if depth == 0:
                            break
                    continue
                if t.group(2):
                    names.add(t.group(1))
                    break
                i = t.end()
    return names


def is_port_kernel(name: str, names: set[str]) -> bool:
    """Whether a profiler kernel name holds one of the port's kernel
    names (demangled or not, the name is a part of it)."""
    return any(n in name for n in names)
