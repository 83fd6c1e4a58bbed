"""B5's share of its roofline in the profiled job: the least time its
calls could take (counts/overlap_scan.py, from the shapes the benchmark
worked out) over the device time of the kernels of
csrc/overlap_scan.cu."""


def read(ctx):
    calls = ctx.work.get("overlap_scan")
    if ctx.trace is None or not calls:
        return None
    counts = ctx.counts("overlap_scan")
    names = ctx.kernels_of(counts.SOURCE)
    t = sum(d for name, d in ctx.trace["kernels"] if ctx.is_port_kernel(name, names))
    return 100.0 * counts.least_seconds(calls, ctx.peaks) / t if t > 0 else None
