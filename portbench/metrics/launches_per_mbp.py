"""CUDA kernel launches of every kind in the profiled job, per input
Mbp."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["kernels"]:
        return None
    return len(ctx.trace["kernels"]) / ctx.mbp_traced
