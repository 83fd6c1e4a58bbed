"""Device milliseconds of the port's own CUDA kernels (the __global__
functions of bbtools_torch/csrc) in the profiled job, per input Mbp."""


def read(ctx):
    if ctx.trace is None:
        return None
    own = [d for name, d in ctx.trace["kernels"] if ctx.is_port_kernel(name)]
    return 1e3 * sum(own) / ctx.mbp_traced if own else None
