"""Share of an untraced job's wall in which no kernel, copy or memset
ran on the device: 1 less the profiled job's device busy seconds over
the median wall of the window's jobs. The profiled job's own wall holds
the profiler's cost on the host, a cost a job outside the trace does not
pay."""


def read(ctx):
    if ctx.trace is None or ctx.job_wall <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.job_wall)
