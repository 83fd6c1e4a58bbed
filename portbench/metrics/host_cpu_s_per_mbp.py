"""The process's user and system CPU seconds over the window's jobs,
per input Mbp: what a shared node pays in host cores for the tool's
rate."""


def read(ctx):
    return ctx.span_cpu / ctx.mbp_measured if ctx.mbp_measured > 0 and ctx.span_cpu > 0 else None
