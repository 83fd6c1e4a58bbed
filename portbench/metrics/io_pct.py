"""Share of the window's wall in reading the next batch and in writing
(the spans `io`: the reader's batches, the writers, BBMap's SAM
encoding)."""


def read(ctx):
    t = ctx.spans["total"].get("io")
    return None if t is None or ctx.span_wall <= 0 else 100.0 * t / ctx.span_wall
