"""Share of the window's wall inside the tool's batch step (the span
`compute`: BBDuk.process_pair, BBMap.map_batch)."""


def read(ctx):
    t = ctx.spans["total"].get("compute")
    return None if t is None or ctx.span_wall <= 0 else 100.0 * t / ctx.span_wall
