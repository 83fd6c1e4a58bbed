"""Share of the window's wall that BBMap's main loop waits on the next
batch of the seeding worker (the span `seed_wait`, less the reading of
input that happens inside it)."""


def read(ctx):
    t = ctx.spans["self"].get("seed_wait")
    return None if t is None or ctx.span_wall <= 0 else 100.0 * t / ctx.span_wall
