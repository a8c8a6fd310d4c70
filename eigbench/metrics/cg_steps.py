"""cg_steps: ``cg_matvec`` ranges of ``ops/cg.py`` per traced solve: the
deflated CG's iterations, steps frozen on the device once met included."""


def read(ctx):
    if not ctx.n_solves:
        return None
    return ctx.trace.count_ranges("cg_matvec") / ctx.n_solves
