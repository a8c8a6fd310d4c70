"""launches_per_solve: the host's dispatch, as the device kernels the
traced window ran (each one launch) over its solves."""


def read(ctx):
    if not ctx.n_solves:
        return None
    count = ctx.trace.kernel_count()
    return count / ctx.n_solves if count else None
