"""restart_reorth_ms: device time (ms) of the work launched under the
``restart_reorth`` ranges of ``ops/restart.py`` (each cycle step's
projections against the (k+1, N) window), per traced solve."""


def read(ctx):
    us, launches = ctx.trace.device_us_under("restart_reorth")
    if not launches or not ctx.n_solves:
        return None
    return us * 1e-3 / ctx.n_solves
