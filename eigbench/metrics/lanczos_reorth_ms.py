"""lanczos_reorth_ms: device time (ms) of the work launched under the
``lanczos_reorth`` range of ``ops/lanczos.py`` (the reorthogonalization
passes), per traced solve."""


def read(ctx):
    us, launches = ctx.trace.device_us_under("lanczos_reorth")
    if not launches or not ctx.n_solves:
        return None
    return us * 1e-3 / ctx.n_solves
