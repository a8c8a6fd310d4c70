"""lobpcg_rr_ms: device time (ms) of the work launched under the
``lobpcg_rayleigh_ritz`` ranges of ``ops/lobpcg.py`` (each iteration's
Rayleigh-Ritz step: the whitenings, the small ``eigh``s, the cat and the
block products of the small bases; not W's projection, the two SpMMs
or the residual), per traced solve."""


def read(ctx):
    us, launches = ctx.trace.device_us_under("lobpcg_rayleigh_ritz")
    if not launches or not ctx.n_solves:
        return None
    return us * 1e-3 / ctx.n_solves
