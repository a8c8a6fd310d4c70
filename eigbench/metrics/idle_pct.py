"""idle_pct: the share of the traced window in which no kernel, copy or
memset ran on the device, in %."""


def read(ctx):
    share = ctx.trace.idle_share()
    return None if share is None else 100.0 * share
