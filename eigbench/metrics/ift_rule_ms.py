"""ift_rule_ms: device time (ms) of the work launched under the IFT
rules' own ranges of ``ops/eigh.py``, ``ift_backward`` (the reverse rule:
its deflated solve, if any, and the cotangent product) and ``ift_jvp``
(the forward rule: the tangent product and the deflated CG), on every
host thread (autograd runs a reverse rule on its device thread), per
traced solve."""


def read(ctx):
    total, launches = 0.0, 0
    for name in ("ift_backward", "ift_jvp"):
        us, n = ctx.trace.device_us_under(name)
        total, launches = total + us, launches + n
    if not launches or not ctx.n_solves:
        return None
    return total * 1e-3 / ctx.n_solves
