"""host_reads_per_solve: the port's reads of a device value on the host
(``host_read.<site>`` ranges of ``ops/spans.py``: a β test, a CG check, a
residual, an ``eigh`` that checks its error codes), on every host thread,
in the traced window over its solves."""

PREFIX = "host_read."


def read(ctx):
    t = ctx.trace
    n = sum(1 for cat, name, s, _, _ in t.host
            if cat == "user_annotation" and name.startswith(PREFIX)
            and t.lo <= s <= t.hi)
    if not n or not ctx.n_solves:
        return None
    return n / ctx.n_solves
