"""cg_useful_pct: the deflated CG's steps that ran unfrozen, in % of the
products it made: the port's counter ``cg_iterations`` (``ops/spans.py``,
counted only while a profiler records, so over the traced window of the
run's one process) over the ``cg_matvec`` ranges of ``ops/cg.py``.  The
rest are the steps a solve runs past convergence until its next host
check (every ``CHECK_EVERY`` steps)."""


def read(ctx):
    spans = getattr(getattr(ctx.port, "ops", None), "spans", None)
    useful = getattr(spans, "counts", {}).get("cg_iterations", 0)
    steps = ctx.trace.count_ranges("cg_matvec")
    if not useful or not steps:
        return None
    return 100.0 * useful / steps
