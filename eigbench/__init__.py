"""The port's benchmark: see ``run.py`` and ``PERF.md`` at the root."""
