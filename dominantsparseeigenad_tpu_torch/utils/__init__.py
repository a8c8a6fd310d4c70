"""Utilities of the port: timing and profiler traces (``timing.py``),
checkpointing (``checkpoint.py``), the JSONL metrics logger
(``logging.py``) and solver diagnostics with convergence guards
(``diagnostics.py``)."""

from .checkpoint import load_orbax, load_pytree, save_orbax, save_pytree
from .diagnostics import (assert_converged, assert_converged_residual,
                          cg_relative_residual, lanczos_health,
                          orthogonality_loss, ritz_residual)
from .logging import JsonlLogger
from .timing import TimingResult, sync, timeit, trace

__all__ = [
    "sync", "timeit", "trace", "TimingResult",
    "save_pytree", "load_pytree", "save_orbax", "load_orbax",
    "JsonlLogger",
    "ritz_residual", "orthogonality_loss", "lanczos_health",
    "cg_relative_residual", "assert_converged",
    "assert_converged_residual",
]
