"""Profiler ranges and counters of the port, behind one gate.

Every range the solvers open and every counter they increment goes
through :func:`span`, :func:`count` and :func:`host_read`.  A range is
opened (a ``torch.profiler.record_function``) and a counter incremented
only while a profiler records, as ``torch._C._autograd._profiler_enabled()``
reports (``torch.profiler.profile``, ``utils.trace``, and
``torch.autograd.profiler.emit_nvtx``, which sets the same flag).
Otherwise a call is that flag check: no allocation, no device work.
The flag travels with autograd's thread-local state, so the reverse rules,
which autograd runs on its device threads, open their ranges as well.

Ranges carry no clock of their own: the profiler writes them on the
clock of the device trace.  Counters hold counts only, in :data:`counts`,
and so count exactly what ran under the profiler.

Each range and counter here is read by a per-layer metric of the
benchmark (``eigbench/metrics/<name>.py``; ``PERF.md`` §3), or by the
trace the README documents.
"""

from __future__ import annotations

import collections
import contextlib

import torch
from torch.profiler import record_function

# Every range the port opens besides the host reads (PERF.md §3 names
# the metric that reads each, or the README's trace that shows it).
RANGES = ("lanczos_matvec", "lanczos_reorth", "cg_matvec", "bicgstab_matvec",
          "ift_backward", "ift_jvp", "tfim_matvec", "lobpcg_rayleigh_ritz",
          "restart_reorth")

# The solvers' reads of a device value on the host, each the range
# ``host_read.<site>`` (read by host_reads_per_solve and read_stall_pct).
HOST_READS = (
    "lanczos_beta",              # ops/lanczos.py::_step, "cond" mode
    "lanczos_converged",         # lanczos_adaptive, at each checkpoint
    "lanczos_tridiagonal_eigh",  # _tridiagonal_eigh
    "cg_check",                  # _cg_loop, every CHECK_EVERY steps
    "bicgstab_check",            # _bicgstab_loop, every CHECK_EVERY steps
    "lobpcg_residual",           # both LOBPCG loops, every iteration
    "lobpcg_whiten_eigh",        # _whiten_metric
    "lobpcg_ritz_eigh",          # _rayleigh_ritz
    "restart_fresh",             # ops/restart.py::_fresh_vector
    "restart_breakdown",         # _continuation, every step
    "restart_dead",              # _cycle, once a cycle
    "restart_arrowhead_eigh",    # _cycle's arrowhead eigh, once a cycle
)

# The one counter: ``cg_iterations``, the deflated CG's steps that ran
# unfrozen (cg_useful_pct).
counts: collections.Counter = collections.Counter()

recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the range ``name`` while a profiler records,
    else one shared no-op."""
    return record_function(name) if recording() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if recording():
        counts[name] += n


def host_read(site: str, tensor: torch.Tensor | None = None):
    """One read of a device value on the host at ``site``.

    ``host_read(site, tensor)`` returns ``tensor.item()`` (what ``bool``
    and ``float`` of a one-element tensor read); ``host_read(site)`` is a
    context manager for a block that synchronizes (a ``torch.linalg.eigh``
    checks its error codes on the host).  While a profiler records, either
    opens the range ``host_read.<site>`` around the read."""
    if not recording():
        return _OFF if tensor is None else tensor.item()
    name = f"host_read.{site}"
    if tensor is None:
        return record_function(name)
    with record_function(name):
        return tensor.item()
