"""Timing and profiling.

Counterpart of ``dominantsparseeigenad_tpu/utils/timing.py``:

* :func:`sync` / :func:`timeit`: wall-clock time that ends in a true
  barrier.  A CUDA call returns before the card has run it, so ``sync``
  synchronizes every card a leaf lives on and then reads one element of
  each leaf to the host.
* :func:`trace`: a context manager around ``torch.profiler`` that writes
  one Chrome/Perfetto trace file.
* ``ops/spans.py`` holds every range and counter of the port:
  ``span(name)``, ``count(name, n)`` and ``host_read(site, tensor)``.
  Behind one gate, ``torch._C._autograd._profiler_enabled()``, a range
  (a ``torch.profiler.record_function``) is opened and a counter moved
  only while a profiler records, under :func:`trace` too; otherwise a
  call is that flag check.  The ranges mark the solvers' phases where the
  JAX package opens a ``jax.named_scope``, with the same names:
  ``lanczos_matvec`` and ``lanczos_reorth`` (``ops/lanczos.py``),
  ``cg_matvec`` and ``bicgstab_matvec`` (``ops/cg.py``); and the layer
  boundaries the benchmark reads: ``ift_backward`` and ``ift_jvp`` (the
  IFT rules, ``ops/eigh.py``), ``tfim_matvec`` (``models/tfim.py``),
  ``lobpcg_rayleigh_ritz`` (``ops/lobpcg.py``), ``restart_reorth``
  (``ops/restart.py``), and ``host_read.<site>`` around each read of a
  device value on the host; and one counter, ``cg_iterations`` (the
  CG's unfrozen steps).  ``spans.RANGES`` and ``spans.HOST_READS`` list
  the ranges; ``spans.counts`` holds the counter.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
import uuid
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..ops.operators import resolve_device


def sync(tree):
    """Block until every tensor in ``tree`` is computed, for real.

    Synchronizes every CUDA device a leaf lives on, then reads one
    element of each non-empty tensor leaf to the host; returns ``tree``
    unchanged.
    """
    leaves = [leaf for leaf in pytree.tree_leaves(tree)
              if isinstance(leaf, torch.Tensor)]
    for dev in {leaf.device for leaf in leaves if leaf.is_cuda}:
        torch.cuda.synchronize(dev)
    for leaf in leaves:
        if leaf.numel():
            leaf.detach().reshape(-1)[0].item()
    return tree


@dataclass
class TimingResult:
    times_s: list[float] = field(default_factory=list)

    @property
    def best(self) -> float:
        return min(self.times_s)

    @property
    def median(self) -> float:
        return float(np.median(self.times_s))

    def __repr__(self):
        return (f"TimingResult(best={self.best*1e3:.3f}ms, "
                f"median={self.median*1e3:.3f}ms, n={len(self.times_s)})")


def timeit(fn, *args, repeats: int = 5, warmup: int = 1) -> TimingResult:
    """Steady-state wall-clock time of ``fn(*args)``: the host's
    ``time.perf_counter`` around ``sync(fn(*args))``, after ``warmup``
    untimed calls."""
    for _ in range(warmup):
        sync(fn(*args))
    res = TimingResult()
    for _ in range(repeats):
        t0 = time.perf_counter()
        sync(fn(*args))
        res.times_s.append(time.perf_counter() - t0)
    return res


@contextlib.contextmanager
def trace(log_dir: str | None = None, *, device=None):
    """Profile the block and write one Chrome/Perfetto trace file into
    ``log_dir`` (default ``<temporary directory>/torch-trace``), named
    ``trace_<pid>_<unique>.json`` so that traces into one directory never
    overwrite each other; yields ``log_dir``.

    With ``device`` unset or CUDA the profiler records the card's
    kernels and copies beside the host's operators (and raises without a
    card); ``device="cpu"`` records the host only.
    """
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "torch-trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{uuid.uuid4().hex[:12]}.json"))
