"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced run, and the check of the window's answers against
the plain reference.

The loop is closed: one caller sends a solve, waits for it (the solve
ends in ``torch.cuda.synchronize()``) and sends the next.  The window
opens at the first timed solve and closes when the solve running at
``--seconds`` completes; every solve in it counts.  Set-up is everything
before: imports, the CUDA context, loading the port's kernel library,
making the inputs on the device from the seed, and warming the cell's
own shapes.

With ``--trace 1`` the window runs under ``torch.profiler`` for the
traffic mix's ``trace_solves`` solves (or ``--seconds``, whichever ends
first), and the line carries the cell's per-layer metrics instead of its
end-to-end ones.

A driver (``drivers/<name>.py``) gives ``setup``, ``inputs``, ``solve``,
``digest``, ``release``, ``reference`` and ``compare``; see
``drivers/__init__.py``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import sys
import time
from pathlib import Path

from ..reference.seeds import rng
from . import guard
from .loader import Cell
from .spans import sync

PORT = "dominantsparseeigenad_tpu_torch"


class Context:
    """What a driver and a metric reader are handed."""

    def __init__(self, cell: Cell, seed: int, device, port):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.device = device
        self.port = port
        self.trace = None          # lib.trace.Trace of a traced window
        self.n_solves = 0
        self.spans = []            # per traced solve: {span name: ms}


def _sample(cell: Cell, seed: int):
    """The solves whose answers are checked: drawn from the seed among
    the first ``check_within`` of the window."""
    t = cell.traffic
    idx = rng(seed, "checked-solves").choice(
        int(t["check_within"]), int(t["check_solves"]), replace=False)
    return sorted(int(i) for i in idx)


def _stderr(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float | None = None, log=_stderr):
    """The result object of one run (see the module docstring); ``log``
    takes the run's diagnostic lines (set-up phases, every latency)."""
    import torch

    if t_start is None:
        t_start = time.perf_counter()
    phases = {"imports": time.perf_counter()}
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
    phases["cuda_context"] = time.perf_counter()
    port = importlib.import_module(PORT)
    phases["port_import"] = time.perf_counter()
    drv = cell.driver
    ctx = Context(cell, seed, device, port)
    traffic = cell.traffic

    state = drv.setup(ctx)
    sync(device)
    phases["inputs"] = time.perf_counter()
    for w in range(int(traffic["warm_solves"])):
        drv.solve(state, drv.inputs(state, w, "warm"), None)
        sync(device)
    sample = _sample(cell, seed)
    gc.collect()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    phases["warm_solves"] = time.perf_counter()
    setup_s = phases["warm_solves"] - t_start
    last = t_start
    for name, t in phases.items():
        phases[name], last = t - last, t
    log(f"setup phases (s): {json.dumps(phases)}")

    latencies, digests, spans = [], {}, []
    limit_solves = int(traffic["trace_solves"]) if trace else None
    # peak_gib is read after a fixed number of solves, not at the close:
    # per-solve objects that the program leaves in reference cycles free
    # their device memory only when Python's cyclic collector runs, so
    # the peak climbs with the solves a window holds (tfim_n24.restart on
    # an H100: 3.8, 4.5, 5.5 GiB after 5, 17, 45 solves), and a faster
    # program would read a higher peak over the same seconds.
    peak_solves = int(traffic["peak_solves"])
    peak_first = None
    # The program's peak outside the check's own digests: the allocator's
    # peak is read before each digest and reset after it, so what a digest
    # makes on the device (float64 copies of gradient chunks) never counts.
    held = 0
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        t0 = time.perf_counter()
        i = 0
        while True:
            inp = drv.inputs(state, i, "timed")
            solve_spans = {} if trace else None
            ta = time.perf_counter()
            if trace:
                with torch.profiler.record_function("eigbench_solve"):
                    out = drv.solve(state, inp, solve_spans)
                    sync(device)
            else:
                out = drv.solve(state, inp, None)
                sync(device)
            tb = time.perf_counter()
            latencies.append(tb - ta)
            if len(latencies) == peak_solves and cuda:
                peak_first = max(held, torch.cuda.max_memory_allocated())
            if trace:
                spans.append(solve_spans)
            if i in sample:
                if cuda:
                    held = max(held, torch.cuda.max_memory_allocated())
                digests[i] = drv.digest(state, inp, out)
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
            # Nothing of a solve outlives it: the next inputs are made with
            # none of these held, and the checked solves' inputs are made
            # again from the seed for the reference.
            out = inp = None
            i += 1
            # The checked solves always lie in the window (at the cells'
            # sizes the window holds many more).
            if trace:
                done = i >= limit_solves or tb - t0 >= seconds
            else:
                done = i >= peak_solves and tb - t0 >= seconds
            if i > sample[-1] and done:
                break
        window_s = tb - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    n = len(latencies)
    peak = max(held, torch.cuda.max_memory_allocated()) if cuda else 0
    log(f"window: {n} solves in {window_s!r} s; latencies (s): "
        f"{json.dumps(latencies)}")

    metrics, breakdown, dev_extra = {}, None, {}
    if not trace:
        values = {"setup_s": setup_s, "solve_s": window_s / n,
                  "peak_gib": (peak_first or 0) / 2**30}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        from .trace import Trace
        path = Path(os.environ.get("TMPDIR", "/tmp")) / \
            f"eigbench_trace_{os.getpid()}.json"
        prof.export_chrome_trace(str(path))
        try:
            ctx.trace = Trace.load(path)
        finally:
            path.unlink(missing_ok=True)
        del prof
        ctx.n_solves, ctx.spans = n, spans
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy = ctx.trace.busy_us() * 1e-6
        dev_extra = {"busy_s": busy, "window_s": ctx.trace.window_us * 1e-6}
        breakdown = {"device_ops": ctx.trace.device_ops(),
                     "idle_gaps": ctx.trace.idle_by_host()}
        ctx.trace = None

    # The program's state goes before the reference runs.
    drv.release(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    limits = traffic["limits"]
    worst = {name: 0.0 for name in limits}
    failed = 0
    for i in sorted(digests):
        ref = drv.reference(state, drv.inputs(state, i, "timed"), "f64")
        nums = drv.compare(digests[i], ref)
        if any(not math.isfinite(v) or v > limits[k]
               for k, v in nums.items()):
            failed += 1
        for k, v in nums.items():
            worst[k] = v if not math.isfinite(v) else max(worst[k], v)
    correct = (failed == 0 and len(digests) == len(sample)
               and all(math.isfinite(v) for v in worst.values()))

    result = {"correct": bool(correct), "attempted": n, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if cuda
                                  else "cpu"),
                         "count": cell.chips,
                         "memory_peak_bytes": int(peak), **dev_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked_solves"] = sorted(digests)
    result["checks"] = {k: {"value": worst[k], "limit": limits[k]}
                        for k in limits}
    return result


def nvidia_smi_name_power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else out.stderr.strip()


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("eigbench: no CUDA device; this benchmark runs only on the "
              "card", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"eigbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                 t_start)
    print(f"eigbench: {args.workload} seed {args.seed} on "
          f"{nvidia_smi_name_power()}", file=sys.stderr)
    bad = guard.forbidden_modules()
    if bad:
        print(f"eigbench: JAX modules loaded in this process: {bad}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
