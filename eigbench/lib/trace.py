"""Reading a ``torch.profiler`` Chrome trace: the device's intervals, the
kernels by name, the host's named ranges, and which host range launched
which device work.

The traced window is the span of the harness's own ``eigbench_solve``
ranges: it opens where the first traced solve starts on the host and
closes where the last one ends, after its synchronize, so every device
interval of those solves lies inside it.  Times are in microseconds, as
the trace writes them.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from pathlib import Path

SOLVE_RANGE = "eigbench_solve"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    ``[lo, hi]``."""
    busy, cur_lo, cur_hi = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_hi is None or s > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = s, e
        else:
            cur_hi = max(cur_hi, e)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    return busy


def idle_gaps(intervals, lo: float, hi: float):
    """The ``(start, end)`` stretches of ``[lo, hi]`` that no interval
    covers, in time order."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


class Trace:
    """The events of one trace, sorted into what the readers ask for."""

    def __init__(self, events):
        self.device = []          # (cat, name, ts, end, correlation)
        self.host = []            # (cat, name, ts, end, tid)
        self.runtime = {}         # correlation -> (ts, tid)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            ts = float(e.get("ts", 0.0))
            end = ts + float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((cat, e.get("name", ""), ts, end, corr))
            elif cat in RUNTIME_CATS and corr is not None:
                self.runtime[corr] = (ts, e.get("tid"))
            elif cat in HOST_CATS:
                self.host.append((cat, e.get("name", ""), ts, end,
                                  e.get("tid")))
        solves = self.ranges(SOLVE_RANGE)
        if solves:
            self.lo = min(s for s, _, _ in solves)
            self.hi = max(e for _, e, _ in solves)
            self.solve_tid = solves[0][2]
        else:
            self.lo = self.hi = 0.0
            self.solve_tid = None

    @classmethod
    def load(cls, path):
        return cls(json.loads(Path(path).read_text())["traceEvents"])

    # ---- the window ------------------------------------------------
    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    def busy_us(self) -> float:
        """Time in the window in which a kernel, copy or memset ran."""
        return union_length([(s, e) for _, _, s, e, _ in self.device],
                            self.lo, self.hi)

    def idle_share(self):
        """The share of the window with no device activity, or None
        where the trace holds no window or no device activity."""
        if self.window_us <= 0 or not self.device:
            return None
        return 1.0 - self.busy_us() / self.window_us

    # ---- host ranges and what they launched ---------------------------
    def ranges(self, name: str):
        """``(start, end, tid)`` of the host ranges named ``name``."""
        return [(s, e, tid) for cat, n, s, e, tid in self.host
                if cat == "user_annotation" and n == name]

    def count_ranges(self, name: str) -> int:
        return sum(1 for s, e, _ in self.ranges(name)
                   if self.lo <= s <= self.hi)

    def device_us_under(self, name: str):
        """``(device µs, launches)`` of the device work launched inside
        the host ranges named ``name``: each kernel, copy or memset is
        tied to its launch by the correlation id, and counted where the
        launch lies inside such a range on the same thread."""
        by_tid = defaultdict(list)
        for s, e, tid in self.ranges(name):
            by_tid[tid].append((s, e))
        starts = {tid: sorted(v) for tid, v in by_tid.items()}
        total, launches = 0.0, 0
        for _, _, s, e, corr in self.device:
            hit = self.runtime.get(corr)
            if hit is None:
                continue
            t, tid = hit
            spans = starts.get(tid)
            if not spans:
                continue
            # Ranges of one name do not nest: the latest that starts
            # before the launch is the only one that can hold it.
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and t <= spans[i][1]:
                total += e - s
                launches += 1
        return total, launches

    # ---- kernels by name -------------------------------------------
    def kernels(self, pattern: str):
        """Durations (µs) of the window's kernels whose name matches the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        return [e - s for cat, n, s, e, _ in self.device
                if cat == "kernel" and rx.search(n)
                and self.lo <= s <= self.hi]

    def kernel_count(self) -> int:
        return sum(1 for cat, _, s, _, _ in self.device
                   if cat == "kernel" and self.lo <= s <= self.hi)

    # ---- breakdown -------------------------------------------------
    def device_ops(self, top: int = 10):
        """``[[name, seconds], ...]``: the device operations of the
        window with the most time, summed by name."""
        acc = defaultdict(float)
        for _, n, s, e, _ in self.device:
            if self.lo <= s <= self.hi:
                acc[n] += (min(e, self.hi) - s) * 1e-6
        return [[n, t] for n, t in sorted(acc.items(),
                                         key=lambda kv: -kv[1])[:top]]

    def idle_by_host(self, top: int = 10):
        """``[[name, seconds], ...]``: the window's idle device time,
        each gap named by the innermost host event that covers its middle
        on the solving thread, summed by name."""
        gaps = idle_gaps([(s, e) for _, _, s, e, _ in self.device],
                         self.lo, self.hi)
        events = sorted(((s, -e, n) for _, n, s, e, tid in self.host
                         if tid == self.solve_tid), key=lambda x: x[:2])
        points = sorted(((a + b) / 2, b - a) for a, b in gaps)
        acc = defaultdict(float)
        stack, i = [], 0
        for mid, length in points:
            while i < len(events) and events[i][0] <= mid:
                s, neg_e, n = events[i]
                while stack and stack[-1][0] <= s:
                    stack.pop()
                stack.append((-neg_e, n))
                i += 1
            while stack and stack[-1][0] < mid:
                stack.pop()
            acc[stack[-1][1] if stack else "(no host event)"] += \
                length * 1e-6
        return [[n, t] for n, t in sorted(acc.items(),
                                         key=lambda kv: -kv[1])[:top]]
