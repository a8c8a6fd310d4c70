"""read_stall_pct: the share of the traced window, in %, spent in device
idle gaps that open where device work launched inside a
``host_read.<site>`` range of the port ends (the read's device-to-host
copy, or an ``eigh``'s last kernel), on any host thread: the device waits
while the host takes the value and launches what follows.  The rest of
``idle_pct`` is dispatch, the host launching more slowly than the device
runs.

Each side of the test stays on one clock: a gap's start is a device
event's end, and that event is tied to its read by the correlation id of
its launch, which lies inside the range on the launching thread's host
clock.  No device time is compared with a host time."""

import bisect
from collections import defaultdict

from eigbench.lib.trace import idle_gaps

PREFIX = "host_read."


def read(ctx):
    t = ctx.trace
    reads = defaultdict(list)
    for cat, name, s, e, tid in t.host:
        if cat == "user_annotation" and name.startswith(PREFIX):
            reads[tid].append((s, e))
    if not reads or t.window_us <= 0 or not t.device:
        return None
    for spans in reads.values():
        spans.sort()
    ends = set()                 # where the reads' device work ends
    for _, _, _, e, corr in t.device:
        hit = t.runtime.get(corr)
        if hit is None or hit[1] not in reads:
            continue
        ts, spans = hit[0], reads[hit[1]]
        # Reads do not nest: the latest that starts before the launch
        # is the only one that can hold it.
        i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
        if i >= 0 and ts <= spans[i][1]:
            ends.add(min(e, t.hi))
    stalled = sum(b - a for a, b in idle_gaps(
        [(s, e) for _, _, s, e, _ in t.device], t.lo, t.hi) if a in ends)
    return 100.0 * stalled / t.window_us
