"""The program's own spans over the traced window.

``ams_tpu_torch.utils.trace.GLOBAL_TIMER`` records a span (name, start,
end, its id, the id of the span around it, request id) only while a
profile is active.  In a run only the traced window runs under one
(``trace.profiler_works``' probes call no program code), so its records
are exactly the traced window's.  Spans and device events share kineto's
clock (Unix-epoch nanoseconds), so a span's device-idle time is its
length less its overlap with the trace's busy intervals.  The device's
events are converted to that clock, and on an H100 they stray from the
runtime calls that launch them by up to some hundreds of microseconds
(PERF.md): a span's idle time is good to about that much at each end
where the device works.

A program without such records (one older than its spans) leaves every
reader of this module with nothing to read: they return None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from perfbench.lib.trace import union


def records(ctx) -> list:
    """The program's span records of the run, [] without a trace or
    without records."""
    if ctx.trace_data is None:
        return []
    from ams_tpu_torch.utils.trace import GLOBAL_TIMER

    return list(getattr(GLOBAL_TIMER, "records", ()))


def named(recs, name) -> list:
    """The records called ``name``."""
    return [r for r in recs if r.name == name]


def merged(intervals) -> list:
    """Merged [[start, end]] of (start, end) pairs."""
    return union([(None, s, e) for s, e in intervals])


class Busy:
    """The trace's busy intervals, indexed to give the busy time before
    any instant by bisection."""

    def __init__(self, trace):
        self.intervals = trace.merged
        self.starts = [s for s, _ in self.intervals]
        self.before_each = [0]
        for s, e in self.intervals:
            self.before_each.append(self.before_each[-1] + e - s)

    def before(self, t) -> int:
        """Busy nanoseconds before ``t``."""
        k = bisect.bisect_left(self.starts, t)
        if k == 0:
            return 0
        s, e = self.intervals[k - 1]
        return self.before_each[k - 1] + min(e, t) - s

    def idle_in(self, intervals) -> int:
        """Idle nanoseconds inside the union of ``intervals``."""
        return sum((e - s) - (self.before(e) - self.before(s))
                   for s, e in merged(intervals))


def idle_inside(trace, recs, names) -> int:
    """Device-idle nanoseconds inside the union of the spans called one
    of ``names``: the union's length less its busy time."""
    return Busy(trace).idle_in([(r.start_ns, r.end_ns) for r in recs
                                if r.name in names])


def self_intervals(recs) -> dict:
    """{span id: [(start, end)] of the span not covered by a span inside
    it}."""
    children = defaultdict(list)
    for r in recs:
        if r.parent >= 0:
            children[r.parent].append((r.start_ns, r.end_ns))
    out = {}
    for r in recs:
        free, at = [], r.start_ns
        for s, e in merged(children[r.id]):
            if s > at:
                free.append((at, min(s, r.end_ns)))
            at = max(at, e)
        if at < r.end_ns:
            free.append((at, r.end_ns))
        out[r.id] = free
    return out


def mean_self_ns(recs, name):
    """Mean self time of the spans called ``name`` (length less the union
    of the spans inside), or None without one."""
    free = self_intervals(recs)
    times = [sum(e - s for s, e in free[r.id]) for r in named(recs, name)]
    return sum(times) / len(times) if times else None
