"""The traced run's device trace, reduced in memory.

``torch.profiler`` records the card's kernels, copies and memsets (and
the CUDA runtime calls that launch them) over the window; no trace file
is written.  The profiler has come back without device time on the card,
then for every profile of a process: ``profiler_works`` takes a short
probe profile up to three times before the window, and a window whose
profile holds no device event reports no device metric.

Busy time is the union of the device intervals, so copies on another
stream that overlap kernels count once.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

def _activities():
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CUDA]


def _events(prof):
    """(device events [(name, start_ns, end_ns)], runtime events [(name,
    start_ns, end_ns)]) of a finished profile."""
    device, runtime = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        rec = (e.name(), start, start + e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(rec)
        elif e.name().startswith("cuda"):
            runtime.append(rec)
    return device, runtime


def profiler_works(tries: int = 3) -> bool:
    """True once a probe profile of a small device computation holds
    device time."""
    from torch.profiler import profile

    x = torch.ones(1 << 20, device="cuda")
    for _ in range(tries):
        with profile(activities=_activities()) as prof:
            (x * 2).sum().item()
            torch.cuda.synchronize()
        if _events(prof)[0]:
            return True
    return False


class Trace:
    """What the readers of per-layer metrics see of a traced window."""

    def __init__(self, device, runtime, window_s):
        self.device = sorted(device, key=lambda e: e[1])
        self.runtime = sorted(runtime, key=lambda e: e[1])
        self.window_s = window_s
        self.merged = union(self.device)
        self.busy_s = sum(e - s for s, e in self.merged) / 1e9

    def seconds_where(self, pred) -> float:
        """Device seconds of the events whose name ``pred`` accepts (their
        own union)."""
        return sum(e - s for s, e in union(
            [ev for ev in self.device if pred(ev[0])])) / 1e9

    def count_where(self, pred) -> int:
        return sum(1 for ev in self.device if pred(ev[0]))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps, each named by the runtime call the host was in at the
        gap's middle (or the device operation that ended it)."""
        by_name = defaultdict(int)
        for name, s, e in self.device:
            by_name[name] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        for (_, end), (start, _) in zip(self.merged, self.merged[1:]):
            if start > end:
                gaps.append((start - end, end, start))
        gaps.sort(reverse=True)
        rt_starts = [r[1] for r in self.runtime]
        dev_starts = [d[1] for d in self.device]
        named = []
        for length, s, e in gaps[:top]:
            mid = (s + e) // 2
            i = bisect.bisect_right(rt_starts, mid) - 1
            if i >= 0 and self.runtime[i][2] >= mid:
                label = "host in " + self.runtime[i][0]
            else:
                nxt = self.device[bisect.bisect_left(dev_starts, e)][0]
                label = "before " + nxt
            named.append([label[:160], length / 1e9])
        return {"device_ops": [[n[:160], t / 1e9] for n, t in ops],
                "idle_gaps": named}


def union(events):
    """Merged [(start_ns, end_ns)] of the events' intervals."""
    out = []
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def traced(body):
    """Run ``body()`` under the profiler -> (its result, ``Trace`` or None
    when the profile holds no device event)."""
    from torch.profiler import profile

    with profile(activities=_activities()) as prof:
        t0 = time.perf_counter()
        result = body()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device, runtime = _events(prof)
    if not device:
        return result, None
    return result, Trace(device, runtime, window_s)
