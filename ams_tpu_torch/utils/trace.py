"""Spans and the profiler's Chrome trace.

Counterpart of ``ams_tpu/utils/trace.py``.  ``PhaseTimer.span(name)``
times a named block.  Every span adds its wall-clock seconds to
``totals`` and one to ``counts``, which ``summary()`` prints (the CLIs do
after their loops).

While a ``torch.profiler`` profile is active in the process, and only
then, a span also appends a ``SpanRecord`` to ``records`` when it
closes:

- its start and end in Unix-epoch nanoseconds (``time.time_ns``), the
  clock kineto stamps host events with and converts device events to,
  so a span and a kernel of the same profile compare directly, to the
  conversion's error (``perfbench/lib/spans.py`` measures it per trace);
- its own id, and the id of the span open around it on the same thread
  (each thread keeps its own stack of open spans);
- its request: the id of the span with no span around it that it lies
  in (such a span is its own request).

``PhaseTimer.count(name)`` counts an event that has no length: it adds
one to ``counts``, and while a profile is active it also appends a
zero-length ``SpanRecord`` at that instant, inside the span open on the
thread, so that the benchmark's readers find it in the traced window.

Records stay in memory until read (``perfbench/lib/spans.py`` reads
them) or written by ``profile_trace``.  A span puts no event into the
profile: a user annotation of a CUDA profile can appear as a device
event and would count as device time.  Recording takes no lock beyond
the one around ``totals`` and ``counts`` and makes no system call beyond
reading the clock.

``profile_trace`` wraps a block in ``torch.profiler`` (host, and the card
when there is one) and writes a Chrome trace into the trace directory,
the block's spans on a track of their own above the host's and the
card's (open it in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

SPAN_PID = 1 << 30      # the Chrome trace's track of the program's spans


def _recording() -> bool:
    """True while a profile is active in the process.  torch's own flag
    is read in every thread; ``torch._C._autograd._profiler_enabled()``
    is true only in the thread that started the profile."""
    return torch.autograd.profiler._is_profiler_enabled


class SpanRecord(NamedTuple):
    """One closed span of a profiled block (module docstring)."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int         # id of the enclosing span, or -1
    request: int        # id of the outermost span around it (or its own)
    thread: int         # the native thread id


class PhaseTimer:
    """Named wall-clock spans: totals and counts always, records while a
    profile is active (module docstring)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.records: List[SpanRecord] = []
        self._local = threading.local()
        self._ids = itertools.count()
        self._lock = threading.Lock()   # totals and counts, from any thread

    def _add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def _state(self):
        """This thread's stack of open spans and its native id."""
        try:
            return self._local.state
        except AttributeError:
            self._local.state = [], threading.get_native_id()
            return self._local.state

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if not _recording():
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._add(name, time.perf_counter() - t0)
            return
        stack, thread = self._state()
        ident = next(self._ids)
        parent, request = stack[-1] if stack else (-1, ident)
        stack.append((ident, request))
        start = time.time_ns()
        try:
            yield
        finally:
            end = time.time_ns()
            stack.pop()
            self.records.append(SpanRecord(name, start, end, ident, parent,
                                           request, thread))
            self._add(name, (end - start) / 1e9)

    def count(self, name: str) -> None:
        """One event called ``name``: one more in ``counts``, and while a
        profile is active a zero-length record (module docstring)."""
        with self._lock:
            self.counts[name] += 1
        if not _recording():
            return
        stack, thread = self._state()
        ident = next(self._ids)
        parent, request = stack[-1] if stack else (-1, ident)
        now = time.time_ns()
        self.records.append(SpanRecord(name, now, now, ident, parent,
                                       request, thread))

    def summary(self) -> str:
        lines = ["%-28s %8s %10s %10s" % ("phase", "count", "total_s",
                                          "mean_ms")]
        for name in sorted(self.totals):
            n = self.counts[name]
            lines.append("%-28s %8d %10.2f %10.1f"
                         % (name, n, self.totals[name],
                            1000 * self.totals[name] / max(n, 1)))
        return "\n".join(lines)

    def reset(self):
        """Forget totals, counts and records."""
        with self._lock:
            self.totals.clear()
            self.counts.clear()
        self.records.clear()


GLOBAL_TIMER = PhaseTimer()


def _add_spans_to_chrome_trace(path: str, records: List[SpanRecord]) -> None:
    """Append ``records`` to the Chrome trace at ``path`` as complete
    events on the track ``SPAN_PID``, one row per thread, in the file's
    own time base (microseconds after ``baseTimeNanoseconds``)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": SPAN_PID,
                   "tid": 0, "args": {"name": "program spans"}})
    for r in records:
        events.append({
            "ph": "X", "cat": "span", "name": r.name, "pid": SPAN_PID,
            "tid": r.thread, "ts": round((r.start_ns - base) / 1e3, 3),
            "dur": round((r.end_ns - r.start_ns) / 1e3, 3),
            "args": {"request": r.request}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler over the block, its Chrome trace written to
    ``trace_dir/trace_<pid>.json`` with the block's ``GLOBAL_TIMER``
    spans; a no-op when trace_dir is empty."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    first = len(GLOBAL_TIMER.records)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    path = os.path.join(trace_dir, "trace_%d.json" % os.getpid())
    prof.export_chrome_trace(path)
    _add_spans_to_chrome_trace(path, GLOBAL_TIMER.records[first:])
