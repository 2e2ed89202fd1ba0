"""The port's tracer: spans on the main path, the kernels' launch counters,
and `StageTimer`.

`StageTimer` collects host-clock samples by name and reports each name's
count, mean, least, most and total milliseconds, like the reference's
`Tracking::PrintTimeStats` (`Tracking.cc:253`, `LocalMapping.cc:92-117`);
a sample over `slow_threshold_ms` goes to `on_slow`, like the >3 ms print
of the reference wrapper's timers (`include/orb_slam3_wrapper.h:128-143`).

The tracer is one per process, built on a `StageTimer`:

* `span(name, frame=None)` is a context manager and `traced(name)` a
  decorator; each marks a stretch of the main path. A span records its
  name, its start and end in `time.perf_counter_ns()`, its parent (the
  span open around it) and the frame it serves: the tracker's submission
  count of that frame, given where the span opens or taken from the
  parent. Names are `<layer>.<what>` (`frontend.make_frame`,
  `mapping.chain`); the kernels' own spans are `k1`, `k2`, `k3`.
* `count_launch(kernel)` counts a launch of a hand-written kernel as
  `<kernel>.launches`, whether the tracer records or not, so a run can
  show that its main path went through the kernel; `counter(name)` reads
  one.
* `enable()`, `disable()`, `reset()`, `snapshot()`. Spans live in memory;
  the snapshot hands them out with the counters and a `StageTimer`
  report of them by name, each name's self time (its spans' time less
  their children's) added. Nothing is written to disk.

A fresh process's tracer records while a `torch.profiler` session
records, so a profiled stretch carries the program's spans without a
call from the profiling code; `enable()` makes it record always,
`disable()` never. Where it does not record, a span site tests two module
globals and the profiler's flag and returns one shared object that does
nothing; it builds no string and touches neither the device nor its
allocator.
While it records, each span also opens the profiler's fast record
function (`torch._C._profiler._RecordFunctionFast`) named `"dvm:" + name`,
which puts it in the profiler's event stream as a host event beside the
kernels launched inside it. Unlike `torch.profiler.record_function`, it
leaves no copy of itself on the device's timeline, where a span would
read as work, and costs a tenth as much. The profiler stamps its host
events by CLOCK_REALTIME and `perf_counter_ns` reads CLOCK_MONOTONIC:
`realtime_offset_ns()` is the difference, which lays a span onto the
profiler's clock.

The main path runs on one host thread, and so does the tracer.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Dict, List

import torch


class StageTimer:
    """Accumulates per-stage wall-clock samples; `report()` = mean/min/max
    like `PrintTimeStats`. `slow_threshold_ms` spans are surfaced like the
    wrapper's >3 ms print."""

    def __init__(self, slow_threshold_ms: float = 3.0, on_slow=None):
        self.samples: Dict[str, List[float]] = collections.defaultdict(list)
        self.slow_threshold_ms = slow_threshold_ms
        self.on_slow = on_slow
        self._open: Dict[str, float] = {}

    def start(self, name: str):
        self._open[name] = time.perf_counter()

    def stop(self, name: str):
        t0 = self._open.pop(name, None)
        if t0 is None:
            return 0.0
        return self.add(name, (time.perf_counter() - t0) * 1e3)

    def add(self, name: str, ms: float):
        """Record one sample of `ms` milliseconds under `name`."""
        self.samples[name].append(ms)
        if ms > self.slow_threshold_ms and self.on_slow is not None:
            self.on_slow(name, ms)
        return ms

    @contextlib.contextmanager
    def span(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def report(self):
        out = {}
        for name, xs in self.samples.items():
            out[name] = {
                "n": len(xs),
                "mean_ms": sum(xs) / len(xs),
                "min_ms": min(xs),
                "max_ms": max(xs),
                "total_ms": sum(xs),
            }
        return out


# --------------------------------------------------------------------------
# the process's tracer
# --------------------------------------------------------------------------

SPAN_FIELDS = ("id", "name", "start_ns", "end_ns", "parent", "frame")

_profiling = torch._C._autograd._profiler_enabled   # True while a profiler session records
_event = torch._C._profiler._RecordFunctionFast
_on = False              # enable()d: record always
_follow = True           # record while a profiler session records
_spans: list = []        # closed spans, tuples in SPAN_FIELDS' order (parent -1: none)
_open: list = []         # the open spans, innermost last
_next_id = 0
_counts: collections.Counter = collections.Counter()


class _Null:
    """The span of a tracer that does not record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("id", "name", "frame", "parent", "t0", "rf")

    def __init__(self, name: str, frame):
        self.name = name
        self.frame = frame

    def __enter__(self):
        global _next_id
        parent = _open[-1] if _open else None
        self.id = _next_id
        _next_id += 1
        self.parent = -1 if parent is None else parent.id
        if self.frame is None and parent is not None:
            self.frame = parent.frame
        _open.append(self)
        # the times are read inside the profiler's event: entering it may
        # first grow the profiler's buffers, then it stamps its start
        self.rf = _event("dvm:" + self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _open.pop()
        _spans.append((self.id, self.name, self.t0, t1, self.parent, self.frame))
        return False


def span(name: str, frame=None):
    """A span around a `with` block; `frame` the frame it serves (None:
    its parent's)."""
    if not (_on or (_follow and _profiling())):
        return _NULL
    return _Span(name, frame)


def traced(name: str):
    """Decorator: each call of the function is a span named `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_on or (_follow and _profiling())):
                return fn(*args, **kwargs)
            with _Span(name, None):
                return fn(*args, **kwargs)

        return call

    return wrap


def count_launch(kernel: str):
    """Count one launch of a hand-written kernel (`k1`, `k2`, `k3`), always."""
    _counts[kernel + ".launches"] += 1


def counter(name: str) -> int:
    return _counts[name]


def enable():
    """Record from now on, whether a profiler session records or not."""
    global _on
    _on = True


def disable():
    """Record nothing, whether a profiler session records or not."""
    global _on, _follow
    _on = _follow = False


def reset():
    """Forget every closed span and every counter (the launch counts too);
    call it between frames, with no span open."""
    global _next_id
    _spans.clear()
    _counts.clear()
    _next_id = 0


def realtime_offset_ns() -> int:
    """CLOCK_REALTIME less `perf_counter_ns()`, from the tightest of five
    paired reads: add it to a span's times to place them on the
    profiler's clock."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        r = time.clock_gettime_ns(time.CLOCK_REALTIME)
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, r - (a + b) // 2)
    return best[1]


def snapshot() -> dict:
    """The spans in the order they opened (dicts of SPAN_FIELDS), the
    counters, a `StageTimer` report of the spans by name with `self_ms`
    added, and `realtime_offset_ns`."""
    spans = sorted(_spans)
    children = collections.Counter()
    for s in spans:
        if s[4] >= 0:
            children[s[4]] += s[3] - s[2]
    timer = StageTimer()
    self_ms = collections.Counter()
    for s in spans:
        timer.add(s[1], (s[3] - s[2]) * 1e-6)
        self_ms[s[1]] += (s[3] - s[2] - children[s[0]]) * 1e-6
    report = timer.report()
    for name, r in report.items():
        r["self_ms"] = self_ms[name]
    return {"spans": [dict(zip(SPAN_FIELDS, s)) for s in spans], "counters": dict(_counts),
            "report": report, "realtime_offset_ns": realtime_offset_ns()}
