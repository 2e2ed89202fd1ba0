"""The program's own spans joined with the device trace of a traced run.

The program (`dvm_slam_tpu_torch/utils/profiling.py`) records its spans
while the profiler records: each span is a `dvm:<layer>.<what>` host event
in the profiler's stream and a row of the tracer's `snapshot()`, on the
host's monotonic clock, with the frame it serves. `join` reads the
profiler's events in memory:

* each kernel or copy to the runtime call that launched it, by the
  profiler's correlation id, and each call to the innermost `dvm:` span
  open at its start; a launch with no span open is `outside_the_spans`;
* launches and device milliseconds summed by span and by layer (the first
  of the front end, tracking and mapping found from the innermost span
  outwards, else `other`, or `outside_the_spans`);
* the device's idle gaps charged to the innermost `dvm:` span;
* the host's waits on the device by span: the runtime's synchronising
  calls, and its copies to or from pageable host memory, which return
  only once the stream has run up to them (a read of a device value, an
  upload of a host constant); the keyframes made (`mapping.add_keyframe`).

With the snapshot it adds each traced frame's three lane parts (its
submit to its step's start, its step, its step's end to its retire) and
how far the tracer's clock lies from the profiler's. The window is the
harness's `pb:window` span, as for `reduce_profile`.

`from_readings` finds the run's profiler session and the snapshot for the
metric readers: the harness hands neither to them, so the profiler is
taken from the run's `Stretch`, found among the live objects by the
latencies list it shares with the readings. Where the program records no
span (a program without the tracer) it gives None, and so do the
readers; where it recorded spans and the run's profiler cannot be found,
it raises.
"""

from __future__ import annotations

import collections
import gc

from .tracing import WINDOW_SPAN, _dur_ns, _merge, _start_ns

OUTSIDE = "outside_the_spans"
LAYERS = ("frontend", "tracking", "mapping")
WAITS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")
PAGEABLE = "Pageable"    # in the name of a copy to or from pageable host memory
LANE = ("lane.submit", "lane.step", "lane.retire")


def _kind(e) -> str:
    """"kernel", "copy", "runtime", "span", "window" or "" for a profiler
    event; by device and name where it has no activity type (older kineto
    bindings). Device-side copies of host spans are not work."""
    name = e.name()
    on_host = str(e.device_type()).endswith("CPU")
    if name.startswith(("dvm:", "pb:")):
        if not on_host:
            return ""
        return "span" if name.startswith("dvm:") else ("window" if name == WINDOW_SPAN else "")
    kind = e.activity_type() if hasattr(e, "activity_type") else None
    if kind is not None:
        return {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "copy",
                "cuda_runtime": "runtime", "cuda_driver": "runtime"}.get(kind, "")
    if on_host:
        return "runtime" if name.startswith("cu") else ""
    return "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"


def _layer(name: str) -> str:
    return name.split(".", 1)[0]


class _Sweep:
    """The innermost span open at each of a rising series of host times
    (spans nest: they are calls on one host thread)."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))   # (start, end, name); outer first
        self.i = 0
        self.stack = []

    def at(self, t):
        while self.i < len(self.spans) and self.spans[self.i][0] <= t:
            s = self.spans[self.i]
            while self.stack and self.stack[-1][1] <= s[0]:
                self.stack.pop()
            self.stack.append(s)
            self.i += 1
        while self.stack and self.stack[-1][1] <= t:
            self.stack.pop()
        return self.stack

    def name_and_layer(self, t):
        stack = self.at(t)
        if not stack:
            return OUTSIDE, OUTSIDE
        for s in reversed(stack):
            if _layer(s[2]) in LAYERS:
                return stack[-1][2], _layer(s[2])
        return stack[-1][2], "other"


def join(events, snap=None, frames=None) -> dict:
    """The readings of the program's spans in one traced stretch (see the
    module's docstring); {} without the window or without `dvm:` spans."""
    win, spans, device, runtime, pageable = None, [], [], {}, set()
    for e in events:
        kind = _kind(e)
        if not kind:
            continue
        s = _start_ns(e)
        iv = (s, s + _dur_ns(e))
        if kind == "window":
            win = iv
        elif kind == "span":
            spans.append(iv + (e.name()[4:],))
        elif kind == "runtime":
            runtime[e.correlation_id()] = iv + (e.name(),)
        else:
            device.append(iv + (kind, e.correlation_id()))
            if kind == "copy" and PAGEABLE in e.name():
                pageable.add(e.correlation_id())
    if win is None or not spans:
        return {}
    w0, w1 = win
    spans = [s for s in spans if s[1] > w0 and s[0] < w1]
    device = [(max(s, w0), min(e, w1), k, c) for s, e, k, c in device if e > w0 and s < w1]

    # launches and device time, by the span open at the launching call
    linked = [(runtime[c][0], e - s, k) for s, e, k, c in device if c in runtime]
    unlinked = [(e - s, k) for s, e, k, c in device if c not in runtime]
    by_span = collections.defaultdict(lambda: [0, 0.0])
    by_layer = collections.defaultdict(lambda: [0, 0.0])
    sweep = _Sweep(spans)
    for t, dur, kind in sorted(linked):
        name, layer = sweep.name_and_layer(t)
        for acc in (by_span[name], by_layer[layer]):
            acc[0] += kind == "kernel"
            acc[1] += dur * 1e-6
    for dur, kind in unlinked:
        for acc in (by_span[OUTSIDE], by_layer[OUTSIDE]):
            acc[0] += kind == "kernel"
            acc[1] += dur * 1e-6

    # idle gaps, split at the span boundaries, charged to the innermost span
    busy = _merge([(s, e) for s, e, _, _ in device])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    bounds = sorted({x for s, e, _ in spans for x in (s, e) if w0 < x < w1})
    idle = collections.defaultdict(float)
    sweep = _Sweep(spans)
    j = 0
    for s, e in gaps:
        while j < len(bounds) and bounds[j] <= s:
            j += 1
        cuts = [s]
        while j < len(bounds) and bounds[j] < e:
            cuts.append(bounds[j])
            j += 1
        cuts.append(e)
        for a, b in zip(cuts, cuts[1:]):
            idle[sweep.name_and_layer(a)[0]] += (b - a) * 1e-6

    # the host's waits on the device, by the span they lie in
    waits = collections.defaultdict(lambda: [0, 0.0])
    sweep = _Sweep(spans)
    for c, (s, e, name) in sorted(runtime.items(), key=lambda kv: kv[1]):
        if (name in WAITS or c in pageable) and w0 <= s < w1:
            acc = waits[sweep.name_and_layer(s)[0]]
            acc[0] += 1
            acc[1] += (e - s) * 1e-6

    out = dict(
        frames=frames,
        launches=sum(v[0] for v in by_layer.values()),
        launches_by_layer={k: v[0] for k, v in by_layer.items()},
        device_ms_by_layer={k: v[1] for k, v in by_layer.items()},
        launches_by_span={k: v[0] for k, v in by_span.items()},
        device_ms_by_span={k: v[1] for k, v in by_span.items()},
        idle_ms_by_span=dict(idle),
        waits_by_span={k: list(v) for k, v in waits.items()},
        unlinked=len(unlinked),
        keyframes=sum(1 for s in spans if s[2] == "mapping.add_keyframe" and s[0] >= w0),
    )
    if snap is not None:
        out.update(_with_snapshot(snap, spans, w0, w1))
    return out


def _with_snapshot(snap, spans, w0, w1) -> dict:
    """The lane parts of each frame inside the window, and the clock
    check: each program span's start, laid on the profiler's clock,
    against its `dvm:` event's."""
    off = snap["realtime_offset_ns"]
    mine = [s for s in snap["spans"] if w0 <= s["start_ns"] + off and s["end_ns"] + off <= w1]
    marks = collections.defaultdict(dict)
    for s in mine:
        if s["name"] in LANE and s["frame"] is not None:
            marks[s["frame"]][s["name"]] = s
    lane = []
    for f in sorted(marks):
        m = marks[f]
        if len(m) < 3:
            continue
        sub, step, ret = (m[k] for k in LANE)
        lane.append([f, (step["start_ns"] - sub["start_ns"]) * 1e-6,
                     (step["end_ns"] - step["start_ns"]) * 1e-6,
                     (ret["end_ns"] - step["end_ns"]) * 1e-6])
    # the clock: the k-th span of a name against the k-th `dvm:` event of it
    theirs = collections.defaultdict(list)
    for s, _, name in sorted(spans):
        theirs[name].append(s)
    ours = collections.defaultdict(list)
    for s in sorted(mine, key=lambda s: s["start_ns"]):
        ours[s["name"]].append(s["start_ns"] + off)
    gaps = sorted((abs(a - b), name) for name in ours if len(ours[name]) == len(theirs[name])
                  for a, b in zip(ours[name], theirs[name]))
    us = [g * 1e-3 for g, _ in gaps]
    clock = {"offset_ns": off, "spans": len(gaps),
             "unpaired": sum(len(v) for v in ours.values()) - len(gaps)}
    if gaps:
        clock.update(max_us=us[-1], worst=gaps[-1][1], median_us=us[len(us) // 2],
                     p99_us=us[min(len(us) - 1, int(0.99 * len(us)))],
                     over_100_us=sum(u > 100 for u in us))
    return dict(lane=lane, clock=clock)


_last = (None, None)


def _stretch_of(trace):
    """The harness's `Stretch` whose readings these are."""
    from . import tracing

    for o in gc.get_objects():
        if type(o) is tracing.Stretch and o.latencies_ms is trace.get("latencies_ms"):
            return o
    return None


def from_readings(readings):
    """The join for a traced run's readings (computed once per run), or
    None where the program records no span."""
    global _last
    trace = readings.get("trace")
    if not trace or not trace.get("frames"):
        return None
    if _last[0] is trace:
        return _last[1]
    out = None
    stretch = _stretch_of(trace)
    try:
        from dvm_slam_tpu_torch.utils import profiling
        snap = profiling.snapshot() if hasattr(profiling, "snapshot") else None
    except ImportError:
        snap = None
    if stretch is not None and stretch.prof is not None:
        out = join(stretch.prof.profiler.kineto_results.events(), snap,
                   trace["frames"]) or None
    if out is None and snap is not None and snap["spans"]:
        raise RuntimeError("the program recorded spans, but no profile of this run's traced "
                           "stretch holds them")
    _last = (trace, out)
    return out
