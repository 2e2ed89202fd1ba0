"""Spans and the profile of a traced run.

`Tracer` wraps the program's functions that `spans.json` lists, from the
outside (nothing in the program is edited), for one profiled stretch after
the window: each call opens a `torch.profiler.record_function` span named
`pb:<span>`, adds its host time to its layer (nested calls of one layer
count once), counts the keyframes made and, for a kernel, adds the least
time its shapes allow (`roofline.py`). `reduce_profile` reads the device's kernels
and copies, and the spans, from the profiler's events in memory: no trace
file is written.
"""

from __future__ import annotations

import collections
import functools
import importlib
import re
import time

import torch

from . import roofline

WINDOW_SPAN = "pb:window"


def _resolve(target: str):
    """'pkg.module:Class.attr' -> (owner object, attribute name)."""
    mod_name, attr = target.split(":")
    owner = importlib.import_module(mod_name)
    *path, name = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    return owner, name


class Tracer:
    """Host-side spans around the functions `spec` lists."""

    def __init__(self, spec: dict):
        self.spans = spec["spans"]
        self.layer_s = collections.defaultdict(float)
        self.bound_s = collections.defaultdict(float)
        self.keyframes = 0
        self._open = collections.Counter()
        self._patches = []

    def install(self):
        for sp in self.spans:
            for target in sp["targets"]:
                owner, name = _resolve(target)
                fn = getattr(owner, name)
                setattr(owner, name, self._wrap(sp, fn))
                self._patches.append((owner, name, fn))

    def uninstall(self):
        for owner, name, fn in reversed(self._patches):
            setattr(owner, name, fn)
        self._patches = []

    def _wrap(self, sp: dict, fn):
        span, layer = sp["name"], sp["layer"]
        size = getattr(roofline, sp["bytes"]) if "bytes" in sp else None
        keyframe = bool(sp.get("keyframe"))
        label = "pb:" + span

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if size is not None:
                self.bound_s[span] += roofline.bound_s(*size(*args, **kwargs))
            outer = self._open[layer] == 0
            if keyframe and self._open["keyframe"] == 0:
                self.keyframes += 1
            self._open[layer] += 1
            self._open["keyframe"] += keyframe
            t = time.perf_counter()
            try:
                with torch.profiler.record_function(label):
                    return fn(*args, **kwargs)
            finally:
                self._open[layer] -= 1
                self._open["keyframe"] -= keyframe
                if outer:
                    self.layer_s[layer] += time.perf_counter() - t

        return wrapper


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)


def _dur_ns(e) -> int:
    return e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)


def _kind(e) -> str:
    """"kernel", "copy", "span" (one of the harness's) or "" for the
    profiler's event; by name and device where the event has no activity
    type (older kineto bindings)."""
    name = e.name()
    if name.startswith("pb:"):
        # the host span; its mirror on the device timeline is not work
        return "span" if str(e.device_type()).endswith("CPU") else ""
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        return {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "copy"}.get(kind, "")
    if not str(e.device_type()).endswith("CUDA"):
        return ""
    return "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"


def reduce_profile(events, spans: list) -> dict:
    """Device readings of the profiled stretch from the profiler's events
    (`prof.profiler.kineto_results.events()`): kernel launches, the busy
    seconds (the union of kernels and copies), each listed kernel's device
    seconds, the ten device operations that took most time, and the idle
    gaps summed by the innermost span open while they lasted."""
    win = None
    dev, annots = [], []
    for e in events:
        kind = _kind(e)
        if not kind:
            continue
        s = _start_ns(e)
        iv = (s, s + _dur_ns(e))
        if kind == "span":
            if e.name() == WINDOW_SPAN:
                win = iv
            else:
                annots.append(iv + (e.name()[3:],))
        else:
            dev.append(iv + (e.name(), kind))
    if win is None:
        return {}
    w0, w1 = win[0], win[1]
    dev = [(max(s, w0), min(e, w1), n, k) for s, e, n, k in dev if e > w0 and s < w1]
    busy = _merge([(s, e) for s, e, _, _ in dev])
    kernels = [d for d in dev if d[3] == "kernel"]
    by_name = collections.defaultdict(float)
    for s, e, n, _ in kernels:
        by_name[n] += (e - s) * 1e-9
    kernel_s = {sp["name"]: sum(t for n, t in by_name.items() if sp["kernel"] in n)
                for sp in spans if "kernel" in sp}
    # idle gaps: the complement of `busy` in the window, split at the span
    # boundaries and charged to the innermost span open (spans nest: they
    # are calls on one host thread)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(annots)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(annots)])
    idle = collections.defaultdict(float)
    stack, j = [], 0

    def advance(j):
        _, opening, i = marks[j]
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)

    def charge(dt):
        idle[annots[stack[-1]][2] if stack else "outside_the_spans"] += dt * 1e-9

    for s, e in gaps:
        while j < len(marks) and marks[j][0] <= s:
            advance(j)
            j += 1
        cur = s
        while j < len(marks) and marks[j][0] < e:
            charge(marks[j][0] - cur)
            cur = marks[j][0]
            advance(j)
            j += 1
        charge(e - cur)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        launches=len(kernels),
        kernel_s=kernel_s,
        device_ops=[[_clean(n), t] for n, t in top],
        idle_gaps=[[n, t] for n, t in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    )


class Stretch:
    """The traced stretch after the window: from the first pose that comes
    back after it until `n_frames` more have come back, the spans are
    installed and `torch.profiler` records the host and the device; each
    pose's latency is taken from the call that handed its frame in."""

    def __init__(self, cell, spec: dict, n_frames: int):
        self.cell, self.spec, self.n_frames = cell, spec, n_frames
        self.tracer = Tracer(spec)
        self.prof = self._window = None
        self.n_start = self.frames = None
        self.latencies_ms = []

    def on_return(self, n: int, t: float) -> bool:
        """Called when poses came back (n in all, at time t); True while
        the stretch is still being traced."""
        if self.n_start is None:
            self.cell.new_rows()
            self.tracer.install()
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._window = torch.profiler.record_function(WINDOW_SPAN)
            self._window.__enter__()
            self.n_start = n
            return True
        if self.frames is not None:
            return False
        t_in = self.cell.t_in
        self.latencies_ms += [(t - t_in[i]) * 1e3 for i in self.cell.new_rows() if i in t_in]
        if n - self.n_start < self.n_frames:
            return True
        self.cell.sync()
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.tracer.uninstall()
        self.frames = n - self.n_start
        return False

    def readings(self, on_card: bool) -> dict:
        tr = self.tracer
        dev = (reduce_profile(self.prof.profiler.kineto_results.events(), self.spec["spans"])
               if on_card else {})
        return dict(frames=self.frames, layer_s=dict(tr.layer_s),
                    bound_s=dict(tr.bound_s), keyframes=tr.keyframes,
                    latencies_ms=self.latencies_ms, **dev)
