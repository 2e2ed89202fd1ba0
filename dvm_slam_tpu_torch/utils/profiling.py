"""Span timers + per-stage statistics.

Replaces the reference's two profiling mechanisms: the compile-gated
`REGISTER_TIMES` per-stage vectors dumped by `Tracking::PrintTimeStats`
(`Tracking.cc:253`, `LocalMapping.cc:92-117`) and the wrapper's
`startTimer/stopTimer` map that prints any span > 3 ms
(`include/orb_slam3_wrapper.h:128-143`).

A copy of `dvm_slam_tpu/utils/profiling.py` (stdlib only): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List


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
        ms = (time.perf_counter() - t0) * 1e3
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

    def dump(self, path: str):
        import json

        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)
