"""The window's rate arithmetic on fake lanes, the profile's reduction on
fake events, and K1-K3's bytes from shapes."""

import math
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, roofline, tracing


class FakeLane:
    """A lane whose poses come back `lag` frames late, `batch` at a time;
    a dispatch (every `batch`-th frame) costs `batch * dt` on a fake clock,
    a buffered frame nothing."""

    def __init__(self, lag, batch, dt, warm):
        self.lag, self.batch, self.dt, self.now, self.fed = lag, batch, dt, 0.0, 0
        for _ in range(warm):
            self.feed()

    def feed(self):
        self.fed += 1
        if self.fed % self.batch == 0:
            self.now += self.batch * self.dt

    def returned(self):
        done = (self.fed // self.batch) * self.batch   # frames dispatched
        return max(0, done - self.lag)

    def sync(self):
        pass

    def clock(self):
        return self.now


@pytest.mark.parametrize("lag,batch,warm", [(8, 1, 20), (8, 4, 20), (8, 4, 21), (8, 4, 22),
                                            (4, 4, 23)])
def test_rate_counts_each_late_pose_once(lag, batch, warm):
    lane = FakeLane(lag, batch, dt=0.4, warm=warm)
    n_before = lane.returned()
    frames, t0, t1, returns = harness.measure(lane, 10.0, clock=lane.clock)
    assert returns[-1][1] == frames
    # every pose that came back inside the window counts, once: those of
    # frames fed before it (late at the start) and none fed inside it that
    # come back after its end
    assert frames == lane.returned() - n_before
    assert t1 >= t0 + 10.0
    assert math.isclose(frames / (t1 - t0), 1 / 0.4, rel_tol=1e-12)


def test_window_ends_at_the_first_return_after_the_deadline():
    lane = FakeLane(8, 4, dt=0.4, warm=20)
    frames, t0, t1, _ = harness.measure(lane, 3.0, clock=lane.clock)
    assert t1 - t0 == pytest.approx(3.2) and frames == 8


def _ev(kind, name, start, dur, typed):
    """A profiler event; `typed` gives it an activity type, as newer kineto
    bindings do; without one the reduction goes by device and name."""
    dev = "DeviceType.CUDA" if kind in ("kernel", "gpu_memcpy") else "DeviceType.CPU"
    e = SimpleNamespace(name=lambda: name, device_type=lambda: dev,
                        start_us=lambda: start / 1000, duration_us=lambda: dur / 1000)
    if typed:
        e.activity_type = lambda: kind
        e.start_ns, e.duration_ns = (lambda: start), (lambda: dur)
    return e


@pytest.mark.parametrize("typed", [True, False])
def test_profile_reduction(typed):
    spans = [{"name": "k1", "kernel": "orb_describe"}]
    events = [_ev(*e, typed) for e in [
        ("user_annotation", tracing.WINDOW_SPAN, 0, 1000),
        ("user_annotation", "pb:track_frame", 100, 500),
        ("user_annotation", "pb:pose_optimization", 200, 100),
        ("kernel", "pb:track_frame", 100, 500),                  # the span's device mirror
        ("kernel", "orb_describe_levels_kernel", 50, 50),        # busy 50-100
        ("kernel", "elementwise", 150, 100),                     # busy 150-250
        ("gpu_memcpy", "Memcpy HtoD", 240, 20),                  # busy to 260
        ("kernel", "outside", 2000, 10),                         # out of the window
        ("cpu_op", "aten::add", 0, 10),
    ]]
    r = tracing.reduce_profile(events, spans)
    assert r["window_s"] == pytest.approx(1e-6)
    assert r["busy_s"] == pytest.approx(160e-9)
    assert r["launches"] == 2
    assert r["kernel_s"]["k1"] == pytest.approx(50e-9)
    idle = dict(r["idle_gaps"])
    # gaps: 0-50 and 100-100 outside, 100-150 track_frame, 260-300
    # pose_optimization, 300-600 track_frame, 600-1000 outside
    assert idle["outside_the_spans"] == pytest.approx(450e-9)
    assert idle["track_frame"] == pytest.approx(350e-9)
    assert idle["pose_optimization"] == pytest.approx(40e-9)


def test_kernel_bytes_from_shapes():
    raws = [torch.zeros(350, 600), torch.zeros(292, 500)]
    xy = torch.zeros(1000, 2)
    nbytes, nops = roofline.k1(raws, raws, xy, (0, 600, 1000))
    assert nbytes == 4 * (2 * (350 * 600 + 292 * 500) + 3000) + 256 * 1000 + 4096
    assert nops == 1000 * (5 * 31 * 31 + 6 * 512 + 256)
    vals = torch.zeros(32, 9, 512).permute(0, 2, 1)           # a strided [L,G,F] view
    vals = vals.reshape(32, 512, 9).permute(0, 2, 1)
    assert roofline.k2(vals, torch.zeros(32, 512, dtype=torch.int32), 4096) == (
        4 * (32 * 9 * 512 + 32 * 512 + 32 * 9 * 4096), 0)
    assert roofline.k3(torch.zeros(3, 4096), torch.zeros(32, 512, dtype=torch.int32)) == (
        4 * (3 * 4096 + 32 * 512 + 32 * 3 * 512), 0)
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
