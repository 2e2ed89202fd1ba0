"""The port's tracer (`utils/profiling.py`) on the CPU: what it records on,
off and in a fresh process's state, the spans of a tiny monocular
`System` through the autonomous lane, self time, the kernels' launch
counters, and the program's spans against the benchmark's outside
wrappers (`portbench/spans.json`) around the same functions.

The tiny run is 144x192 with 300 features on 4 levels: the smallest of
this scene at which the two-view initialization finds its 100 matches."""

import collections
import contextlib
import json
import os
import time

import pytest
import torch

from dvm_slam_tpu_torch.frontend import extractor
from dvm_slam_tpu_torch.io import config as tcfg
from dvm_slam_tpu_torch.io import synthetic as tsyn
from dvm_slam_tpu_torch.models import system as tsys
from dvm_slam_tpu_torch.tracking import tracker as ttrk
from dvm_slam_tpu_torch.utils import profiling

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N_FEATURES, N_LEVELS, N_FRAMES = 144, 192, 300, 4, 16
# each program span and the `spans.json` entries whose wrappers sit around it
PB_OF = {"entry.track_monocular": ["track_monocular"], "frontend.make_frame": ["make_frame"],
         "tracking.track_frame": ["track_frame"],
         "tracking.pose_optimization": ["pose_optimization"],
         "mapping.chain": ["mapper_chain", "on_new_keyframe"], "mapping.local_ba": ["local_ba"],
         "ba.bundle_adjust": ["bundle_adjust"], "k1": ["k1"], "k2": ["k2"], "k3": ["k3"]}


@contextlib.contextmanager
def _fresh_tracer():
    """The tracer in a fresh process's state, emptied; its state before
    is put back after."""
    saved = profiling._on, profiling._follow
    profiling._on, profiling._follow = False, True
    profiling.reset()
    try:
        yield
    finally:
        profiling._on, profiling._follow = saved
        profiling.reset()


@pytest.fixture
def tracer():
    with _fresh_tracer():
        yield profiling


def _settings():
    s = tcfg.SystemSettings()
    s.camera = tcfg.CameraSettings(fx=156.0, fy=156.0, cx=W / 2, cy=H / 2, width=W, height=H,
                                   dist=(0.0, 0.0, 0.0, 0.0), fps=10.0)
    s.orb = tcfg.OrbSettings(n_features=N_FEATURES, n_levels=N_LEVELS)
    s.kf_capacity, s.pt_capacity = 32, 2048
    return s


def _images(settings):
    world = tsyn.PlaneWorld(seed=3, tex_size=1024, plane_z=6.0, extent=30.0)
    poses = tsyn.smooth_trajectory(30, lateral=2.0, forward=0.5, yaw=0.08)[:N_FRAMES]
    K = torch.from_numpy(settings.camera.K())
    return [world.render(torch.from_numpy(T), K, H, W) for T in poses]


@pytest.fixture(scope="module")
def run():
    """The tiny run under `torch.profiler` (the CPU's events), with the
    benchmark's wrappers installed and the tracer in a fresh process's
    state: it records because the profiler does."""
    from portbench import tracing

    settings = _settings()
    imgs = _images(settings)
    system = tsys.System(settings, device="cpu")
    spec = json.load(open(os.path.join(REPO, "portbench", "spans.json")))
    tracer = tracing.Tracer(spec)
    with _fresh_tracer():
        tracer.install()
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                for i, img in enumerate(imgs):
                    system.track_monocular(img, i * 0.1)
                system.tracker.drain_auto()
        finally:
            tracer.uninstall()
        snap = profiling.snapshot()
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("pb:", "dvm:")) and str(e.device_type()).endswith("CPU"):
            events[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return dict(snap=snap, events={k: sorted(v) for k, v in events.items()},
                tracker=system.tracker)


def _tree(snap):
    spans = {s["id"]: s for s in snap["spans"]}
    kids = collections.defaultdict(list)
    for s in snap["spans"]:
        kids[s["parent"]].append(s)
    return spans, kids


def _under(kids, span):
    """Every span inside `span`, at any depth."""
    out, todo = [], list(kids[span["id"]])
    while todo:
        s = todo.pop()
        out.append(s)
        todo += kids[s["id"]]
    return out


def _frontend_call(img):
    s = _settings()
    fc = s.frontend_config()
    K = torch.from_numpy(s.camera.K())
    return extractor.make_frame(img, K, torch.zeros(4), fc)


def test_off_records_nothing_and_counts_only_launches(tracer):
    """Disabled, the tracer keeps no span and no counter but the kernels'
    launches, also while a profiler records, and leaves no `dvm:` event; a
    fresh process's state records nothing without a profiler."""
    img = _images(_settings())[0]
    _frontend_call(img)
    assert tracer.snapshot()["spans"] == []
    tracer.disable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _frontend_call(img)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert not [n for n in names if n.startswith("dvm:")]
    assert "aten::add" in names or len(names) > 10          # the profiler did record
    snap = tracer.snapshot()
    assert snap["spans"] == [] and snap["report"] == {}
    # no kernel on the CPU: the twin ran, and nothing but launches is counted
    assert snap["counters"] == {} and tracer.counter("k1.launches") == 0
    tracer.count_launch("k1")
    assert tracer.snapshot()["counters"] == {"k1.launches": 1}


def test_enable_records_without_a_profiler(tracer):
    """`enable()` records with no profiler session, `disable()` then
    stops it; a fresh process's state records only under a profiler."""
    tracer.enable()
    with tracer.span("a.on"):
        pass
    tracer.disable()
    with tracer.span("a.off"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracer.span("a.off_profiled"):
            pass
    assert [s["name"] for s in tracer.snapshot()["spans"]] == ["a.on"]
    tracer.reset()
    tracer._on, tracer._follow = False, True
    with tracer.span("a.fresh"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracer.span("a.fresh_profiled", frame=3):
            pass
    (s,) = tracer.snapshot()["spans"]
    assert (s["name"], s["frame"], s["parent"]) == ("a.fresh_profiled", 3, -1)


def test_lane_spans_of_each_frame(run):
    """Each frame the lane took: its entry, then submit, step and retire
    under one number, in that order in time, with the front end, the
    tracking and two pose optimizations under its step and the mapper
    chain under the steps that made a keyframe."""
    snap, t = run["snap"], run["tracker"]
    spans, kids = _tree(snap)
    by = collections.defaultdict(lambda: collections.defaultdict(list))
    for s in snap["spans"]:
        by[s["name"]][s["frame"]].append(s)
    entries = by["entry.track_monocular"]
    assert sorted(entries) == list(range(1, N_FRAMES + 1))
    steps = by["lane.step"]
    assert len(steps) >= 8
    kf_frames = {round(ts * 10) + 1 for ts in t.kf_timestamps.values()}
    chains = 0
    for f, (step,) in steps.items():
        (submit,), (retire,) = by["lane.submit"][f], by["lane.retire"][f]
        assert spans[submit["parent"]]["name"] == "entry.track_monocular"
        assert spans[submit["parent"]]["frame"] == f
        assert submit["start_ns"] <= step["start_ns"] <= step["end_ns"] <= retire["start_ns"]
        inside = collections.Counter(s["name"] for s in _under(kids, step))
        assert inside["frontend.make_frame"] == 1 and inside["tracking.track_frame"] == 1
        assert inside["tracking.pose_optimization"] == 2
        assert all(s["frame"] == f for s in _under(kids, step))
        assert inside["mapping.chain"] == (f in kf_frames)
        chains += inside["mapping.chain"]
    assert chains >= 2
    assert set(by["lane.retire"]) == set(steps) == set(by["lane.submit"])


def test_self_time_is_duration_less_children(run):
    snap = run["snap"]
    spans, kids = _tree(snap)
    want = collections.defaultdict(int)
    for s in snap["spans"]:
        inner = sum(c["end_ns"] - c["start_ns"] for c in kids[s["id"]])
        assert 0 <= inner <= s["end_ns"] - s["start_ns"]
        want[s["name"]] += s["end_ns"] - s["start_ns"] - inner
    for name, r in snap["report"].items():
        assert r["self_ms"] == pytest.approx(want[name] * 1e-6, rel=1e-9, abs=1e-9)
        assert r["self_ms"] <= r["total_ms"] + 1e-9
    assert snap["report"]["frontend.pyramid"]["n"] == N_FRAMES
    assert snap["report"]["entry.track_monocular"]["self_ms"] < \
        snap["report"]["entry.track_monocular"]["total_ms"]


def test_self_time_of_nested_spans(tracer):
    """A made-up nest: self time is exact arithmetic on the spans' clocks."""
    tracer.enable()
    with tracer.span("a.outer", frame=7):
        with tracer.span("a.inner"):
            time.sleep(0.002)
        with tracer.span("a.inner"):
            pass
    snap = tracer.snapshot()
    outer, in1, in2 = snap["spans"]
    assert (outer["name"], in1["parent"], in2["parent"]) == ("a.outer", outer["id"], outer["id"])
    assert in1["frame"] == in2["frame"] == 7          # taken from the parent
    d = lambda s: s["end_ns"] - s["start_ns"]  # noqa: E731
    assert snap["report"]["a.outer"]["self_ms"] == pytest.approx(
        (d(outer) - d(in1) - d(in2)) * 1e-6, rel=1e-12)
    assert snap["report"]["a.inner"]["n"] == 2
    assert snap["report"]["a.inner"]["self_ms"] == pytest.approx(snap["report"]["a.inner"]
                                                                 ["total_ms"], rel=1e-12)


def test_counters(run, tracer):
    """The kernels' launch counters count whether the tracer records or
    not, the snapshot hands them out, `reset()` empties them; the tiny
    run launched no kernel (none runs on the CPU)."""
    assert run["snap"]["counters"] == {}
    for state in (tracer.enable, tracer.disable):
        state()
        tracer.count_launch("k2")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tracer.count_launch("k3")
    assert tracer.counter("k2.launches") == 2 and tracer.counter("k3.launches") == 1
    assert tracer.snapshot()["counters"] == {"k2.launches": 2, "k3.launches": 1}
    tracer.reset()
    assert tracer.counter("k2.launches") == 0 and tracer.snapshot()["counters"] == {}


def test_program_spans_against_the_benchmarks_wrappers(run):
    """Each program span is called as often as the wrappers around the
    same function, and each call lies inside its wrapper's call on the
    profiler's clock, so it never lasts longer: a reader can switch from
    the wrappers to the program's spans without moving a number."""
    ev = run["events"]
    seen = 0
    for name, pbs in PB_OF.items():
        mine = ev.get("dvm:" + name, [])
        theirs = sorted(x for p in pbs for x in ev.get("pb:" + p, []))
        assert len(mine) == len(theirs), name
        for (s, e), (ps, pe) in zip(mine, theirs):
            assert ps <= s <= e <= pe, name
        seen += len(mine) > 0
    assert seen >= 7                                    # K2 and K3 run only on a card
    # the tracer's own list is the profiler's `dvm:` events, one for one
    assert len(run["snap"]["spans"]) == sum(len(v) for k, v in ev.items()
                                            if k.startswith("dvm:"))


def test_spans_lie_on_the_profilers_clock(run):
    """The tracer's times plus `realtime_offset_ns` are the profiler's
    stamps of the same spans (the CPU's events; within 50 ms here, where
    a test shares its host; the card's bound is measured in PERF.md)."""
    snap, ev = run["snap"], run["events"]
    off = snap["realtime_offset_ns"]
    by = collections.defaultdict(list)
    for s in snap["spans"]:
        by[s["name"]].append(s["start_ns"])
    worst = max(abs(a + off - b[0]) for name, starts in by.items()
                for a, b in zip(sorted(starts), ev["dvm:" + name]))
    assert worst < 50e6


def test_traced_keeps_the_function():
    @profiling.traced("a.fn")
    def fn(x, y=1):
        """doc"""
        return x + y

    assert fn.__name__ == "fn" and fn.__doc__ == "doc" and fn(1, y=2) == 3
    assert ttrk.track_frame.__name__ == "track_frame"
