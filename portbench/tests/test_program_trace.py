"""The join of the program's spans with the device trace, on fake profiler
events: each launch to its runtime call by correlation id and on to the
innermost `dvm:` span, launches, device time and idle by span and layer,
the host's waits, the lane parts of a frame and the clock check; then the
six readers on the join."""

from types import SimpleNamespace

import pytest

from portbench import harness, program_trace, tracing
from portbench.tests import tiny

OFFSET = 1_000_000   # the profiler's clock less the tracer's, in these fakes


def _ev(kind, name, start, dur, corr=0, typed=True):
    on_card = kind in ("kernel", "gpu_memcpy", "gpu_user_annotation")
    e = SimpleNamespace(name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
                        correlation_id=lambda: corr,
                        device_type=lambda: "DeviceType.CUDA" if on_card else "DeviceType.CPU")
    if typed:
        e.activity_type = lambda: kind
    return e


SPANS = [("entry.track_monocular", 10, 900), ("lane.submit", 12, 13), ("lane.step", 20, 800),
         ("frontend.make_frame", 30, 200), ("k1", 150, 190), ("tracking.track_frame", 300, 600),
         ("tracking.match", 400, 450), ("mapping.add_keyframe", 640, 648),
         ("mapping.chain", 650, 780), ("lane.retire", 850, 860)]
LAUNCHES = [   # (runtime call, its start, corr, device kind, device start, device end)
    ("cudaLaunchKernel", 40, 1, "kernel", 100, 120),          # make_frame
    ("cudaLaunchKernel", 160, 2, "kernel", 210, 230),         # k1, inside make_frame
    ("cudaLaunchKernel", 250, 9, "kernel", 260, 270),         # the step itself: other
    ("cudaLaunchKernel", 310, 3, "kernel", 320, 330),         # track_frame
    ("cudaMemcpyAsync", 320, 4, "gpu_memcpy", 335, 340),      # a copy: device time, no launch
    ("cudaLaunchKernel", 700, 6, "kernel", 710, 760),         # mapping.chain
    ("cudaLaunchKernel", 950, 7, "kernel", 960, 970),         # after the entry: outside
    ("cudaLaunchKernel", 990, 8, "kernel", 2000, 2010),       # ran after the window
]


def _events(typed, copy="Memcpy DtoH (Device -> Pageable)"):
    ev = [_ev("user_annotation", tracing.WINDOW_SPAN, 0, 1000, typed=typed)]
    ev += [_ev("cpu_op", "dvm:" + n, s, e - s, typed=typed) for n, s, e in SPANS]
    for name, t, corr, kind, s, e in LAUNCHES:
        ev.append(_ev("cuda_runtime", name, t, 5, corr, typed))
        ev.append(_ev(kind, copy if kind == "gpu_memcpy" else "void k<>", s, e - s, corr, typed))
    ev += [_ev("cuda_runtime", "cudaStreamSynchronize", 405, 40, 5, typed),
           _ev("kernel", "void unlinked<>", 980, 5, 99, typed),              # no runtime call
           _ev("gpu_user_annotation", "dvm:lane.step", 100, 660, 0, typed),  # device mirrors
           _ev("gpu_user_annotation", "pb:track_frame", 320, 20, 0, typed),
           _ev("cpu_op", "aten::add", 35, 3, 1, typed)]                      # an op's own id
    return ev


def _snapshot(jitter=0):
    spans = [dict(id=i, name=n, start_ns=s - OFFSET + (jitter if n == "k1" else 0),
                  end_ns=e - OFFSET, parent=-1, frame=5 if n.startswith("lane.") else None)
             for i, (n, s, e) in enumerate(SPANS)]
    return {"spans": spans, "counters": {}, "report": {}, "realtime_offset_ns": OFFSET}


@pytest.mark.parametrize("typed", [True, False])
def test_launches_by_span_and_layer(typed):
    j = program_trace.join(_events(typed), _snapshot(), frames=2)
    assert j["launches"] == 7 and j["unlinked"] == 1
    assert j["launches_by_span"] == {"frontend.make_frame": 1, "k1": 1, "lane.step": 1,
                                     "tracking.track_frame": 1, "mapping.chain": 1,
                                     "outside_the_spans": 2}
    # the kernel under K1 counts for the front end, the step's own for none
    assert j["launches_by_layer"] == {"frontend": 2, "other": 1, "tracking": 1, "mapping": 1,
                                      "outside_the_spans": 2}
    ms = {k: round(v * 1e6) for k, v in j["device_ms_by_span"].items()}
    assert ms == {"frontend.make_frame": 20, "k1": 20, "lane.step": 10,
                  "tracking.track_frame": 15, "mapping.chain": 50, "outside_the_spans": 15}
    assert j["keyframes"] == 1 and j["frames"] == 2


@pytest.mark.parametrize("typed", [True, False])
def test_idle_and_waits_by_span(typed):
    j = program_trace.join(_events(typed), _snapshot(), frames=2)
    idle = {k: round(v * 1e6) for k, v in j["idle_ms_by_span"].items()}
    assert idle == {"outside_the_spans": 95, "entry.track_monocular": 99, "lane.submit": 1,
                    "lane.step": 142, "frontend.make_frame": 110, "k1": 40,
                    "tracking.track_frame": 235, "tracking.match": 50,
                    "mapping.add_keyframe": 8, "mapping.chain": 80, "lane.retire": 10}
    assert sum(idle.values()) + 130 == 1000           # idle and busy fill the window
    # a synchronise, and a copy to pageable memory (its call waits); a copy
    # to pinned memory returns at once
    assert {k: [n, round(v * 1e6)] for k, (n, v) in j["waits_by_span"].items()} == \
        {"tracking.match": [1, 40], "tracking.track_frame": [1, 5]}
    pinned = program_trace.join(_events(typed, "Memcpy DtoH (Device -> Pinned)"), _snapshot())
    assert {k: n for k, (n, _) in pinned["waits_by_span"].items()} == {"tracking.match": 1}


def test_lane_parts_syncs_and_clock():
    j = program_trace.join(_events(True), _snapshot(jitter=30), frames=2)
    (frame, buffer, step, in_flight), = j["lane"]
    assert frame == 5
    assert [round(x * 1e6) for x in (buffer, step, in_flight)] == [8, 780, 60]
    assert sum(ms for _, ms in j["waits_by_span"].values()) == pytest.approx(45e-6)
    assert j["clock"]["spans"] == len(SPANS) and j["clock"]["unpaired"] == 0
    assert j["clock"]["max_us"] == pytest.approx(0.03)


def test_a_frame_without_all_three_marks_is_left_out():
    snap = _snapshot()
    snap["spans"] = [s for s in snap["spans"] if s["name"] != "lane.retire"]
    assert program_trace.join(_events(True), snap)["lane"] == []


def test_no_program_spans_no_join():
    """A program without the tracer, or a profile without the window,
    gives nothing."""
    ev = [e for e in _events(True) if not e.name().startswith("dvm:")]
    assert program_trace.join(ev) == {}
    assert program_trace.join([e for e in _events(True) if e.name() != tracing.WINDOW_SPAN]) == {}


def test_spans_without_the_runs_profile_raise(monkeypatch):
    """The program recorded spans, but the run's profiled stretch cannot
    be found: the readers fail loudly instead of reading nothing, as a
    program without the tracer does."""
    from dvm_slam_tpu_torch.utils import profiling

    monkeypatch.setattr(program_trace, "_last", (None, None))
    readings = {"trace": {"frames": 3, "latencies_ms": []}}
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": [], "counters": {}})
    assert program_trace.from_readings(readings) is None
    monkeypatch.setattr(program_trace, "_last", (None, None))
    monkeypatch.setattr(profiling, "snapshot", lambda: _snapshot())
    with pytest.raises(RuntimeError, match="no profile"):
        program_trace.from_readings(readings)
    with pytest.raises(RuntimeError):
        harness.load_metric(tiny.REPO, "lane_buffer_ms_p95").read(readings)


def test_readers_on_the_join(monkeypatch):
    j = program_trace.join(_events(True), _snapshot(), frames=2)
    j["lane"] = [[f, b, 1.0, 10.0 * f] for f, b in zip(range(1, 21), range(20))]
    monkeypatch.setattr(program_trace, "from_readings", lambda r: j)
    read = {n: harness.load_metric(tiny.REPO, n).read({}) for n in (
        "frontend_launches_per_frame", "tracking_launches_per_frame",
        "mapping_launches_per_keyframe", "host_sync_ms_per_frame", "lane_buffer_ms_p95",
        "lane_in_flight_ms_p95")}
    assert read["frontend_launches_per_frame"] == 1.0
    assert read["tracking_launches_per_frame"] == 0.5
    assert read["mapping_launches_per_keyframe"] == 1.0
    assert read["host_sync_ms_per_frame"] == pytest.approx(22.5e-6)
    assert read["lane_buffer_ms_p95"] == pytest.approx(18.05)
    assert read["lane_in_flight_ms_p95"] == pytest.approx(190.5)
    j["keyframes"] = 0
    assert harness.load_metric(tiny.REPO, "mapping_launches_per_keyframe").read({}) is None
    monkeypatch.setattr(program_trace, "from_readings", lambda r: None)
    assert all(harness.load_metric(tiny.REPO, n).read({}) is None for n in read)


def test_a_traced_run_reads_the_programs_spans(tmp_path):
    """A traced run of the tiny cell on the CPU: the readers find the run's
    profile and the program's spans; the sync time reads 0 and the
    launches nothing (no device), and the lane's parts read for the frames whose three
    marks all lie in the stretch (none in the tiny cell's four frames,
    whose poses come back eight frames late)."""
    root = tiny.make_root(tmp_path)
    joins = []
    join = program_trace.from_readings

    def kept(r):
        joins.append(join(r))
        return joins[-1]

    program_trace.from_readings = kept
    try:
        result, _, _ = harness.run_cell(tiny.CELL, 3000000047, 6.0, True, root, device="cpu")
    finally:
        program_trace.from_readings = join
    m = result["metrics"]
    assert result["correct"], result["checks"]
    assert m["host_sync_ms_per_frame"]["value"] == 0          # no runtime calls on the CPU
    assert "frontend_launches_per_frame" not in m and "mapping_launches_per_keyframe" not in m
    j = joins[-1]
    assert j["launches"] == 0 and j["clock"]["unpaired"] == 0 and j["waits_by_span"] == {}
    assert len(j["lane"]) <= j["frames"]
    assert ("lane_buffer_ms_p95" in m) == ("lane_in_flight_ms_p95" in m) == bool(j["lane"])
