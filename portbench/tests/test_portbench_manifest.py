"""BENCHMARK.json against the benchmark's contract, and a cell and a metric
added as files and entries alone."""

import json
import re

import pytest

from portbench import harness, manifest
from portbench.tests import tiny

REPO = tiny.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "portbench/run.py"]
    assert m["paths"] == ["portbench"]
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(m):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(x["name"] for x in m["end_to_end"] + m["per_layer"])) == \
        len(m["end_to_end"]) + len(m["per_layer"])
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]), x["unit"]
        assert x["better"] in ("lower", "higher") and x["source"] in SOURCES


def test_bounds(m):
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for x in e2e.values():
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader_that_agrees(m, kind):
    for x in m[kind]:
        mod = harness.load_metric(REPO, x["name"])
        assert mod.UNIT == x["unit"] and mod.SOURCE == x["source"]
        if kind == "per_layer":
            assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
            assert mod.LAYER == x["layer"] and mod.MOVES == x["moves"] == "setup_s"


def test_every_cell_has_its_files(m):
    for w in m["workloads"]:
        spec = manifest.load_cell(w["name"], REPO)
        assert spec["traffic"]["frames"] > spec["traffic"]["warm_frames"]
        assert set(spec["checks"]) == {"desc_bits_worst_kf", "angle_gap_rad",
                                       "keypoints_odd_worst_kf", "ate_m", "kf_ate_m",
                                       "map_median_m", "ba_point_shift_m", "poses_missing"}
        assert spec["per_layer"] and len(spec["end_to_end"]) >= 2
    for c in m["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("portbench/")


def test_a_cell_and_a_metric_added_as_files_alone(tmp_path):
    root = tiny.make_root(tmp_path)
    (root / "portbench" / "metrics" / "frames_fed.py").write_text(
        'SOURCE = "program_counter"\nUNIT = "frames"\nLAYER = "entry"\n'
        'MOVES = "setup_s"\n\n\ndef read(r):\n    return r["fed"]\n')
    mf = json.loads((root / "BENCHMARK.json").read_text())
    mf["per_layer"].append({"name": "frames_fed", "unit": "frames", "better": "higher",
                            "source": "program_counter", "layer": "entry",
                            "moves": "setup_s", "workloads": [tiny.CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(mf))
    spec = manifest.load_cell(tiny.CELL, root)
    assert spec["config"]["settings"]["camera"]["width"] == 320
    assert spec["traffic"]["warm_frames"] == 24
    assert "frames_fed" in [x["name"] for x in spec["per_layer"]]
    assert harness.load_metric(root, "frames_fed").read({"fed": 7}) == 7
    # the repository's own cells see no change
    assert "frames_fed" not in [x["name"] for x in
                                manifest.load_cell("euroc_mono.explore", root)["per_layer"]]
