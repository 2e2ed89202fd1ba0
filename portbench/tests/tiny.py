"""A CPU-sized copy of the benchmark for its own tests: BENCHMARK.json and
portbench/ copied under a temporary root, with the tiny cell
`tiny_mono.explore` (320x240, 600 features, 4 levels) added as files and
manifest entries only, the way a later change adds a cell."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
CELL = "tiny_mono.explore"


def add_cell(root: Path, name: str, config_file: Path, traffic_file: Path, checks_file: Path):
    """Add a cell to the benchmark under `root`: its files and its entries,
    and no other change. Every per-layer metric with a cell list gets it."""
    config, traffic = name.split(".")
    bench = root / "portbench"
    shutil.copy(config_file, bench / "configs" / f"{config}.json")
    shutil.copy(traffic_file, bench / "traffic" / f"{name}.json")
    shutil.copy(checks_file, bench / "checks" / f"{name}.json")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": config, "source": "a CPU-sized cut for the tests",
                         "file": f"portbench/configs/{config}.json", "reduced": [],
                         "why": "tests"})
    m["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                           "why": "tests"})
    for metric in m["per_layer"]:
        if "workloads" in metric:
            metric["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(m, indent=1))


def make_root(tmp: Path) -> Path:
    """The benchmark copied under `tmp`, with the tiny cell added."""
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("runs", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    add_cell(tmp, CELL, DATA / "tiny_mono.json", DATA / "tiny_mono.explore.json",
             DATA / "tiny_mono.explore.checks.json")
    return tmp
