"""Find a cell's files by the names in `BENCHMARK.json`. Imports no torch,
so `run.py` can read the cell's thread count before torch is loaded.

A cell `<config>.<traffic>` runs the configuration file the manifest names
for `<config>`, the traffic `portbench/traffic/<config>.<traffic>.json`
and the correctness limits `portbench/checks/<config>.<traffic>.json`. A
metric `<name>` is read by `portbench/metrics/<name>.py`. A new cell or
metric is files and manifest entries, never an edit.
"""

from __future__ import annotations

import json
from pathlib import Path

BENCH_DIR = "portbench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path) -> dict:
    """Everything one run of `workload` needs, as plain data: the cell's
    manifest entry, its configuration, traffic and limits, and the names of
    the end-to-end and per-layer metrics it reports."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    entry = configs[cell["config"]]
    bench = root / BENCH_DIR

    def reports(metric):
        return workload in metric.get("workloads", [workload])

    return dict(
        manifest=manifest, cell=cell,
        config=load_json(root / entry["file"]),
        traffic=load_json(bench / "traffic" / f"{cell['config']}.{cell['traffic']}.json"),
        checks=load_json(bench / "checks" / f"{workload}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if reports(m)],
        per_layer=[m for m in manifest["per_layer"] if reports(m)],
        run_seconds=manifest["run_seconds"],
    )
