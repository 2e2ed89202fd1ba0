"""The control of `correct` on the card: every cell of the manifest, run
at its own size with the program's f32 matrix products in TF32, has to come
out not correct on three seeds. Needs the card (marker `cuda`); run on the
chip with `python -m pytest portbench/tests/test_portbench_control.py -m
cuda -s`."""

import json

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

CELLS = [w["name"] for w in json.loads((tiny.REPO / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (3000000101, 3000000102, 3000000103)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_is_not_correct(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("the control runs on the card only: no CUDA device here")
    m = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    try:
        result, _, _ = harness.run_cell(cell, seed, m["run_seconds"], False, tiny.REPO,
                                        control="tf32")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print("CONTROL", json.dumps({"cell": cell, "seed": seed, "checks": result["checks"]}))
    assert not result["correct"], result["checks"]
