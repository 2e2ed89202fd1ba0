"""Whole runs of the tiny CPU cell: the harness's look for a card is
skipped and the rest of a run is driven, sound and with the timed path
broken underneath, and in a fresh process that must load nothing of JAX."""

import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny

SECONDS = 8.0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, seed):
    result, lines, _ = harness.run_cell(tiny.CELL, seed, SECONDS, False, root, device="cpu")
    return result


def test_sound_run_is_correct(root):
    r = _run(root, 3000000041)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["metrics"]["setup_s"]["value"] > 0
    # the system's device memory is read from the card's allocator: nothing on the CPU
    assert "device_memory_gib" not in r["metrics"]
    assert list(r)[-1] == "checks"


def _window_only(monkeypatch):
    """A switch that turns on when the window opens, so a fault leaves the
    warm-up (and the initialization in it) alone."""
    on = {"window": False}
    measure = harness.measure

    def opened(*args, **kwargs):
        on["window"] = True
        return measure(*args, **kwargs)

    monkeypatch.setattr(harness, "measure", opened)
    return on


def _state_unchanged(monkeypatch, on):
    from dvm_slam_tpu_torch.geometry import lie
    from dvm_slam_tpu_torch.tracking import tracker

    step = tracker.motion_model_step

    def frozen(T_last, res, config):
        if not on["window"]:
            return step(T_last, res, config)
        return T_last, lie.se3_identity(device=T_last.device)

    monkeypatch.setattr(tracker, "motion_model_step", frozen)


def _describe_fault(monkeypatch, on, fault):
    from dvm_slam_tpu_torch.frontend import extractor

    describe = extractor._orient_and_describe

    def broken(*args):
        ang, desc = describe(*args)
        if on["window"]:
            ang, desc = ang.clone(), desc.clone()
            if fault == "half":
                half = ang.shape[0] // 2
                ang[half:] = 0.0
                desc[half:] = 0
            else:
                desc[:, 0] ^= 1
        return ang, desc

    monkeypatch.setattr(extractor, "_orient_and_describe", broken)


def _ba_skipped(monkeypatch, on):
    from dvm_slam_tpu_torch.mapping import local_mapping

    local_ba = local_mapping.local_ba

    def skipped(m, *args, **kwargs):
        return (m, None) if on["window"] else local_ba(m, *args, **kwargs)

    monkeypatch.setattr(local_mapping, "local_ba", skipped)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered",
                                   "ba_skipped"])
def test_faults_come_out_not_correct(root, monkeypatch, fault):
    on = _window_only(monkeypatch)
    if fault == "state_unchanged":        # the pose chain never moves
        _state_unchanged(monkeypatch, on)
    elif fault == "half_the_batch":       # K1 describes half the keypoints
        _describe_fault(monkeypatch, on, "half")
    elif fault == "answer_altered":       # a descriptor bit flipped as K1 makes it
        _describe_fault(monkeypatch, on, "flip")
    else:                                 # the mapper chain's local BA (K2/K3) skipped
        _ba_skipped(monkeypatch, on)
    r = _run(root, 3000000042)
    assert on["window"]
    assert not r["correct"], r["checks"]


def test_a_run_loads_nothing_of_jax(root):
    code = (f"import sys; sys.path.insert(0, {str(tiny.REPO)!r})\n"
            "import torch; torch.set_num_threads(2)\n"
            "from pathlib import Path\n"
            "from portbench import harness\n"
            f"r, _, _ = harness.run_cell({tiny.CELL!r}, 5, 2.0, False, Path({str(root)!r}), "
            "device='cpu')\n"
            "print('BANNED', harness.banned_modules(), r['correct'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900)
    line = [x for x in out.stdout.splitlines() if x.startswith("BANNED")]
    assert line, out.stderr[-2000:]
    assert line[0] == "BANNED [] True"


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dvm_slam_tpu_torch_fake", object())
    assert "dvm_slam_tpu_torch_fake" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.fake", object())
    assert "jax.fake" in harness.banned_modules()


def test_traced_run_profiles_after_the_window(root):
    result, _, host = harness.run_cell(tiny.CELL, 3000000043, SECONDS, True, root,
                                       device="cpu")
    assert result["correct"], result["checks"]
    m = result["metrics"]
    assert m["host_frames_per_s"]["value"] == pytest.approx(host["frames_per_s"])
    assert m["frontend_ms_per_frame"]["value"] > 0 and m["tracking_ms_per_frame"]["value"] > 0
    assert "setup_s" not in m     # a traced run reports the per-layer metrics
