"""The plain reference's own arithmetic: its FAST detection and selection
against the program's on one image, and the reprojection chi2."""

import numpy as np
import torch

from portbench import reference, world


def _image(seed=7, h=120, w=160):
    gen = torch.Generator().manual_seed(seed)
    tex = world.make_texture(gen, 256, "cpu")
    return tex[:h, :w].round()


def test_keypoint_selection_matches_the_program_on_an_image():
    from dvm_slam_tpu_torch.ops import fast

    img = _image()
    for budget in (40, 150):
        xy, _, valid = fast.detect_level(img, 20.0, 7.0, reference.GRID, budget)
        theirs = set(map(tuple, xy[valid].long().tolist()))
        mine = reference.select_keypoints(img, 20.0, 7.0, budget)
        assert len(mine) > 10
        assert mine == theirs


def test_fast_score_marks_a_bright_dot_and_not_a_flat_patch():
    img = torch.full((40, 40), 100.0)
    img[20, 20] = 200.0
    s = reference.fast_score(img, 20.0)
    assert s[20, 20] == 16 * (100.0 - 20.0)
    assert float(s.sum()) == float(s[20, 20])
    assert reference.strict_max3(s)[20, 20] > 0


def test_level_budgets_are_orb_extractors():
    b = reference.level_budgets(1250, 8, 1.2)
    assert len(b) == 8 and b[0] > b[-1] >= 8
    assert abs(sum(b) - 1250) <= 8


def test_reprojection_chi2():
    K = (100.0, 100.0, 50.0, 40.0)
    pose = np.array([[1.0, 0, 0, 0, 0, 0, 0], [1.0, 0, 0, 0, -0.5, 0, 0]])  # identity, shifted
    pts = np.array([[0.0, 0.0, 2.0], [0.5, 0.2, 4.0]])
    xy = np.zeros((2, 3, 2))
    for i, t in enumerate(pose[:, 4:]):
        pc = pts + t
        xy[i, :2] = np.stack([K[0] * pc[:, 0] / pc[:, 2] + K[2],
                              K[1] * pc[:, 1] / pc[:, 2] + K[3]], -1)
    xy[1, 1, 0] += 3.0                     # 3 px off on level 1 (scale 1.2)
    level = np.array([[0, 0, 0], [0, 1, 0]])
    obs = np.array([[0, 1, -1], [0, 1, -1]])
    chi2, rows = reference.reprojection(pose, xy, level, obs, pts, K, 1.2)
    assert sorted(rows.tolist()) == [0, 0, 1, 1]
    assert np.allclose(np.sort(chi2), [0, 0, 0, 9.0 / 1.44])
    # a point seen once is not judged
    chi2, _ = reference.reprojection(pose, xy, level, np.array([[0, -1, -1], [0, 1, -1]]),
                                     pts, K, 1.2)
    assert len(chi2) == 2
