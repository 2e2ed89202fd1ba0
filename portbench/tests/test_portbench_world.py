"""The frozen generator: the layout and path come from the traffic file,
the texture and the noise from the seed."""

import numpy as np
import torch

from portbench import manifest, world
from portbench.tests import tiny


def _traffic():
    return manifest.load_json(tiny.DATA / "tiny_mono.explore.json")


def _frames(seed, n=3):
    tr = _traffic()
    gen = torch.Generator().manual_seed(seed)
    w = world.World(tr, gen, "cpu")
    R, c = world.camera_path(tr["trajectory"], n)
    return w, world.render_sequence(w, R, c, (260.0, 260.0, 160.0, 120.0), 60, 80,
                                    tr["noise_sigma"], gen)


def test_layout_is_the_same_across_seeds_and_the_texture_differs():
    w1, f1 = _frames(3000000001)
    w2, f2 = _frames(17)
    for a, b in zip(w1.planes, w2.planes):
        assert all(np.array_equal(a[k], b[k]) for k in ("p0", "normal", "u", "v"))
        assert a["half"] == b["half"]
    assert not torch.equal(w1.texture, w2.texture)
    assert not torch.equal(f1, f2)


def test_same_seed_same_images():
    _, f1 = _frames(2 ** 31 + 5)
    _, f2 = _frames(2 ** 31 + 5)
    assert torch.equal(f1, f2) and f1.dtype == torch.uint8
    assert f1.float().std() > 10     # textured, not blank


def test_path_segments_and_wobble():
    spec = {"segments": [{"frames": 2, "velocity": [1.0, 0, 0]},
                         {"frames": 2, "velocity": [0, 0, 0]}],
            "wobble": [{"axis": "yaw", "amp": 0.1, "period": 4}]}
    R, c = world.camera_path(spec, 4)
    assert np.allclose(c[:, 0], [0, 1, 2, 2])
    assert np.allclose(R[1] @ [0, 0, 1], [np.sin(0.1), 0, np.cos(0.1)])


def test_distance_to_surface():
    tr = _traffic()
    w = world.World(tr, torch.Generator().manual_seed(1), "cpu")
    # on the background wall, and a metre in front of it far from any patch
    d = w.distance_to_surface([[100.0, 50.0, 6.0], [100.0, 50.0, 5.0]])
    assert np.allclose(d, [0.0, 1.0])
