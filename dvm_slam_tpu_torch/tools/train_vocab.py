#!/usr/bin/env python
"""Train the shipped default vocabulary (data/voc_default.npz).

The reference ships a 10^6-word ORBvoc.txt trained offline on generic image
corpora (`orb_slam3/Vocabulary/`, a missing large blob). This trains our
binary tree on ORB descriptors extracted by THIS framework's front end from
a mix of textured worlds (procedural multi-octave noise across seeds, plus a
real photograph) — 10^4 words by default (branch 10, depth 4).

Port of `dvm_slam_tpu/tools/train_vocab.py`: the descriptors come from the
port's `make_frame` on `device` (`--device`, default `cuda`), the worlds from
the port's `synthetic`. The photograph is matplotlib's bundled sample (read
with Pillow), optional as in the reference: where either is missing the
vocabulary is trained on the procedural worlds alone.

Usage: python -m dvm_slam_tpu_torch.tools.train_vocab [out.npz] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np


def collect_descriptors(n_target=120_000, seed=0, device="cuda"):
    import torch

    from ..frontend.extractor import FrontendConfig, make_frame
    from ..io import synthetic

    dev = torch.device(device)
    fc = FrontendConfig(height=240, width=320, n_features=600)
    K = torch.tensor([260.0, 260.0, 160.0, 120.0], device=dev)
    dist = torch.zeros(4, device=dev)
    pool = []
    rng = np.random.RandomState(seed)

    def harvest(world, n_frames, lateral, forward, yaw):
        traj = synthetic.smooth_trajectory(
            n_frames, lateral=lateral, forward=forward, yaw=yaw,
            seed=rng.randint(1 << 30),
        )
        for T in traj:
            img = world.render(T, K, 240, 320)
            f = make_frame(img, K, dist, fc)
            d = f.desc[f.valid].cpu().numpy()
            if len(d):
                pool.append(d.astype(np.uint8))

    # procedural worlds with different texture seeds/statistics
    for s in range(6):
        world = synthetic.PlaneWorld(seed=100 + s, tex_size=1024,
                                     plane_z=6.0, extent=30.0, device=dev)
        harvest(world, 14, lateral=2.0 + 0.3 * s, forward=0.5, yaw=0.08)
    # a real photograph as texture (matplotlib sample data)
    try:
        from PIL import Image
        from matplotlib import cbook

        photo_path = cbook.get_sample_data("grace_hopper.jpg", asfileobj=False)
    except (ImportError, OSError) as e:  # photo source optional
        print(f"photo texture skipped: {e}", file=sys.stderr)
        photo_path = None
    if photo_path is not None:
        photo = np.asarray(Image.open(photo_path).convert("L"), np.float32)
        tile = np.concatenate([photo, photo[:, ::-1]], axis=1)
        tile = np.concatenate([tile, tile[::-1]], axis=0)
        world = synthetic.PlaneWorld(seed=0, tex_size=1024, plane_z=6.0,
                                     extent=30.0, device=dev)
        t = np.asarray(Image.fromarray(tile.astype(np.uint8)).resize(
            (world.texture.shape[1], world.texture.shape[0])))
        world.texture = torch.from_numpy(t.astype(np.float32)).to(dev)
        harvest(world, 20, lateral=1.8, forward=0.6, yaw=0.1)

    descs = np.concatenate(pool)
    if len(descs) > n_target:
        descs = descs[np.random.RandomState(1).choice(
            len(descs), n_target, replace=False)]
    return descs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--branch", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--descs", type=int, default=120_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..",
        "data", "voc_default.npz",
    )

    from ..placerec import vocabulary

    print("collecting descriptors...", file=sys.stderr)
    descs = collect_descriptors(args.descs, device=args.device)
    print(f"training on {len(descs)} descriptors "
          f"({args.branch}^{args.depth} = {args.branch ** args.depth} words)",
          file=sys.stderr)
    voc = vocabulary.train(descs, branch=args.branch, depth=args.depth, seed=0)
    vocabulary.save(voc, out)
    print(f"saved {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
