"""The benchmark's own synthetic world: textured planes of any orientation,
camera paths with exact ground truth, and the rendered image sequence.

A frozen copy, in PyTorch, of the recipe of `dvm_slam_tpu_torch/io/synthetic.py`
(`make_texture`, `PlaneWorld.render`, `smooth_trajectory`), so that a change
to the program's generator never moves the yardstick. One extension: a
plane is a point, a normal and two in-plane axes, bounded or not, and is
hit along its normal, so a traffic file may place planes of any
orientation.

The traffic file fixes the layout and the path. The seed sets only the
texture and the image noise, drawn from one `torch.Generator` on the device
in a fixed order: the same seed gives the same images.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PLANE_SHIFT = (137.0, 95.9)    # texel offset per plane index, as the copied recipe


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of a linear (triangle) resize along one axis,
    antialiased when downscaling (JAX's `scale_and_translate` recipe)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def make_texture(gen: torch.Generator, size: int, device, octaves: int = 4):
    """[size, size] f32 texture in 0..255: multi-octave value noise plus
    sparse 5x5 bright and dark blobs (strong corners at every scale).

    The upsampling runs in f64 and the blob amplitudes are multiples of
    1/64, whose sums are exact in any order, so the texture does not depend
    on TF32 or on the order of atomic adds."""
    tex = torch.zeros((size, size), dtype=torch.float64, device=device)
    for o in range(octaves):
        s = 8 << o
        small = torch.rand((s, s), generator=gen, device=device, dtype=torch.float64)
        w = torch.from_numpy(resize_weights(s, size).astype(np.float64)).to(device)
        tex += (w.T @ small) @ w * 0.5 ** o
    tex -= tex.min()
    tex *= 255.0 / max(float(tex.max()), 1e-6)
    n_blob = size * size // 512
    ys = torch.randint(2, size - 3, (n_blob,), generator=gen, device=device)
    xs = torch.randint(2, size - 3, (n_blob,), generator=gen, device=device)
    amp = torch.round((torch.rand(n_blob, generator=gen, device=device) * 120 - 60) * 64) / 64
    centers = torch.zeros(size * size, dtype=torch.float32, device=device)
    centers.index_put_((ys * size + xs,), amp, accumulate=True)
    centers = torch.nn.functional.pad(centers.view(size, size), (2, 2, 2, 2))
    box = torch.zeros((size, size), dtype=torch.float32, device=device)
    for dy in range(5):
        for dx in range(5):
            box += centers[dy:dy + size, dx:dx + size]
    return (tex.to(torch.float32) + box).clamp(0, 255)


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def layout_planes(world: dict) -> list:
    """The world's planes as dicts (p0, normal, u, v, half, texel),
    from the explicit `planes` and the `patch_sets` of the traffic file.
    A patch set draws its rectangles from its own fixed `seed`, so the
    layout is the same for every run seed."""
    planes = []
    for p in world.get("planes", []):
        half = p.get("half")
        planes.append(dict(p0=np.asarray(p["p0"], np.float64), normal=_unit(p["normal"]),
                           u=_unit(p["u"]), v=_unit(np.cross(p["normal"], p["u"])),
                           half=(math.inf, math.inf) if half is None else tuple(half),
                           texel=float(p["texel"])))
    for ps in world.get("patch_sets", []):
        rng = np.random.RandomState(ps["seed"])
        normal, u = _unit(ps["normal"]), _unit(ps["u"])
        for _ in range(ps["count"]):
            c = [lo + (hi - lo) * rng.rand() for lo, hi in (ps["x"], ps["y"], ps["z"])]
            h_lo, h_hi = ps["half"]
            hu = h_lo + (h_hi - h_lo) * rng.rand()
            hv = h_lo + (h_hi - h_lo) * rng.rand()
            planes.append(dict(p0=np.asarray(c, np.float64), normal=normal, u=u,
                               v=np.cross(normal, u), half=(hu, hv),
                               texel=float(ps["texel"])))
    return planes


def _rot(axis: str, a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    if axis == "yaw":     # about the camera's y (down) axis: +yaw turns toward +x
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    if axis == "pitch":   # about x
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])   # roll, about z


def camera_path(spec: dict, n_frames: int):
    """Ground truth of every frame: (R_wc [N,3,3], centers [N,3]) in f64.

    The centre moves by each segment's per-frame `velocity` for its
    `frames`; `wobble` terms add `amp * sin(2 pi i / period + phase)` to an
    axis of the centre (x, y, z) or to the yaw, pitch or roll. At the
    identity the camera looks along +z with y down."""
    start = np.asarray(spec.get("start", (0.0, 0.0, 0.0)), np.float64)
    steps = []
    for seg in spec["segments"]:
        steps += [np.asarray(seg["velocity"], np.float64)] * int(seg["frames"])
    if len(steps) < n_frames:
        raise ValueError(f"the path's segments cover {len(steps)} frames, the sequence has "
                         f"{n_frames}")
    centers = start + np.concatenate([np.zeros((1, 3)), np.cumsum(steps[:n_frames - 1], 0)])
    angles = {"yaw": np.zeros(n_frames), "pitch": np.zeros(n_frames), "roll": np.zeros(n_frames)}
    i = np.arange(n_frames, dtype=np.float64)
    for w in spec.get("wobble", []):
        term = w["amp"] * np.sin(2 * np.pi * i / w["period"] + w.get("phase", 0.0))
        if w["axis"] in "xyz":
            centers[:, "xyz".index(w["axis"])] += term
        else:
            angles[w["axis"]] += term
    R = np.stack([_rot("yaw", a) @ _rot("pitch", b) @ _rot("roll", c)
                  for a, b, c in zip(angles["yaw"], angles["pitch"], angles["roll"])])
    return R, centers


class World:
    """The planes of one traffic file with one seed's texture, on `device`."""

    def __init__(self, traffic: dict, gen: torch.Generator, device):
        self.device = torch.device(device)
        self.planes = layout_planes(traffic["world"])
        self.max_depth = float(traffic.get("max_depth", 1e9))
        self.tex_size = int(traffic["texture"]["size"])
        self.texture = make_texture(gen, self.tex_size, self.device)
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,  # noqa: E731
                                        device=self.device)
        self._p = {k: f32([p[k] for p in self.planes]) for k in ("p0", "normal", "u", "v")}
        self._half = f32([p["half"] for p in self.planes])
        self._texel = f32([p["texel"] for p in self.planes])

    def visible_planes(self, R_wc, centers, K, h: int, w: int):
        """Indices of the planes that some camera of the batch may see: an
        unbounded plane always, a rectangle unless, for every camera, its
        four corners lie behind it, beyond `max_depth` or beyond one edge of
        the image. A conservative cull: it only skips work, never a hit."""
        keep = []
        for pi, p in enumerate(self.planes):
            if not np.isfinite(p["half"][0]):
                keep.append(pi)
                continue
            hu, hv = p["half"]
            corners = np.stack([p["p0"] + su * hu * p["u"] + sv * hv * p["v"]
                                for su in (-1, 1) for sv in (-1, 1)])           # [4,3]
            xc = np.einsum("bji,bkj->bki", R_wc, corners[None] - centers[:, None])  # [B,4,3]
            z = xc[..., 2]
            front = z > 1e-3
            zs = np.where(front, z, 1.0)
            px = K[0] * xc[..., 0] / zs + K[2]
            py = K[1] * xc[..., 1] / zs + K[3]
            # a corner behind the camera can project anywhere: keep the plane
            seen = ~front.all(1) | ~((px < 0).all(1) | (px >= w).all(1) | (py < 0).all(1)
                                     | (py >= h).all(1))
            near = (z < self.max_depth).any(1)
            if (front.any(1) & near & seen).any():
                keep.append(pi)
        return keep

    def render(self, R_wc, centers, K, h: int, w: int):
        """[B,h,w] f32 images of the cameras (R_wc [B,3,3], centers [B,3]),
        with pinhole intrinsics K = (fx, fy, cx, cy): nearest plane hit per
        pixel, bilinear texture lookup, 0 where nothing is hit. Element-wise
        f32 only, so TF32 never enters."""
        dev = self.device
        R = torch.as_tensor(R_wc, dtype=torch.float32, device=dev)
        c = torch.as_tensor(centers, dtype=torch.float32, device=dev)
        v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                              torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
        d_cam = torch.stack([(u - K[2]) / K[0], (v - K[3]) / K[1], torch.ones_like(u)], -1)
        d_w = (R[:, None, None, :, :] * d_cam[None, :, :, None, :]).sum(-1)   # [B,h,w,3]
        B = R.shape[0]
        best_t = torch.full((B, h, w), math.inf, device=dev)
        best_ab = torch.zeros((B, h, w, 2), device=dev)
        best_pi = torch.zeros((B, h, w), dtype=torch.int64, device=dev)
        P = self._p
        for pi in self.visible_planes(np.asarray(R_wc), np.asarray(centers), K, h, w):
            n = P["normal"][pi]
            denom = (d_w * n).sum(-1)
            num = ((P["p0"][pi] - c) * n).sum(-1)                              # [B]
            ok = denom.abs() > 1e-9
            t = torch.where(ok, num[:, None, None] / torch.where(ok, denom, 1.0), math.inf)
            rel = c[:, None, None, :] + t[..., None] * d_w - P["p0"][pi]
            a = (rel * P["u"][pi]).sum(-1)
            b = (rel * P["v"][pi]).sum(-1)
            closer = ((t > 1e-3) & (t < self.max_depth) & (a.abs() <= self._half[pi, 0])
                      & (b.abs() <= self._half[pi, 1]) & (t < best_t))
            best_t = torch.where(closer, t, best_t)
            best_ab = torch.where(closer[..., None], torch.stack([a, b], -1), best_ab)
            best_pi = torch.where(closer, pi, best_pi)
        hit = torch.isfinite(best_t)
        texel = self._texel[best_pi]
        pif = best_pi.to(torch.float32)
        n_t = self.tex_size
        tx = best_ab[..., 0] / texel + PLANE_SHIFT[0] * pif
        ty = best_ab[..., 1] / texel + PLANE_SHIFT[1] * pif
        tx = torch.remainder(tx, n_t - 1.001)
        ty = torch.remainder(ty, n_t - 1.001)
        x0 = torch.floor(tx).to(torch.int64)
        y0 = torch.floor(ty).to(torch.int64)
        fx = tx - x0
        fy = ty - y0
        tex = self.texture
        val = (tex[y0, x0] * (1 - fx) * (1 - fy) + tex[y0, x0 + 1] * fx * (1 - fy)
               + tex[y0 + 1, x0] * (1 - fx) * fy + tex[y0 + 1, x0 + 1] * fx * fy)
        return torch.where(hit, val, 0.0)

    def distance_to_surface(self, pts):
        """[N] distance from world points [N,3] (f64 numpy) to the nearest
        plane rectangle: the distance along the normal where the foot lies
        inside the rectangle, else to its nearest edge point."""
        pts = np.asarray(pts, np.float64)
        best = np.full(len(pts), np.inf)
        for p in self.planes:
            rel = pts - p["p0"]
            a, b, d = rel @ p["u"], rel @ p["v"], rel @ p["normal"]
            da = np.maximum(np.abs(a) - p["half"][0], 0.0)
            db = np.maximum(np.abs(b) - p["half"][1], 0.0)
            best = np.minimum(best, np.sqrt(d * d + da * da + db * db))
        return best


def render_sequence(world: World, R_wc, centers, K, h: int, w: int, noise_sigma: float,
                    gen: torch.Generator, views=((0.0, 0.0, 0.0),), batch: int = 32):
    """The whole sequence as uint8 [N, V, h, w] on the world's device: for
    each frame and each view (an offset of the camera along its own axes,
    e.g. a stereo pair's right camera at +baseline along x), the render plus
    Gaussian noise of `noise_sigma` gray levels, rounded and clipped the way
    a camera quantizes."""
    n = len(centers)
    out = torch.empty((n, len(views), h, w), dtype=torch.uint8, device=world.device)
    for s in range(0, n, batch):
        R = R_wc[s:s + batch]
        for vi, off in enumerate(views):
            c = centers[s:s + batch] + R @ np.asarray(off, np.float64)
            img = world.render(R, c, K, h, w)
            noise = torch.randn(img.shape, generator=gen, device=world.device)
            out[s:s + batch, vi] = torch.round(img + noise_sigma * noise).clamp(0, 255).to(
                torch.uint8)
    return out
