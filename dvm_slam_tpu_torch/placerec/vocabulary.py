"""Binary vocabulary tree (DBoW2 equivalent): training, files and the
batched transform.

Port of `dvm_slam_tpu/placerec/vocabulary.py`. Training, `save` and `load`
are host numpy and copied as they are, so a file written by either package
loads in the other and `train` gives the same arrays. The transform descends
the tree in `depth` rounds of an [F, branch] Hamming argmin; the Hamming
distance of {0,1} values in f32 is an exact integer (TF32 is off,
`device.py`) and `torch.argmin` returns the first minimum like
`jnp.argmin`, so word ids are identical to the reference's. BoW vectors are
dense [W] f32, L1-normalized tf-idf.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


@dataclasses.dataclass
class Vocabulary:
    """levels[l]: [branch^(l+1), 256] uint8 node centers; children of node p
    at level l are rows p*branch + (0..branch-1).
    idf: [W] float32 inverse-document-frequency weights."""

    levels: list
    idf: np.ndarray
    branch: int
    depth: int
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def n_words(self):
        return self.branch ** self.depth

    def device_arrays(self, device=None):
        """(levels, idf) as tensors on `device`, uploaded once per device."""
        device = torch.device("cpu" if device is None else device)
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = (
                tuple(torch.from_numpy(np.asarray(lv)).to(device) for lv in self.levels),
                torch.from_numpy(np.asarray(self.idf, np.float32)).to(device))
        return self._on_device[key]


def _majority(bits):
    """[N,256] -> [256] majority-vote center."""
    return (bits.sum(0) * 2 >= bits.shape[0]).astype(np.uint8)


def _binary_kmeans(rng, descs, k, iters=8):
    """Binary k-means: returns [k,256] centers (padded by resampling).
    Hamming distances via |a xor b| = |a| + |b| - 2 a.b, one sgemm."""
    n = descs.shape[0]
    if n == 0:
        return np.zeros((k, 256), np.uint8)
    centers = descs[rng.choice(n, size=min(k, n), replace=False)]
    if centers.shape[0] < k:
        centers = np.concatenate(
            [centers, descs[rng.randint(0, n, k - centers.shape[0])]]
        )
    df = descs.astype(np.float32)
    pop_d = df.sum(-1)
    for _ in range(iters):
        cf = centers.astype(np.float32)
        d = pop_d[:, None] + cf.sum(-1)[None, :] - 2.0 * (df @ cf.T)  # [N,k]
        assign = d.argmin(1)
        for c in range(k):
            sel = descs[assign == c]
            if len(sel):
                centers[c] = _majority(sel)
    return centers.astype(np.uint8)


def train(descs, branch: int = 10, depth: int = 3, seed: int = 0) -> Vocabulary:
    """Train on [N,256] {0,1} uint8 descriptors (host, numpy)."""
    rng = np.random.RandomState(seed)
    descs = np.asarray(descs, np.uint8)
    levels = []
    groups = [descs]
    for l in range(depth):
        n_nodes = branch ** (l + 1)
        centers = np.zeros((n_nodes, 256), np.uint8)
        next_groups = []
        for gi, g in enumerate(groups):
            c = _binary_kmeans(rng, g, branch)
            centers[gi * branch:(gi + 1) * branch] = c
            if len(g):
                d = (g[:, None, :] != c[None, :, :]).sum(-1)
                a = d.argmin(1)
                next_groups.extend([g[a == j] for j in range(branch)])
            else:
                next_groups.extend([g] * branch)
        levels.append(centers)
        groups = next_groups

    # idf from the training corpus, each descriptor one word occurrence
    words = np.array([len(g) for g in groups], np.float64)
    n = max(descs.shape[0], 1)
    idf = np.log(n / np.maximum(words, 1.0)).astype(np.float32)
    return Vocabulary(levels=levels, idf=idf, branch=branch, depth=depth)


def save(voc: Vocabulary, path: str):
    np.savez_compressed(
        path, idf=voc.idf, branch=voc.branch, depth=voc.depth,
        **{f"level{i}": l for i, l in enumerate(voc.levels)},
    )


def load(path: str) -> Vocabulary:
    z = np.load(path)
    depth = int(z["depth"])
    return Vocabulary(
        levels=[z[f"level{i}"] for i in range(depth)],
        idf=z["idf"], branch=int(z["branch"]), depth=depth,
    )


def load_default() -> Vocabulary:
    """The shipped pretrained vocabulary, `data/voc_default.npz` (10^4
    words: levels 10/100/1000/10000 x 256 uint8, idf [10000] f32)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return load(os.path.join(here, "..", "..", "data", "voc_default.npz"))


def transform_words(levels, desc, valid, branch: int):
    """Descend the tree: [F,256] descriptors -> [F] int32 word ids (-1 for
    invalid slots)."""
    F = desc.shape[0]
    dev = desc.device
    cur = torch.zeros((F,), dtype=torch.int64, device=dev)
    d = desc.to(torch.float32)
    pop_d = torch.sum(d, dim=-1)
    arange_b = torch.arange(branch, device=dev)
    for lv in levels:
        base = cur * branch
        c = lv[base[:, None] + arange_b[None, :]].to(torch.float32)    # [F,b,256]
        common = torch.bmm(c, d[:, :, None])[..., 0]                   # [F,b]
        ham = pop_d[:, None] + torch.sum(c, dim=-1) - 2.0 * common
        cur = base + torch.argmin(ham, dim=-1)
    return torch.where(valid, cur, -1).to(torch.int32)


def bow_vector(levels, idf, desc, valid, branch: int, n_words: int):
    """[F,256] descriptors -> dense L1-normalized tf-idf BoW [W] float32.
    The word counts are integers (`bincount`), so exact in any order."""
    words = transform_words(levels, desc, valid, branch)
    tgt = torch.where(words >= 0, words, n_words).to(torch.int64)
    counts = torch.bincount(tgt, minlength=n_words + 1)[:n_words].to(torch.float32)
    v = counts * idf
    norm = torch.sum(torch.abs(v))
    return v / torch.clamp(norm, min=1e-12)


def l1_score(q, bows):
    """DBoW2 L1 similarity of one normalized query against [K,W] normalized
    BoWs: s = 1 - 0.5 * |q - b|_1, in [0,1]; an empty BoW scores 0."""
    s = 1.0 - 0.5 * torch.sum(torch.abs(q[None, :] - bows), dim=-1)
    nonempty = (torch.sum(q) > 0) & (torch.sum(bows, dim=-1) > 0)
    return torch.where(nonempty, s, 0.0)
