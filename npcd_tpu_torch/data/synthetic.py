"""Stage-1 training data. Port of npcd_tpu/data/synthetic.py
(SyntheticNPCTrain, random_cameras): per object a point cloud uniform in
[-0.5, 0.5]^3 and flat-coloured white-background images from cameras on a
sphere, the same numpy draws as npcd_tpu's for the same seed. The images
are one colour per object, so the dataset keeps the colour and a batch
expands it: the full SRN-sized table (2347 objects x 50 views x 128^2)
never sits in host memory. The SRN datasets are not ported: no SRN data is
in the repository, and the GPU host has no image decoder (ROADMAP Queue 1,
evals and CLIs)."""
from __future__ import annotations

from typing import Dict

import numpy as np


def _look_at_world2cam(eye: np.ndarray) -> np.ndarray:
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(np.dot(up, fwd)) > 0.99:
        up = np.array([1.0, 0.0, 0.0], np.float32)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    rot = np.stack([right, up2, fwd], 0).astype(np.float32)
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = rot
    ext[:3, 3] = -rot @ eye
    return ext


def random_cameras(num_views: int, image_size: int, radius: float = 2.2, seed: int = 0):
    """Cameras on a sphere looking at the origin -> (world2cam [V, 4, 4],
    intrinsics [V, 3, 3])."""
    rng = np.random.default_rng(seed)
    extr, intr = [], []
    focal = image_size * 1.1
    k = np.array([[focal, 0, image_size / 2], [0, focal, image_size / 2], [0, 0, 1]],
                 np.float32)
    for _ in range(num_views):
        theta = rng.uniform(0, 2 * np.pi)
        phi = rng.uniform(0.2, np.pi - 0.2)
        eye = radius * np.array(
            [np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)],
            np.float32)
        extr.append(_look_at_world2cam(eye))
        intr.append(k)
    return np.stack(extr), np.stack(intr)


class SyntheticNPCTrain:
    """Random point clouds and flat-coloured images (not rendered from the
    clouds: they exercise training with the right shapes and ranges)."""

    def __init__(self, n_obj: int = 8, num_views: int = 4, image_size: int = 32,
                 num_points: int = 64, seed: int = 0, **_):
        rng = np.random.default_rng(seed)
        self.extrinsics, self.intrinsics = random_cameras(num_views, image_size, seed=seed)
        self.image_size = image_size
        pcs, colors = [], []
        for _ in range(n_obj):
            pcs.append(rng.uniform(-0.5, 0.5, (num_points, 3)).astype(np.float32))
            colors.append(rng.uniform(0.3, 1.0, (1, 1, 3)).astype(np.float32))
        self.pcs = np.stack(pcs)
        self.colors = np.concatenate(colors).reshape(n_obj, 3)

    def __len__(self) -> int:
        return len(self.pcs)

    def batch(self, indices) -> Dict[str, np.ndarray]:
        """{obj_idx [n] int32, images [n, V, H*W, 3], intrinsics [n, V, 3, 3],
        extrinsics [n, V, 4, 4]} of the objects ``indices``."""
        indices = np.asarray(indices)
        n, v = len(indices), len(self.extrinsics)
        images = np.broadcast_to(self.colors[indices, None, None, :],
                                 (n, v, self.image_size ** 2, 3))
        stack = lambda a: np.ascontiguousarray(np.broadcast_to(a, (n,) + a.shape))
        return {"obj_idx": indices.astype(np.int32),
                "images": np.ascontiguousarray(images),
                "intrinsics": stack(self.intrinsics), "extrinsics": stack(self.extrinsics)}

    def get_all_coords(self) -> np.ndarray:
        """[n_obj, P, 3]."""
        return self.pcs


class SRNCarsTrain:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SRNCarsTrain is not ported: no SRN data is in the repository and the GPU host "
            "has no image decoder (ROADMAP Queue 1, evals and CLIs); use SyntheticNPCTrain")


DATASETS = {"SyntheticNPCTrain": SyntheticNPCTrain, "SRNCarsTrain": SRNCarsTrain}
