"""SRN-ShapeNet training data (cars, chairs). Port of npcd_tpu/data/srn.py.

One sample is one object with all 50 of its training views. Images,
cameras and FPS point clouds are preloaded into host memory on a thread
pool. The files are the reference's: ``{root}/{category}/{id}/rgb/%06d.png``
(read by the port's own PNG reader, data/png.py), ``pose/%06d.txt``
(cam2world, inverted to world2cam), ``intrinsics.txt``, and
``pointcloud3_<P>.npz``, which the loader writes from ``pointcloud3.npz``
by farthest point sampling (ops/fps.py, on the CPU) where it is missing.
Images are float32 [V, H*W, 3] row-major pixels, the render's flat ray
order.

Each object's views are shuffled with a ``random.Random`` (``view_rng``):
npcd_tpu shuffles with Python's global ``random``, which its CLIs seed
with ``--seed``, and ``random.Random(s)`` replays ``random.seed(s)``. A
dataset built without one uses ``random.Random(0)``; the global ``random``
is never touched."""
from __future__ import annotations

import os.path as osp
import random
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.fps import farthest_point_sampling
from ..utils.util import chunks
from .dataset import Dataset, get_path
from .png import read_png
from .registry import register_dataset

SAMPLE_LISTS = osp.join(osp.dirname(osp.realpath(__file__)), "sample_lists")
VIEWS = 50  # training views an SRN object has


def _load_image(path: str, view: int, image_size: int) -> np.ndarray:
    fname = f"{path}/rgb/{view:06d}.png"
    img = read_png(fname)
    if img.shape[:2] != (image_size, image_size):
        raise NotImplementedError(
            f"{fname} is {img.shape[1]} x {img.shape[0]}, image_size {image_size}: npcd_tpu "
            "resizes with PIL's resize, which the port has not ported (only the identity)")
    return img.astype(np.float32) / 255.0  # [H, W, 3]


def _load_camera(path: str, view: int, image_size: int) -> Tuple[np.ndarray, np.ndarray]:
    pose = np.loadtxt(f"{path}/pose/{view:06d}.txt").reshape(4, 4).astype(np.float32)
    # the pose file is cam2world; invert to world2cam
    world2cam = pose.copy()
    world2cam[:3, :3] = pose[:3, :3].T
    world2cam[:3, 3:] = -world2cam[:3, :3] @ pose[:3, 3:]
    intr = _parse_intrinsics(f"{path}/intrinsics.txt", image_size)
    return world2cam, intr


def _parse_intrinsics(file_path: str, image_size: int) -> np.ndarray:
    """SRN's intrinsics.txt (focal cx cy _, two lines, height width) -> K
    [3, 3] rescaled to ``image_size``."""
    with open(file_path, "r") as f:
        focal, cx, cy, _ = map(float, f.readline().split())
        next(f)
        next(f)
        height, width = map(float, f.readline().split())
    if height != width:
        raise ValueError(f"non-square intrinsics in {file_path}")
    cx = cx / width * image_size
    cy = cy / height * image_size
    focal = focal / height * image_size
    return np.array([[focal, 0, cx], [0, focal, cy], [0, 0, 1]], np.float32)


def _load_pointcloud(path: str, num_points: int, fps_lock: threading.Lock) -> np.ndarray:
    """The object's cloud subsampled to ``num_points``: the cache
    ``pointcloud3_<P>.npz`` where it exists, else FPS of
    ``pointcloud3.npz``, whose points and normals at the chosen indices are
    then written as the cache. FPS is hundreds of small torch ops, each of
    which takes the GIL again: ``fps_lock`` lets one loader thread run it at
    a time, since several contending for the GIL run slower together than
    one alone."""
    cached = f"{path}/pointcloud3_{num_points}.npz"
    if osp.isfile(cached):
        with np.load(cached) as z:
            return z["points"].astype(np.float32)
    with np.load(f"{path}/pointcloud3.npz") as z:
        points = np.asarray(z["points"], np.float32)
        normals = np.asarray(z["normals"], np.float32)
    with fps_lock:
        _, idx = farthest_point_sampling(torch.from_numpy(points), num_points)
    idx = idx.numpy()
    sampled = points[idx]
    try:
        np.savez(cached, points=sampled, normals=normals[idx])
    except OSError:
        pass
    return sampled


class SRNTrain(Dataset):
    def __init__(self, root: str, sample_list: List[Tuple[str, str, int]],
                 views_per_sample: int = VIEWS, image_size: int = 128, num_points: int = 512,
                 view_rng: Optional[random.Random] = None, **kwargs):
        super().__init__(root=root, sample_list=sample_list, views_per_sample=views_per_sample,
                         image_size=image_size, num_points=num_points,
                         view_rng=view_rng if view_rng is not None else random.Random(0),
                         **kwargs)

    def _init_samples(self, sample_list, view_rng: random.Random, views_per_sample=VIEWS,
                      image_size=128, num_points=512):
        if VIEWS % views_per_sample:
            raise ValueError(f"views_per_sample {views_per_sample} does not divide {VIEWS}")
        if not self.root or not osp.isdir(self.root):
            raise FileNotFoundError(
                f"SRN root {self.root!r} does not exist; set NPCD_TPU_SRN_ROOT or [srn] root "
                "in npcd_tpu_torch/data/paths.toml or ~/npcd_tpu_data_paths.toml")
        self.image_size = image_size
        self.num_points = num_points
        view_indices = list(range(VIEWS))
        fps_lock = threading.Lock()

        def load_object(entry):
            c, m, _ = entry
            path = f"{self.root}/{c}/{m}"
            try:
                pc = _load_pointcloud(path, num_points, fps_lock)
                images = np.stack([_load_image(path, v, image_size) for v in view_indices])
                cams = [_load_camera(path, v, image_size) for v in view_indices]
            except FileNotFoundError as e:
                raise FileNotFoundError(f"SRN object {c}/{m} under root {self.root!r}: "
                                        f"{e.filename or e} is missing") from e
            extr = np.stack([e for e, _ in cams])
            intr = np.stack([k for _, k in cams])
            return pc, images, extr, intr

        loaded = self.preload_threading(load_object, sample_list, data_str="objects")
        self.pcs = [pc for pc, _, _, _ in loaded]

        for (c, m, i), (pc, images, extr, intr) in zip(sample_list, loaded):
            views = list(view_indices)
            view_rng.shuffle(views)
            for vs in chunks(views, views_per_sample):
                vs = list(vs)
                self.samples.append({
                    "obj_idx": np.int32(i),
                    "obj_name": m,
                    "images": images[vs].reshape(len(vs), -1, 3),  # [V, H*W, 3]
                    "extrinsics": extr[vs],
                    "intrinsics": intr[vs],
                    "view_indices": np.asarray(vs, np.int32),
                })

    def get_all_coords(self) -> np.ndarray:
        return np.stack(self.pcs)  # [n_obj, num_points, 3]


def _read_split(split: str, blacklist: Optional[str]) -> List[Tuple[str, str, int]]:
    """(category, shapenet id, index) of each object of ``srn_<split>.list``
    not in ``blacklist``; the category is the split's first word."""
    black = set()
    if blacklist:
        with open(osp.join(SAMPLE_LISTS, blacklist)) as f:
            black = set(f.read().splitlines())
    out = []
    i = 0
    category = split.split("_")[0]
    with open(osp.join(SAMPLE_LISTS, f"srn_{split}.list")) as f:
        for shapenet_id in f.read().splitlines():
            if shapenet_id not in black:
                out.append((category, shapenet_id, i))
                i += 1
    return out


@register_dataset
class SRNCarsTrain(SRNTrain):
    def __init__(self, root: Optional[str] = None, sample_list=None, **kwargs):
        root = root if root is not None else get_path("srn", "root")
        if sample_list is None:
            sample_list = _read_split("cars_train", "srn_cars_blacklist.list")
        super().__init__(root=root, sample_list=sample_list, **kwargs)


@register_dataset
class SRNChairsTrain(SRNTrain):
    # npcd_tpu ships no chairs sample list (only srn_cars_*.list):
    # ``sample_list`` supplies one until the split file is staged (ASSETS.md)
    def __init__(self, root: Optional[str] = None, sample_list=None, **kwargs):
        root = root if root is not None else get_path("srn", "root")
        if sample_list is None:
            sample_list = _read_split("chairs_train", None)
        super().__init__(root=root, sample_list=sample_list, **kwargs)
