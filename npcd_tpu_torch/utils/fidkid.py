"""FID + KID of generated images. Port of npcd_tpu/utils/fidkid.py: the
Frechet distance between the real and fake feature gaussians, and the
stylegan2-ada subset estimator of the Kernel Inception Distance
(polynomial kernel (x.y/d + 1)^3, 100 subsets of up to 1000 features),
both in numpy/scipy as npcd_tpu computes them.

Extractors take images [N, H, W, 3] in [0, 1] and return features [N, D]
as numpy. ``device_resident`` ones (``TorchScriptInceptionExtractor``,
``ProjectionExtractor``) run on their torch device and take the images as a
tensor there, or as numpy, which they move to it first: both feeds give
the same features bit for bit. Real statistics load from the reference's
pickle {mean, cov, feats_np}.
"""
from __future__ import annotations

import pickle
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def calc_fid(fake_mean: np.ndarray, fake_cov: np.ndarray, real_mean: np.ndarray,
             real_cov: np.ndarray, eps: float = 1e-6):
    """Frechet distance between two gaussians -> (fid, mean_term, cov_term);
    the covariance product's square root again with eps on the diagonals
    where the first one is not finite. ``sqrtm`` is called without npcd_tpu's
    ``disp=False``, which SciPy has removed; the root is the same."""
    import scipy.linalg

    diff = fake_mean - real_mean
    mean_term = float(diff @ diff)
    covmean = scipy.linalg.sqrtm(fake_cov @ real_cov)
    if not np.isfinite(covmean).all():
        offset = np.eye(fake_cov.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((fake_cov + offset) @ (real_cov + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    cov_term = float(np.trace(fake_cov) + np.trace(real_cov) - 2 * np.trace(covmean))
    return mean_term + cov_term, mean_term, cov_term


def calc_kid(real_feat: np.ndarray, fake_feat: np.ndarray, num_subsets: int = 100,
             max_subset_size: int = 1000, rng: Optional[np.random.Generator] = None) -> float:
    """The stylegan2-ada subset MMD estimator; subsets drawn from ``rng``."""
    rng = rng or np.random.default_rng()
    n = real_feat.shape[1]
    m = min(min(real_feat.shape[0], fake_feat.shape[0]), max_subset_size)
    t = 0.0
    for _ in range(num_subsets):
        x = fake_feat[rng.choice(fake_feat.shape[0], m, replace=False)]
        y = real_feat[rng.choice(real_feat.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.diag(a).sum()) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


class TorchScriptInceptionExtractor:
    """The StyleGAN TorchScript Inception graph (the network of the published
    FID) on ``device``. Each batch goes through the reference's feed: [0, 1]
    HWC, ``x * 2 - 1`` in the images' dtype, NCHW, float32, then mmgen's
    StyleGAN feed_op ``(x * 127.5 + 128).clamp(0, 255).to(uint8)``, which
    for 255-level images is exactly round(img * 255); then
    ``model(x, return_features=True)``."""

    device_resident = True

    def __init__(self, inception_path: Optional[str] = None, batch_size: int = 32, model=None,
                 device="cuda"):
        self.device = torch.device(device)
        self.model = (model if model is not None
                      else torch.jit.load(inception_path, map_location=self.device).eval())
        self.batch_size = batch_size

    @torch.no_grad()
    def __call__(self, images) -> np.ndarray:
        images = torch.as_tensor(images, device=self.device)
        feats = []
        for start in range(0, len(images), self.batch_size):
            chunk = images[start:start + self.batch_size]
            x = (chunk * 2.0 - 1.0).permute(0, 3, 1, 2).float()
            x = (x * 127.5 + 128).clamp(0, 255).to(torch.uint8)
            feats.append(self.model(x, return_features=True).cpu().numpy())
        return np.concatenate(feats, 0)


class ProjectionExtractor:
    """A fixed linear map of the flattened images, proj [H*W*3, D], applied
    as one f32 matmul on ``device`` (a stand-in for Inception in tests and
    smoke runs)."""

    device_resident = True

    def __init__(self, proj: np.ndarray, device="cuda"):
        self.device = torch.device(device)
        self.proj = torch.as_tensor(np.asarray(proj, np.float32), device=self.device)

    @torch.no_grad()
    def __call__(self, images) -> np.ndarray:
        x = torch.as_tensor(images, device=self.device).float()
        return (x.reshape(len(x), -1) @ self.proj).cpu().numpy()


class FIDKID:
    """Streaming FID/KID accumulator over a feature extractor."""

    def __init__(self, num_images: int, feature_extractor: Callable[..., np.ndarray],
                 inception_pkl: Optional[str] = None, num_subsets: int = 100,
                 max_subset_size: int = 1000):
        self.num_images = num_images
        self.extract = feature_extractor
        self.inception_pkl = inception_pkl
        self.num_subsets = num_subsets
        self.max_subset_size = max_subset_size
        self.real_mean = self.real_cov = self.real_feats_np = None
        self._fake_feats = []
        self._real_feats = []

    def prepare(self) -> None:
        if self.inception_pkl is not None:
            with open(self.inception_pkl, "rb") as f:
                ref = pickle.load(f)
            self.real_mean = ref["mean"]
            self.real_cov = ref["cov"]
            self.real_feats_np = ref["feats_np"]

    def feed(self, images, kind: str) -> None:
        """images [N, H, W, 3] in [0, 1], as the extractor takes them."""
        feats = self.extract(images)
        (self._fake_feats if kind == "fakes" else self._real_feats).append(feats)

    def gather_fakes(self, mesh, objects: List[int], rows_per_object: int) -> None:
        """Every rank's fake features to rank 0, in the global object order
        (data parallelism): ``objects`` names the object of each group of
        ``rows_per_object`` features this rank fed, in feed order. Rank 0's
        features are then those of one process over all the objects."""
        feats = np.concatenate(self._fake_feats, 0) if self._fake_feats else None
        parts = mesh.gather_objects((objects, feats), to_main=True)
        if parts is None:
            return
        rows = {}
        for objs, f in parts:
            for i, idx in enumerate(objs):
                rows[idx] = f[i * rows_per_object:(i + 1) * rows_per_object]
        self._fake_feats = [np.concatenate([rows[i] for i in sorted(rows)], 0)]

    def summary(self, seed: Optional[int] = None) -> Dict[str, float]:
        if self.real_feats_np is None:
            if not self._real_feats:
                raise ValueError("no real statistics: provide inception_pkl or feed(..., 'reals')")
            real = np.concatenate(self._real_feats, 0)[: self.num_images]
            self.real_feats_np = real
            self.real_mean = real.mean(0)
            self.real_cov = np.cov(real, rowvar=False)

        fake = np.concatenate(self._fake_feats, 0)[: self.num_images]
        fake_mean = fake.mean(0)
        fake_cov = np.cov(fake, rowvar=False)
        fid, mean_term, cov_term = calc_fid(fake_mean, fake_cov, self.real_mean, self.real_cov)
        kid = calc_kid(self.real_feats_np, fake, self.num_subsets, self.max_subset_size,
                       rng=np.random.default_rng(seed)) * 1000
        return {"fid": fid, "fid_mean": mean_term, "fid_cov": cov_term, "kid": kid}
