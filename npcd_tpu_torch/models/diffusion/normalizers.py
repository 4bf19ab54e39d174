"""Latent normalization of the diffusion stage. Port of
npcd_tpu/models/diffusion/normalizers.py: unit gaussian (coords: per-axis
mean shift, global std scale) and minus-one-to-one (feats: per-axis
midrange shift, global max half-range scale). Both record the min/max of
the normalized data, which clip the sampler's x0 predictions; the identity
stats clip at +-inf."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NormalizerStats:
    shift: torch.Tensor  # [dim]
    scale: torch.Tensor  # [1] global scale
    min: torch.Tensor    # [1] min of the normalized data
    max: torch.Tensor    # [1] max of the normalized data

    @classmethod
    def identity(cls, dim: int) -> "NormalizerStats":
        return cls(shift=torch.zeros(dim), scale=torch.ones(1),
                   min=torch.full((1,), -float("inf")), max=torch.full((1,), float("inf")))

    def to(self, device) -> "NormalizerStats":
        return NormalizerStats(*(getattr(self, f.name).to(device)
                                 for f in dataclasses.fields(self)))


def _stats(data: np.ndarray, shift: np.ndarray, scale: float) -> NormalizerStats:
    normed = (data - shift[:, None]) / scale
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return NormalizerStats(shift=f32(shift), scale=f32([scale]),
                           min=f32([normed.min()]), max=f32([normed.max()]))


def _as_2d(data) -> np.ndarray:
    data = np.asarray(data, dtype=np.float64)
    return data.reshape(data.shape[0], -1)  # [dim, num_data_points]


def fit_unit_gaussian(data) -> NormalizerStats:
    """data: [dim, num_data_points] (or [dim, ...])."""
    data = _as_2d(data)
    return _stats(data, data.mean(axis=1), data.std(ddof=1))


def fit_minus_one_to_one(data) -> NormalizerStats:
    """data: [dim, num_data_points] (or [dim, ...])."""
    data = _as_2d(data)
    dmin, dmax = data.min(axis=1), data.max(axis=1)
    return _stats(data, (dmin + dmax) / 2.0, ((dmax - dmin) / 2.0).max())


def normalize(stats: NormalizerStats, x: torch.Tensor) -> torch.Tensor:
    """x: [N, dim, num_points]."""
    return (x - stats.shift[None, :, None]) / stats.scale[None, :, None]


def denormalize(stats: NormalizerStats, x: torch.Tensor) -> torch.Tensor:
    """x: [N, dim, num_points]."""
    return x * stats.scale[None, :, None] + stats.shift[None, :, None]
