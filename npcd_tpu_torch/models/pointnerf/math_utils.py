"""Ray-box intersection (slab method). Port of
npcd_tpu/models/pointnerf/math_utils.py: rays that miss the centered cube of
half-size ``box_size`` get (tmin, tmax) = (-1, -2)."""
from __future__ import annotations

from typing import Tuple

import torch


def get_ray_limits_box(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       box_size: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """rays_o/rays_d: [..., 3] -> (tmin [..., 1], tmax [..., 1])."""
    inv_d = 1.0 / rays_d
    t_lo = (-box_size - rays_o) * inv_d
    t_hi = (box_size - rays_o) * inv_d
    tmin = torch.minimum(t_lo, t_hi).amax(-1)
    tmax = torch.maximum(t_lo, t_hi).amin(-1)
    is_valid = tmax >= tmin
    tmin = torch.where(is_valid, tmin, torch.full_like(tmin, -1.0))
    tmax = torch.where(is_valid, tmax, torch.full_like(tmax, -2.0))
    return tmin[..., None], tmax[..., None]


def fill_invalid_ray_limits(ray_start: torch.Tensor, ray_end: torch.Tensor):
    """Rays that miss the box take the global min start / max end over the
    valid rays, so every ray gets a sane sampling interval."""
    is_valid = ray_end > ray_start
    keep = is_valid | ~is_valid.any()
    inf = torch.full_like(ray_start, float("inf"))
    min_start = torch.where(is_valid, ray_start, inf).amin()
    max_end = torch.where(is_valid, ray_end, -inf).amax()
    return (torch.where(keep, ray_start, min_start),
            torch.where(keep, ray_end, max_end))
