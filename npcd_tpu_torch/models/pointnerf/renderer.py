"""Volume rendering at eval time. Port of
npcd_tpu/models/pointnerf/renderer.py: uniform depth samples (no jitter at
eval, no disparity-space sampling), the cummax fix of compacted shading
depths, and front-to-back alpha compositing with an optional white
background."""
from __future__ import annotations

from typing import Dict

import torch


def sample_depths(ray_start: torch.Tensor, ray_end: torch.Tensor,
                  depth_resolution: int) -> torch.Tensor:
    """[...] -> [..., S] inclusive linspace in depth."""
    steps = torch.arange(depth_resolution, dtype=torch.float32,
                         device=ray_start.device) / (depth_resolution - 1)
    return ray_start[..., None] + steps * (ray_end - ray_start)[..., None]


def fix_shading_depths(depths_c: torch.Tensor, mask: torch.Tensor,
                       ray_end: torch.Tensor) -> torch.Tensor:
    """Invalid slots become -inf, a cummax rolls the last valid depth
    forward, and slots still at -inf take ray_end."""
    d = torch.where(mask, depths_c, torch.full_like(depths_c, -float("inf")))
    d = torch.cummax(d, dim=-1).values
    return torch.where(torch.isneginf(d), ray_end[..., None].expand_as(d), d)


def ray_march(sigma: torch.Tensor, depths: torch.Tensor, rgb: torch.Tensor,
              white_back: bool) -> Dict[str, torch.Tensor]:
    """sigma/depths [..., M], rgb [..., M, 3] -> {mask [...], depth [...],
    channels [..., 3]}. The depth clip bounds are the min/max over the whole
    ``depths`` tensor, as in the JAX chunk."""
    deltas = torch.cat([depths[..., 1:] - depths[..., :-1],
                        torch.zeros_like(depths[..., :1])], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * deltas)
    alpha_shifted = torch.cat([torch.ones_like(alpha[..., :1]),
                               1.0 - alpha + 1e-10], dim=-1)
    weights = alpha * torch.cumprod(alpha_shifted, dim=-1)[..., :-1]
    weight_total = weights.sum(-1)
    depth = (weights * depths).sum(-1) / weight_total
    depth = torch.nan_to_num(depth, nan=float("inf"))
    depth = torch.clamp(depth, depths.min(), depths.max())
    channels = torch.einsum("...m,...mc->...c", weights, rgb)
    if white_back:
        channels = channels + (1.0 - weight_total)[..., None]
    return {"mask": weight_total, "depth": depth, "channels": channels}
