"""Volume rendering. Port of npcd_tpu/models/pointnerf/renderer.py:
depth samples uniform in depth or in disparity, with the training jitter,
the cummax fix of compacted shading depths, front-to-back alpha compositing
with an optional white background, and the per-point compositing of the
aggregation weights (the ``kp_weights`` diagnostic)."""
from __future__ import annotations

from typing import Dict, Optional

import torch


def sample_depths(ray_start: torch.Tensor, ray_end: torch.Tensor, depth_resolution: int,
                  jitter: Optional[torch.Tensor] = None, disparity: bool = False) -> torch.Tensor:
    """[...] -> [..., S] inclusive linspace in depth; in training each
    sample moves by jitter [..., S] (uniform in [0, 1)) times the spacing.
    ``disparity``: uniform in inverse depth, t = step + jitter / (S - 1)
    between 1 / ray_start and 1 / ray_end (npcd_tpu renderer.py:41-48,
    whose uniform draw the jitter is)."""
    steps = torch.arange(depth_resolution, dtype=torch.float32,
                         device=ray_start.device) / (depth_resolution - 1)
    if disparity:
        t = steps if jitter is None else steps + jitter / (depth_resolution - 1)
        return 1.0 / ((1.0 / ray_start)[..., None] * (1.0 - t) + (1.0 / ray_end)[..., None] * t)
    depths = ray_start[..., None] + steps * (ray_end - ray_start)[..., None]
    if jitter is not None:
        depths = depths + jitter * ((ray_end - ray_start) / (depth_resolution - 1))[..., None]
    return depths


def fix_shading_depths(depths_c: torch.Tensor, mask: torch.Tensor,
                       ray_end: torch.Tensor) -> torch.Tensor:
    """Invalid slots become -inf, a cummax rolls the last valid depth
    forward, and slots still at -inf take ray_end."""
    d = torch.where(mask, depths_c, torch.full_like(depths_c, -float("inf")))
    d = torch.cummax(d, dim=-1).values
    return torch.where(torch.isneginf(d), ray_end[..., None].expand_as(d), d)


def ray_march(sigma: torch.Tensor, depths: torch.Tensor, rgb: torch.Tensor,
              white_back: bool, return_weights: bool = False) -> Dict[str, torch.Tensor]:
    """sigma/depths [..., M], rgb [..., M, 3] -> {mask [...], depth [...],
    channels [..., 3]}, and with ``return_weights`` the compositing weights
    sample_weights [..., M]. The depth clip bounds are the min/max over the
    whole ``depths`` tensor, as in the JAX chunk."""
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
    out = {"mask": weight_total, "depth": depth, "channels": channels}
    if return_weights:
        out["sample_weights"] = weights
    return out


def composite_kp_weights(sample_weights: torch.Tensor, agg_w: torch.Tensor,
                         nb_idx: torch.Tensor, num_kp: int) -> torch.Tensor:
    """sample_weights [..., M], the aggregation weights agg_w and neighbour
    indices nb_idx [..., M, K] -> [..., num_kp]: point p of each ray gets
    the sum over samples m and slots j with nb_idx[m, j] == p of
    sample_weights[m] * agg_w[m, j] (npcd_tpu renderer.py:111-133, the
    reference's index_add_)."""
    coeff = sample_weights[..., None] * agg_w
    lead = coeff.shape[:-2]
    coeff = coeff.reshape(-1, coeff.shape[-2] * coeff.shape[-1])
    out = coeff.new_zeros((coeff.shape[0], num_kp))
    out.scatter_add_(1, nb_idx.reshape(coeff.shape).long(), coeff)
    return out.reshape(*lead, num_kp)
