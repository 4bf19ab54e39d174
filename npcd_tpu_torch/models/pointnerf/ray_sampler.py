"""Pinhole camera rays. Port of npcd_tpu/models/pointnerf/ray_sampler.py:
ray index = row * resolution + col, pixel centers at (col + 0.5, row + 0.5),
world2cam extrinsics inverted to world-space origins and unit directions."""
from __future__ import annotations

from typing import Tuple

import torch


def generate_rays(extr: torch.Tensor, intr: torch.Tensor,
                  resolution: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """extr [N, 4, 4] world2cam, intr [N, 3, 3] -> (origins [N, R, 3],
    unit dirs [N, R, 3]), R = resolution**2."""
    n = extr.shape[0]
    fx, fy = intr[:, 0, 0, None], intr[:, 1, 1, None]
    cx, cy = intr[:, 0, 2, None], intr[:, 1, 2, None]
    sk = intr[:, 0, 1, None]

    u = torch.arange(resolution, dtype=torch.float32, device=extr.device) + 0.5
    yy, xx = torch.meshgrid(u, u, indexing="ij")
    x_cam = xx.reshape(1, -1).expand(n, -1)
    y_cam = yy.reshape(1, -1).expand(n, -1)
    z_cam = torch.ones_like(x_cam)

    x_lift = (x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx * z_cam
    y_lift = (y_cam - cy) / fy * z_cam
    cam_points = torch.stack([x_lift, y_lift, z_cam], dim=-1)  # [N, R, 3]

    # The 3x3 products and the norm are written out as elementwise ops in a
    # fixed order rather than as matmuls and reductions, whose summation
    # order depends on the device and the batch: a ray one ulp off can flip
    # the render's discrete validity and neighbour decisions for a pixel.
    rot_c2w = extr[:, None, :3, :3].transpose(-1, -2)  # [N, 1, 3, 3]
    rotate = lambda v: (rot_c2w[..., 0] * v[..., 0:1] + rot_c2w[..., 1] * v[..., 1:2]
                        + rot_c2w[..., 2] * v[..., 2:3])
    cam_locs = -rotate(extr[:, None, :3, 3])  # [N, 1, 3]
    world_points = rotate(cam_points) + cam_locs
    ray_dirs = world_points - cam_locs
    sq = ray_dirs * ray_dirs
    ray_dirs = ray_dirs / torch.sqrt(sq[..., 0:1] + sq[..., 1:2] + sq[..., 2:3])
    return cam_locs.expand_as(ray_dirs), ray_dirs
