"""kNN, radius test and voxel occupancy of the PointNeRF path. Port of
npcd_tpu/ops/knn.py: the kNN goes through kernel K4 and the radius test
(the `validity: knn` sample filter) through kernel K5 (ops/kernels/knn.py);
the voxel-occupancy validity test is plain tensor code (scatter, 3x3x3
dilation, gather). npcd_tpu's transposed within_radius_t takes queries as
[B, 3, N] for the TPU's tiling; the port builds them as [B, N, 3] and
calls within_radius."""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..utils.config import VoxelGridOptions
from .kernels.knn import knn, min_d2


def dense_knn_batched(x: torch.Tensor, points: torch.Tensor, k: int,
                      radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, N, 3], points [B, P, 3] -> (idx [B, N, k] int32,
    mask [B, N, k] bool: the neighbour lies within ``radius``)."""
    idx, d2 = knn(x.contiguous(), points.contiguous(), k)
    return idx, d2 < radius * radius


def within_radius(x: torch.Tensor, points: torch.Tensor, radius: float) -> torch.Tensor:
    """x [B, N, 3], points [B, P, 3] -> [B, N] bool: some point of the
    instance lies within ``radius`` (min squared distance < radius**2)."""
    return min_d2(x.detach().contiguous(), points.detach().contiguous()) < radius * radius


class VoxelOccupancy(NamedTuple):
    """Dilated occupancy grid of a batch of point clouds: grid [B, Gx, Gy, Gz]
    bool is True where the voxel's kernel window holds at least one point."""

    grid: torch.Tensor
    origin: torch.Tensor      # [3] lower corner
    voxel_size: torch.Tensor  # [3] scaled voxel edge lengths
    dims: Tuple[int, int, int]

    @staticmethod
    def build(points: torch.Tensor, opts: VoxelGridOptions) -> "VoxelOccupancy":
        """points: [B, P, 3]."""
        dev = points.device
        lo = torch.tensor(opts.ranges[:3], dtype=torch.float32, device=dev)
        vsize = torch.tensor(opts.scaled_voxel_size, dtype=torch.float32, device=dev)
        dims = tuple(math.ceil((h - l) / v) for h, l, v in
                     zip(opts.ranges[3:], opts.ranges[:3], opts.scaled_voxel_size))
        dims_t = torch.tensor(dims, dtype=torch.int64, device=dev)
        b, p, _ = points.shape
        cell = torch.floor((points - lo) / vsize).long()
        in_range = ((cell >= 0) & (cell < dims_t)).all(-1)  # [B, P]
        cell = torch.minimum(cell.clamp(min=0), dims_t - 1)
        flat = (cell[..., 0] * dims[1] + cell[..., 1]) * dims[2] + cell[..., 2]
        occ = torch.zeros((b, dims[0] * dims[1] * dims[2]), dtype=torch.bool, device=dev)
        batch_idx = torch.arange(b, device=dev)[:, None].expand(b, p)
        occ[batch_idx[in_range], flat[in_range]] = True
        # dilate by the kernel window: a max over the in-grid neighbours
        kx, ky, kz = opts.kernel_size
        occ = F.max_pool3d(occ.reshape(b, 1, *dims).float(), (kx, ky, kz), stride=1,
                           padding=((kx - 1) // 2, (ky - 1) // 2, (kz - 1) // 2))
        return VoxelOccupancy(grid=occ[:, 0] > 0, origin=lo, voxel_size=vsize, dims=dims)

    def query(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, ..., 3] -> bool [B, ...]: the sample lies in an occupied
        (dilated) voxel."""
        dims_t = torch.tensor(self.dims, dtype=torch.int64, device=x.device)
        cell = torch.floor((x - self.origin) / self.voxel_size).long()
        in_range = ((cell >= 0) & (cell < dims_t)).all(-1)
        cell = torch.minimum(cell.clamp(min=0), dims_t - 1)
        flat = (cell[..., 0] * self.dims[1] + cell[..., 1]) * self.dims[2] + cell[..., 2]
        b = x.shape[0]
        occupied = torch.gather(self.grid.reshape(b, -1), 1, flat.reshape(b, -1))
        return occupied.reshape(in_range.shape) & in_range
