"""Farthest point sampling. Port of npcd_tpu/ops/fps.py: torch ops on the
points' own device, the same index set as npcd_tpu's (seed ``start_idx``,
a running minimum of the squared distance to the points taken so far, the
argmax taking the lowest index on ties). The SRN loader runs it on the
CPU, once per object, to subsample a ground-truth cloud."""
from __future__ import annotations

from typing import Tuple

import torch


def farthest_point_sampling(points: torch.Tensor, k: int,
                            start_idx: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """points [N, 3] f32 -> (sampled [k, 3], idx [k] int64)."""
    idx = torch.zeros(k, dtype=torch.long, device=points.device)
    idx[0] = start_idx
    min_d2 = torch.full(points.shape[:1], float("inf"), dtype=points.dtype,
                        device=points.device)
    x, y, z = points.unbind(-1)
    for i in range(1, k):  # no host sync: the last index stays on the device
        last = points.index_select(0, idx[i - 1:i])  # [1, 3]
        dx, dy, dz = x - last[:, 0], y - last[:, 1], z - last[:, 2]
        # npcd_tpu's sum of the three squares, in its order
        torch.minimum(min_d2, dx * dx + dy * dy + dz * dz, out=min_d2)
        idx[i] = torch.argmax(min_d2)
    return points[idx], idx
