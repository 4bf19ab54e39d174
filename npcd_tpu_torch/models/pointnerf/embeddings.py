"""Per-object latent tables of the stage-1 autodecoder. Port of
npcd_tpu/models/pointnerf/embeddings.py: the coords table [n_obj, P, 3]
(seeded from the dataset's point clouds, always frozen: a buffer, never a
parameter) and the variational feats table [n_obj, P, 2F] = [mean ||
log_var], zero-initialised (log_var 0: std 1). Training samples
mean + std * eps (PointNeRF.forward)."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class LatentTables(nn.Module):
    def __init__(self, n_obj: int, num_points: int, feat_dim: int):
        super().__init__()
        self.register_buffer("coords_table", torch.zeros((n_obj, num_points, 3)))
        self.feats_table = nn.Parameter(torch.zeros((n_obj, num_points, 2 * feat_dim)))


def feats_mean_log_var_std(table: torch.Tensor, obj_idx: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B] -> mean, log_var, std, each [B, P, F]."""
    emb = table[obj_idx]
    f = emb.shape[-1] // 2
    mean, log_var = emb[..., :f], emb[..., f:]
    return mean, log_var, torch.exp(0.5 * log_var)

