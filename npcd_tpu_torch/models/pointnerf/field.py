"""Field heads: density and colour from aggregated features. Port of
npcd_tpu/models/pointnerf/field.py for view-independent fields without a
feature encoding (the configs' setting): sigma = softplus(shape_net(feat) - 1),
zero outside valid points; rgb = sigmoid(channel_net(feat))."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ...utils.config import FieldOptions
from .nn_core import Layers, apply_mlp


def field_heads(params: Dict[str, Layers], opts: FieldOptions, feat: torch.Tensor,
                valid_pt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat [..., hid], valid_pt [...] -> (sigma [...], rgb [..., 3])."""
    shape = apply_mlp(params["shape_net"], feat, act=opts.activation)[..., 0]
    sigma = F.softplus(shape - 1.0) if opts.nerf else shape
    sigma = torch.where(valid_pt, sigma, torch.zeros_like(sigma))
    rgb = torch.sigmoid(apply_mlp(params["channel_net"], feat, act=opts.activation))
    return sigma, rgb
