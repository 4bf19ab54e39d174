"""Field heads: density and colour from aggregated features. Port of
npcd_tpu/models/pointnerf/field.py for view-independent fields without a
feature encoding (the configs' setting): sigma = softplus(shape_net(feat) - 1),
zero outside valid points; rgb = sigmoid(channel_net(feat)). Under
compute_dtype bfloat16 both MLPs run in bf16 (kernel K7 through apply_mlp)
and their outputs are upcast to f32 before softplus and sigmoid."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...utils.config import FieldOptions
from .nn_core import Layers, apply_mlp


def field_heads(params: Dict[str, Layers], opts: FieldOptions, feat: torch.Tensor,
                valid_pt: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat [..., hid], valid_pt [...] -> (sigma [...], rgb [..., 3]), f32."""
    shape = apply_mlp(params["shape_net"], feat, act=opts.activation,
                      compute_dtype=compute_dtype)[..., 0].float()
    sigma = F.softplus(shape - 1.0) if opts.nerf else shape
    sigma = torch.where(valid_pt, sigma, torch.zeros_like(sigma))
    rgb = torch.sigmoid(apply_mlp(params["channel_net"], feat, act=opts.activation,
                                  compute_dtype=compute_dtype).float())
    return sigma, rgb
