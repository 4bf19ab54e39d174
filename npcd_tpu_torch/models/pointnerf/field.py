"""Field heads: density and colour from aggregated features. Port of
npcd_tpu/models/pointnerf/field.py: sigma = softplus(shape_net(feat) - 1),
zero outside valid points; rgb = sigmoid(channel_net(channel_in)). With
``feat_freqs`` > 0 both heads read the feature's positional encoding
[feat | sin/cos octaves] (the 'recurrence' method, as npcd_tpu's
default); with ``use_dir`` the channel net also reads the ray direction,
encoded over ``dir_freqs`` octaves when that is > 0, broadcast over the
ray's samples and cast to the feature's dtype. Under compute_dtype
bfloat16 both MLPs run in bf16 (kernel K7 through apply_mlp up to its
width, npcd_tpu's plain bf16 layers beyond) and their outputs are upcast
to f32 before softplus and sigmoid."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...utils.config import FieldOptions
from .nn_core import Layers, apply_mlp, positional_encoding


def field_heads(params: Dict[str, Layers], opts: FieldOptions, feat: torch.Tensor,
                valid_pt: torch.Tensor, ray_dir: Optional[torch.Tensor] = None,
                compute_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat [..., hid], valid_pt [...], ray_dir [..., 3] (or one per ray
    [*lead, 3] for feat [*lead, S, hid]; read only with ``use_dir``) ->
    (sigma [...], rgb [..., 3]), f32."""
    if opts.feat_freqs > 0:
        feat = positional_encoding(feat, opts.feat_freqs)
    shape = apply_mlp(params["shape_net"], feat, act=opts.activation,
                      compute_dtype=compute_dtype)[..., 0].float()
    sigma = F.softplus(shape - 1.0) if opts.nerf else shape
    sigma = torch.where(valid_pt, sigma, torch.zeros_like(sigma))
    channel_in = feat
    if opts.use_dir and ray_dir is not None:
        if opts.dir_freqs > 0:
            ray_dir = positional_encoding(ray_dir, opts.dir_freqs)
        if ray_dir.dim() < feat.dim():
            ray_dir = ray_dir[..., None, :].expand(*feat.shape[:-1], ray_dir.shape[-1])
        channel_in = torch.cat([feat, ray_dir.to(feat.dtype)], dim=-1)
    rgb = torch.sigmoid(apply_mlp(params["channel_net"], channel_in, act=opts.activation,
                                  compute_dtype=compute_dtype).float())
    return sigma, rgb
