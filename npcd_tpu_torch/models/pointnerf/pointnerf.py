"""PointNeRF render of explicit point clouds, eval path. Port of
npcd_tpu/models/pointnerf/pointnerf.py: ``PointNeRF.render`` and the eval
branch of ``_render_core_body`` (count-sorted ray packing, ray chunks of
``eval_ray_chunk`` that are skipped when they hold no valid sample, and the
slot-block staircase of ``eval_slot_block``).

The sample-validity test is ``validity="voxel"`` (dilated voxel occupancy).
``validity="knn"`` needs the min-distance kernel (npcd_tpu's
pallas_min_d2_t), which the port does not have yet: it raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ...ops.knn import VoxelOccupancy
from ...utils.config import PointNeRFOptions, pointnerf_default_options
from .aggregator import aggregate_features, compact_valid_samples
from .field import field_heads
from .math_utils import fill_invalid_ray_limits, get_ray_limits_box
from .nn_core import Layers, init_mlp, posenc_dim
from .ray_sampler import generate_rays
from .renderer import fix_shading_depths, ray_march, sample_depths


@dataclasses.dataclass(frozen=True)
class PointNeRFRenderConfig:
    """Render knobs of npcd_tpu's PointNeRFRenderConfig. The train_* fields
    and shading_budget are read by training, which the port does not have
    yet; they are kept so the same YAML ``render_config`` sections load."""

    train_rays: int = 112
    train_instance_chunk: int = 50
    shading_budget: Optional[int] = None
    train_remat: Optional[bool] = None
    train_ray_chunk: int = 256
    eval_ray_chunk: int = 1024
    eval_slot_block: Optional[int] = 5
    validity: str = "knn"


def _mlp_module(layers: Layers) -> nn.ParameterList:
    return nn.ParameterList([nn.Parameter(t) for l in layers for t in (l["w"], l["b"])])


def _layers(plist: nn.ParameterList) -> Layers:
    return [{"w": plist[i], "b": plist[i + 1]} for i in range(0, len(plist), 2)]


class PointNeRF(nn.Module):
    """The PointNeRF decoder MLPs: ``local_field`` (aggregator),
    ``shape_net`` and ``channel_net`` (field heads), each a ParameterList
    [w0, b0, w1, b1, ...] with w as [in, out]."""

    def __init__(self, opts: Optional[PointNeRFOptions] = None,
                 render_config: Optional[PointNeRFRenderConfig] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.opts = o = opts or pointnerf_default_options()
        self.cfg = render_config or PointNeRFRenderConfig()
        unported = [name for name, on in (
            ("field.use_dir", o.field.use_dir), ("field.feat_freqs", o.field.feat_freqs > 0),
            ("renderer.disparity_space_sampling", o.renderer.disparity_space_sampling)) if on]
        if unported:
            raise NotImplementedError(f"options not ported yet: {unported}")
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        agg_in = o.feat_dim + posenc_dim(3, o.aggregator.n_freqs)
        channel_in = o.aggregator.out_dim
        self.local_field = _mlp_module(
            init_mlp(o.aggregator.layers, agg_in, o.aggregator.out_dim, g))
        self.shape_net = _mlp_module(
            init_mlp(o.field.shape_layers, o.aggregator.out_dim, 1, g))
        self.channel_net = _mlp_module(init_mlp(o.field.channel_layers, channel_in, 3, g))

    # -- eval render core -----------------------------------------------------

    def _shade(self, d_c, msk, r_o, r_d, kpp, kpf):
        """kNN aggregation + field heads on the compacted slots
        d_c/msk [I, r, s] -> (sigma [I, r, s], rgb [I, r, s, 3], valid [I, r, s])."""
        o = self.opts
        n_i, n_r, n_s = d_c.shape
        pts = r_o[:, :, None, :] + d_c[..., None] * r_d[:, :, None, :]
        feat, valid_pt = aggregate_features(
            _layers(self.local_field), o.aggregator, o.knn_radius,
            pts.reshape(n_i, -1, 3), msk.reshape(n_i, -1), kpp, kpf)
        feat = feat.reshape(n_i, n_r, n_s, -1)
        valid_pt = valid_pt.reshape(n_i, n_r, n_s)
        sigma, rgb = field_heads(
            {"shape_net": _layers(self.shape_net), "channel_net": _layers(self.channel_net)},
            o.field, feat, valid_pt)
        return sigma, rgb, valid_pt

    def _field_chunk(self, d_c, msk, r_o, r_d, r_e, kpp, kpf):
        n_i, n_r, m = d_c.shape
        sb = self.cfg.eval_slot_block or 0
        if 0 < sb < m and m % sb == 0:
            # Rays arrive count-sorted, so the slot grid is a staircase:
            # slot blocks with no valid sample in the chunk are not shaded.
            sigma = d_c.new_zeros((n_i, n_r, m))
            rgb = d_c.new_zeros((n_i, n_r, m, 3))
            valid_pt = torch.zeros((n_i, n_r, m), dtype=torch.bool, device=d_c.device)
            for s0 in range(0, m, sb):
                blk = slice(s0, s0 + sb)
                if msk[..., blk].any():
                    sigma[..., blk], rgb[..., blk, :], valid_pt[..., blk] = self._shade(
                        d_c[..., blk], msk[..., blk], r_o, r_d, kpp, kpf)
        else:
            sigma, rgb, valid_pt = self._shade(d_c, msk, r_o, r_d, kpp, kpf)
        d_fixed = fix_shading_depths(d_c, valid_pt, r_e)
        return ray_march(sigma, d_fixed, rgb, self.opts.renderer.white_back)

    def _render_core(self, kp_pos, kp_feat, occ, rays_o, rays_d, max_shading_pts,
                     ray_chunk) -> Dict[str, torch.Tensor]:
        o = self.opts
        i_dim, r_dim = rays_o.shape[:2]
        m = max_shading_pts
        ray_start, ray_end = get_ray_limits_box(rays_o, rays_d, o.renderer.cube_scale)
        ray_start, ray_end = fill_invalid_ray_limits(ray_start, ray_end)
        ray_start, ray_end = ray_start[..., 0], ray_end[..., 0]  # [I, R]
        depths = sample_depths(ray_start, ray_end, o.renderer.depth_resolution)
        x = rays_o[:, :, None, :] + depths[..., None] * rays_d[:, :, None, :]
        valid = occ.query(x.reshape(i_dim, -1, 3)).reshape(depths.shape)
        depths_c, pts_mask = compact_valid_samples(valid, depths, m)  # [I, R, M]
        ray_valid = pts_mask.any(-1)

        # sort rays by valid-sample count, descending: valid rays pack into
        # the leading chunks and each chunk's slot grid is a staircase
        counts = pts_mask.sum(-1)
        order = torch.sort(-counts, dim=1, stable=True).indices  # [I, R]
        take = lambda a: torch.gather(
            a, 1, order.reshape(i_dim, r_dim, *([1] * (a.dim() - 2))).expand_as(a))
        depths_c, pts_mask, rays_o, rays_d, ray_end = map(
            take, (depths_c, pts_mask, rays_o, rays_d, ray_end))

        outs = []
        for c0 in range(0, r_dim, ray_chunk):
            ck = slice(c0, c0 + ray_chunk)
            d_c, msk, r_o, r_d, r_e = (a[:, ck] for a in (depths_c, pts_mask, rays_o,
                                                          rays_d, ray_end))
            if msk.any():
                outs.append(self._field_chunk(d_c, msk, r_o, r_d, r_e, kp_pos, kp_feat))
            else:
                # what ray_march gives an all-invalid chunk of ray_chunk rays
                n = d_c.shape[1]
                bg = 1.0 if o.renderer.white_back else 0.0
                outs.append({
                    "mask": d_c.new_zeros((i_dim, n)),
                    "depth": r_e.max().expand(i_dim, n),
                    "channels": d_c.new_full((i_dim, n, 3), bg),
                })
        inv_order = torch.argsort(order, dim=1)
        out = {}
        for key in outs[0]:
            a = torch.cat([c[key] for c in outs], dim=1)
            out[key] = torch.gather(
                a, 1, inv_order.reshape(i_dim, r_dim, *([1] * (a.dim() - 2))).expand_as(a))
        out["ray_valid"] = ray_valid
        return out

    # -- public API -----------------------------------------------------------

    @torch.no_grad()
    def render(self, coords: torch.Tensor, feats: torch.Tensor, extrinsics: torch.Tensor,
               intrinsics: torch.Tensor, resolution: int = 128,
               max_shading_points: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Render point clouds coords [B, P, 3], feats [B, P, F] from
        extrinsics [B, V, 4, 4] (world2cam) and intrinsics [B, V, 3, 3] ->
        {mask [B, V, R, 1], depth [B, V, R, 1], channels [B, V, R, 3],
        ray_valid [B, V, R]}, R = resolution**2."""
        if self.cfg.validity != "voxel":
            raise NotImplementedError(
                f"validity={self.cfg.validity!r} needs the min-distance kernel "
                f"(npcd_tpu pallas_min_d2_t), not ported yet; use validity='voxel'")
        o = self.opts
        b, v = extrinsics.shape[:2]
        i_dim = b * v
        rays_o, rays_d = generate_rays(extrinsics.reshape(i_dim, 4, 4),
                                       intrinsics.reshape(i_dim, 3, 3), resolution)
        occ_b = VoxelOccupancy.build(coords, o.voxel_grid)
        rep = lambda a: torch.repeat_interleave(a, v, dim=0)
        occ = occ_b._replace(grid=rep(occ_b.grid))
        out = self._render_core(
            rep(coords), rep(feats), occ, rays_o, rays_d,
            max_shading_points or o.aggregator.max_shading_pts, self.cfg.eval_ray_chunk)
        reshape = lambda a: a.reshape(b, v, *a.shape[1:])
        return {
            "mask": reshape(out["mask"])[..., None],
            "depth": reshape(out["depth"])[..., None],
            "channels": reshape(out["channels"]),
            "ray_valid": reshape(out["ray_valid"]),
        }
