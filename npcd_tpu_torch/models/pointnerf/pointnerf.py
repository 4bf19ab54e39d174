"""PointNeRF: the autodecoder of stage 1 and the render of explicit point
clouds. Port of npcd_tpu/models/pointnerf/pointnerf.py:

  * ``render`` and the eval branch of ``_render_core_body``: count-sorted
    ray packing, ray chunks of ``eval_ray_chunk`` that are skipped when they
    hold no valid sample, and the slot-block staircase of
    ``eval_slot_block``;
  * the latent tables (``n_obj`` given: ``set_all_coords``,
    ``get_all_coords``, ``get_all_feats``) and ``forward``, the train
    branch: depth jitter, validity, compaction, ``train_rays`` rays
    per view chosen by a top-k over uniform scores among the rays with a
    valid sample, the kNN once for all instances, then kNN aggregation,
    field heads and ray march in chunks of ``train_instance_chunk``
    instances, recomputed in the backward pass (``torch.utils.checkpoint``)
    when ``resolved_train_remat()`` holds.

The sample-validity test is ``validity="knn"`` (a point within the kNN
radius, kernel K5) or ``"voxel"`` (dilated voxel occupancy). The training
shading budget (``render_config.shading_budget``) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.knn import VoxelOccupancy, within_radius
from ...utils.config import PointNeRFOptions, pointnerf_default_options
from .aggregator import aggregate_features, compact_valid_samples, knn_neighbors
from .embeddings import LatentTables, feats_mean_log_var_std
from .field import field_heads
from .math_utils import fill_invalid_ray_limits, get_ray_limits_box
from .nn_core import Layers, init_mlp, posenc_dim
from .ray_sampler import generate_rays
from .renderer import fix_shading_depths, ray_march, sample_depths


@dataclasses.dataclass(frozen=True)
class PointNeRFRenderConfig:
    """Render knobs of npcd_tpu's PointNeRFRenderConfig, with the same YAML
    ``render_config`` section. ``train_rays``, ``train_instance_chunk`` and
    ``train_remat`` are read by ``forward`` (training); ``train_ray_chunk``
    is kept for the YAML only (training chunks instances, as npcd_tpu's);
    ``shading_budget`` other than None raises in training."""

    train_rays: int = 112
    train_instance_chunk: int = 50
    shading_budget: Optional[int] = None
    train_remat: Optional[bool] = None
    train_ray_chunk: int = 256
    eval_ray_chunk: int = 1024
    eval_slot_block: Optional[int] = 5
    validity: str = "knn"

    def resolved_train_remat(self) -> bool:
        """None = auto: npcd_tpu turns it on for f32 compute, the port's
        only dtype."""
        return True if self.train_remat is None else self.train_remat


def _mlp_module(layers: Layers) -> nn.ParameterList:
    return nn.ParameterList([nn.Parameter(t) for l in layers for t in (l["w"], l["b"])])


def _layers(plist: nn.ParameterList) -> Layers:
    return [{"w": plist[i], "b": plist[i + 1]} for i in range(0, len(plist), 2)]


class PointNeRF(nn.Module):
    """The PointNeRF decoder MLPs: ``local_field`` (aggregator),
    ``shape_net`` and ``channel_net`` (field heads), each a ParameterList
    [w0, b0, w1, b1, ...] with w as [in, out]; with ``n_obj``, also the
    stage-1 latent tables (``tables``: the frozen coords buffer and the
    variational feats parameter)."""

    def __init__(self, opts: Optional[PointNeRFOptions] = None,
                 render_config: Optional[PointNeRFRenderConfig] = None,
                 generator: Optional[torch.Generator] = None, n_obj: Optional[int] = None):
        super().__init__()
        self.opts = o = opts or pointnerf_default_options()
        self.cfg = render_config or PointNeRFRenderConfig()
        unported = [name for name, on in (
            ("field.use_dir", o.field.use_dir), ("field.feat_freqs", o.field.feat_freqs > 0),
            ("renderer.disparity_space_sampling", o.renderer.disparity_space_sampling)) if on]
        if unported:
            raise NotImplementedError(f"options not ported yet: {unported}")
        if self.cfg.validity not in ("knn", "voxel"):
            raise ValueError(f"validity must be 'knn' or 'voxel', got {self.cfg.validity!r}")
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        agg_in = o.feat_dim + posenc_dim(3, o.aggregator.n_freqs)
        channel_in = o.aggregator.out_dim
        self.local_field = _mlp_module(
            init_mlp(o.aggregator.layers, agg_in, o.aggregator.out_dim, g))
        self.shape_net = _mlp_module(
            init_mlp(o.field.shape_layers, o.aggregator.out_dim, 1, g))
        self.channel_net = _mlp_module(init_mlp(o.field.channel_layers, channel_in, 3, g))
        self.tables = LatentTables(n_obj, o.num_points, o.feat_dim) if n_obj else None

    # -- latent tables --------------------------------------------------------

    def set_all_coords(self, coords) -> None:
        """Seed the frozen coords table from the dataset's point clouds
        [n_obj, P, 3] (npcd_tpu pointnerf.py:155-161)."""
        table = self.tables.coords_table
        with torch.no_grad():
            table.copy_(torch.as_tensor(coords, dtype=torch.float32).reshape(table.shape))

    def get_all_coords(self) -> torch.Tensor:
        return self.tables.coords_table

    def get_all_feats(self) -> torch.Tensor:
        """The mean half of the variational feats table [n_obj, P, F]."""
        return self.tables.feats_table[..., :self.opts.feat_dim]

    def mlp_state_dict(self) -> Dict[str, torch.Tensor]:
        """The decoder MLPs' state dict (what NPCD.pointnerf holds)."""
        return {k: v for k, v in self.state_dict().items() if not k.startswith("tables.")}

    # -- render core ----------------------------------------------------------

    def _neighbors(self, pts, msk, kpp):
        """knn_neighbors of the shading points pts [I, r, s, 3] (mask msk
        [I, r, s]) -> (idx, nb_mask) [I, r*s, k]."""
        n_i = pts.shape[0]
        return knn_neighbors(pts.reshape(n_i, -1, 3), msk.reshape(n_i, -1), kpp,
                             self.opts.aggregator.k, self.opts.knn_radius)

    def _shade(self, pts, msk, kpp, kpf, neighbors):
        """kNN aggregation + field heads on the compacted slots pts
        [I, r, s, 3] (mask msk [I, r, s]) and their ``_neighbors`` ->
        (sigma [I, r, s], rgb [I, r, s, 3], valid [I, r, s])."""
        o = self.opts
        n_i, n_r, n_s = msk.shape
        feat, valid_pt = aggregate_features(
            _layers(self.local_field), o.aggregator, pts.reshape(n_i, -1, 3),
            msk.reshape(n_i, -1), kpp, kpf, neighbors)
        feat = feat.reshape(n_i, n_r, n_s, -1)
        valid_pt = valid_pt.reshape(n_i, n_r, n_s)
        sigma, rgb = field_heads(
            {"shape_net": _layers(self.shape_net), "channel_net": _layers(self.channel_net)},
            o.field, feat, valid_pt)
        return sigma, rgb, valid_pt

    def _field_chunk(self, d_c, msk, r_o, r_d, r_e, kpp, kpf):
        n_i, n_r, m = d_c.shape
        pts = r_o[:, :, None, :] + d_c[..., None] * r_d[:, :, None, :]
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
                    p_b, m_b = pts[:, :, blk], msk[..., blk]
                    sigma[..., blk], rgb[..., blk, :], valid_pt[..., blk] = self._shade(
                        p_b, m_b, kpp, kpf, self._neighbors(p_b, m_b, kpp))
        else:
            sigma, rgb, valid_pt = self._shade(pts, msk, kpp, kpf,
                                               self._neighbors(pts, msk, kpp))
        d_fixed = fix_shading_depths(d_c, valid_pt, r_e)
        return ray_march(sigma, d_fixed, rgb, self.opts.renderer.white_back)

    def _train_chunk(self, d_c, msk, pts, r_e, kpp, kpf, nb_idx, nb_mask):
        """One chunk of instances, every slot shaded -> (mask, depth, channels)."""
        sigma, rgb, valid_pt = self._shade(pts, msk, kpp, kpf, (nb_idx, nb_mask))
        out = ray_march(sigma, fix_shading_depths(d_c, valid_pt, r_e), rgb,
                        self.opts.renderer.white_back)
        return out["mask"], out["depth"], out["channels"]

    def _render_core(self, kp_pos, kp_feat, occ, rays_o, rays_d, max_shading_pts,
                     ray_chunk, jitter=None, scores=None,
                     select_rays: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Train branch when ``scores`` [I, R] are given (uniform draws that
        choose ``select_rays`` rays per instance), else the eval branch."""
        o = self.opts
        i_dim, r_dim = rays_o.shape[:2]
        m = max_shading_pts
        ray_start, ray_end = get_ray_limits_box(rays_o, rays_d, o.renderer.cube_scale)
        ray_start, ray_end = fill_invalid_ray_limits(ray_start, ray_end)
        ray_start, ray_end = ray_start[..., 0], ray_end[..., 0]  # [I, R]
        depths = sample_depths(ray_start, ray_end, o.renderer.depth_resolution, jitter)
        x = (rays_o[:, :, None, :] + depths[..., None] * rays_d[:, :, None, :]
             ).reshape(i_dim, -1, 3)
        if self.cfg.validity == "voxel":
            valid = occ.query(x)
        else:
            valid = within_radius(x, kp_pos, o.knn_radius)
        depths_c, pts_mask = compact_valid_samples(valid.reshape(depths.shape), depths, m)
        if scores is not None:
            return self._train_core(kp_pos, kp_feat, rays_o, rays_d, ray_end, depths_c,
                                    pts_mask, scores, select_rays)
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

    def _train_core(self, kp_pos, kp_feat, rays_o, rays_d, ray_end, depths_c, pts_mask,
                    scores, select_rays) -> Dict[str, torch.Tensor]:
        i_dim = rays_o.shape[0]
        # select_rays rays per instance: the valid ones first, in the order of
        # their scores (a stable descending sort: ties go to the lower index,
        # as lax.top_k's)
        score = torch.where(pts_mask.any(-1), scores, torch.full_like(scores, -1.0))
        sel_idx = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :select_rays]
        take = lambda a: torch.gather(
            a, 1, sel_idx.reshape(i_dim, select_rays, *([1] * (a.dim() - 2))).expand(
                i_dim, select_rays, *a.shape[2:]))
        depths_c, pts_mask, rays_o, rays_d, ray_end = map(
            take, (depths_c, pts_mask, rays_o, rays_d, ray_end))

        # the kNN once for all instances, outside the recomputed chunks: its
        # indices and mask are small, re-running it in the backward is waste
        pts = rays_o[:, :, None, :] + depths_c[..., None] * rays_d[:, :, None, :]
        nb_idx, nb_mask = self._neighbors(pts, pts_mask, kp_pos)

        ic = min(self.cfg.train_instance_chunk, i_dim)
        remat = self.cfg.resolved_train_remat()
        outs = []
        for c0 in range(0, i_dim, ic):
            args = tuple(a[c0:c0 + ic] for a in (depths_c, pts_mask, pts, ray_end,
                                                  kp_pos, kp_feat, nb_idx, nb_mask))
            if remat:
                outs.append(checkpoint(self._train_chunk, *args, use_reentrant=False))
            else:
                outs.append(self._train_chunk(*args))
        mask, depth, channels = (torch.cat(c, dim=0) for c in zip(*outs))
        return {"mask": mask, "depth": depth, "channels": channels,
                "ray_valid": pts_mask.any(-1), "sel_idx": sel_idx}

    # -- public API -----------------------------------------------------------

    def forward(self, obj_idx: torch.Tensor, intrinsics: torch.Tensor,
                extrinsics: torch.Tensor, pixel_idx: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None):
        """The train forward (the eval path is ``render``) of objects
        obj_idx [B] from intrinsics [B, V, 3, 3] and world2cam extrinsics
        [B, V, 4, 4], on the pixel subset pixel_idx [R_pre] shared by every
        view (flat indices into the default_resolution² frame) -> (pred, aux).

        Feats are sampled as mean + std * eps, depths jittered, and
        ``train_rays`` rays selected per view; pred holds mask/depth
        [B, V, R, 1], channels [B, V, R, 3], ray_valid [B, V, R], ray_idx
        (flat pixel index of each ray) and ray_sel (its position in the pixel
        subset). The draws come from ``generator`` unless ``draws`` gives
        them: feats_eps [B, P, F] and depth_jitter [B*V, R_pre, S] in
        [0, 1), as npcd_tpu's ``draws``. aux holds coords, feats (the means),
        feats_mean, feats_log_var and feats_std [B, P, ...]."""
        o = self.opts
        if self.cfg.shading_budget is not None:
            raise NotImplementedError(
                "render_config.shading_budget: the training shading budget is not ported "
                "(ROADMAP Queue 1.2, with bf16); use shading_budget: null")
        draws = draws or {}
        b, v = extrinsics.shape[:2]
        i_dim = b * v
        dev = extrinsics.device
        coords = self.tables.coords_table[obj_idx]
        f_mean, f_log_var, f_std = feats_mean_log_var_std(self.tables.feats_table, obj_idx)
        eps = draws.get("feats_eps")
        if eps is None:
            eps = torch.randn(f_std.shape, generator=generator, device=dev)
        feats = f_mean + f_std * eps
        aux = {"coords": coords, "feats": f_mean, "feats_mean": f_mean,
               "feats_log_var": f_log_var, "feats_std": f_std}

        pixel_idx = pixel_idx.to(dev).long()
        rays_o, rays_d = generate_rays(extrinsics.reshape(i_dim, 4, 4),
                                       intrinsics.reshape(i_dim, 3, 3), o.default_resolution,
                                       pixel_idx)
        rep = lambda a: torch.repeat_interleave(a, v, dim=0)
        occ = None
        if self.cfg.validity == "voxel":
            occ_b = VoxelOccupancy.build(coords, o.voxel_grid)
            occ = occ_b._replace(grid=rep(occ_b.grid))
        r_dim = rays_o.shape[1]
        jitter = draws.get("depth_jitter")
        if jitter is None:
            jitter = torch.rand((i_dim, r_dim, o.renderer.depth_resolution),
                                generator=generator, device=dev)
        scores = torch.rand((i_dim, r_dim), generator=generator, device=dev)
        out = self._render_core(rep(coords), rep(feats), occ, rays_o, rays_d,
                                o.aggregator.max_shading_pts, self.cfg.eval_ray_chunk,
                                jitter, scores, self.cfg.train_rays)
        reshape = lambda a: a.reshape(b, v, *a.shape[1:])
        return {"mask": reshape(out["mask"])[..., None],
                "depth": reshape(out["depth"])[..., None],
                "channels": reshape(out["channels"]),
                "ray_valid": reshape(out["ray_valid"]),
                "ray_idx": reshape(pixel_idx[out["sel_idx"]]),
                "ray_sel": reshape(out["sel_idx"])}, aux

    @torch.no_grad()
    def render(self, coords: torch.Tensor, feats: torch.Tensor, extrinsics: torch.Tensor,
               intrinsics: torch.Tensor, resolution: int = 128,
               max_shading_points: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Render point clouds coords [B, P, 3], feats [B, P, F] from
        extrinsics [B, V, 4, 4] (world2cam) and intrinsics [B, V, 3, 3] ->
        {mask [B, V, R, 1], depth [B, V, R, 1], channels [B, V, R, 3],
        ray_valid [B, V, R]}, R = resolution**2."""
        o = self.opts
        b, v = extrinsics.shape[:2]
        i_dim = b * v
        rays_o, rays_d = generate_rays(extrinsics.reshape(i_dim, 4, 4),
                                       intrinsics.reshape(i_dim, 3, 3), resolution)
        rep = lambda a: torch.repeat_interleave(a, v, dim=0)
        occ = None
        if self.cfg.validity == "voxel":
            occ_b = VoxelOccupancy.build(coords, o.voxel_grid)
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
