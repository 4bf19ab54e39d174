"""PointNeRF: the autodecoder of stage 1 and the render of explicit point
clouds. Port of npcd_tpu/models/pointnerf/pointnerf.py:

  * ``render`` and the eval branch of ``_render_core_body``: count-sorted
    ray packing, ray chunks of ``eval_ray_chunk`` that are skipped when they
    hold no valid sample, and the slot-block staircase of
    ``eval_slot_block``;
  * ``eval_forward``, the eval branch of npcd_tpu's ``forward``: ``render``
    of the tables' clouds with the feats mean;
  * the latent tables (``n_obj`` given: ``set_all_coords``,
    ``get_all_coords``, ``get_all_feats``) and ``forward``, the train
    branch: depth jitter, validity, compaction, ``train_rays`` rays
    per view chosen by a top-k over uniform scores among the rays with a
    valid sample, the kNN once for all instances, then kNN aggregation,
    field heads and ray march in chunks of ``train_instance_chunk``
    instances, recomputed in the backward pass (``torch.utils.checkpoint``)
    when ``resolved_train_remat()`` holds; with ``shading_budget``, the valid
    slots of each instance are packed to that fixed budget first (counting-
    sort ranks), shaded there, and gathered back before the ray march.

The sample-validity test is ``validity="knn"`` (a point within the kNN
radius, kernel K5) or ``"voxel"`` (dilated voxel occupancy).
``compute_dtype`` bfloat16 runs the aggregation MLP (K6) and the field heads
(K7) in bf16, in training and in ``render``; the parameters stay f32.
Every option of npcd_tpu's PointNeRFOptions runs: view-dependent colour
(``field.use_dir``, the ray directions packed with the points where the
budget packs them), ``field.feat_freqs``, disparity-space sampling, any k
and posenc method of the aggregator, its activation, and ``render``'s
``kp_weights`` attribution. The render config's ``matmul_precision`` sets
PyTorch's TF32 flags around ``render`` (so ``eval_forward`` too); the
training forward runs under the flags as the caller set them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.knn import VoxelOccupancy, within_radius
from ...parallel.mesh import mesh_world, shard_batch
from ...utils.config import PointNeRFOptions, pointnerf_default_options
from .aggregator import (aggregate_features, compact_valid_samples, gather_rows,
                         knn_neighbors, pack_rows)
from .embeddings import LatentTables, feats_mean_log_var_std, mean_log_var_std
from .field import field_heads
from .math_utils import fill_invalid_ray_limits, get_ray_limits_box
from .nn_core import Layers, init_mlp, posenc_dim
from .ray_sampler import generate_rays
from .renderer import composite_kp_weights, fix_shading_depths, ray_march, sample_depths


# the eval CLIs' --matmul_precision choices, and what the render config takes
CLI_MATMUL_PRECISIONS = ("default", "float32", "highest", "tensorfloat32")
MATMUL_PRECISIONS = (None, *CLI_MATMUL_PRECISIONS, "high")


def set_render_precision(config: dict, precision: str) -> dict:
    """A CLI's ``--matmul_precision`` into
    ``config["render_config"]["matmul_precision"]`` unless the config sets
    one or ``precision`` is "default" (npcd_tpu's eval CLIs) -> config."""
    if precision != "default":
        config["render_config"] = {"matmul_precision": precision,
                                   **config.get("render_config", {})}
    return config


def _tf32_flags() -> tuple:
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def _tf32_setting(precision: Optional[str]) -> Optional[bool]:
    """What a render under ``precision`` sets both TF32 flags to (None:
    leaves them)."""
    return None if precision in (None, "default") else precision in ("tensorfloat32", "high")


def changes_tf32_flags(precision: Optional[str]) -> bool:
    """Whether a render under ``precision`` sets the process-wide TF32 flags
    to other values than they hold now. The flags are global: another thread
    that launches GEMMs or convolutions while such a render runs gets its
    TF32 setting (DiffusionEvaluation waits for its extractor first)."""
    tf32 = _tf32_setting(precision)
    return tf32 is not None and _tf32_flags() != (tf32, tf32)


@contextlib.contextmanager
def matmul_precision(precision: Optional[str]) -> Iterator[None]:
    """Run the body with PyTorch's TF32 flags for cuBLAS matmuls and cuDNN
    set as ``precision`` says (see PointNeRFRenderConfig.matmul_precision),
    and restore both on exit, also on an exception."""
    tf32 = _tf32_setting(precision)
    if tf32 is None:
        yield
        return
    saved = _tf32_flags()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclasses.dataclass(frozen=True)
class PointNeRFRenderConfig:
    """Render knobs of npcd_tpu's PointNeRFRenderConfig, with the same YAML
    ``render_config`` section. ``train_rays``, ``train_instance_chunk``,
    ``shading_budget`` (the per-instance count of packed shading slots;
    None = dense) and ``train_remat`` are read by ``forward`` (training);
    ``train_ray_chunk`` is kept for the YAML only (training chunks
    instances, as npcd_tpu's); ``compute_dtype`` (float32 or bfloat16) is
    the dtype of the MLPs in training and render; ``matmul_precision`` the
    render's f32 matmul precision."""

    train_rays: int = 112
    train_instance_chunk: int = 50
    shading_budget: Optional[int] = None
    train_remat: Optional[bool] = None
    train_ray_chunk: int = 256
    eval_ray_chunk: int = 1024
    eval_slot_block: Optional[int] = 5
    compute_dtype: torch.dtype = torch.float32
    validity: str = "knn"
    # the render's f32 matmul precision (``render``, ``eval_forward``):
    # None or "default" leaves PyTorch's TF32 flags as they are; "highest"
    # or "float32" turns TF32 off for cuBLAS and cuDNN, "tensorfloat32" or
    # "high" on (the field heads' GEMMs and the plain f32 layers). The f32
    # K6f keeps its 3xTF32 products under every setting: three single-pass
    # products on a hi/lo split, what npcd_tpu's Pallas MLP runs under
    # "tensorfloat32".
    matmul_precision: Optional[str] = None

    def __post_init__(self):
        if self.matmul_precision not in MATMUL_PRECISIONS:
            raise ValueError(f"matmul_precision must be one of {MATMUL_PRECISIONS}, got "
                             f"{self.matmul_precision!r}")

    def resolved_train_remat(self) -> bool:
        """None = auto, as npcd_tpu's: off for bf16 compute, on for f32."""
        if self.train_remat is not None:
            return self.train_remat
        return self.compute_dtype != torch.bfloat16


def budget_ranks(pts_mask: torch.Tensor):
    """The packed position of every slot of pts_mask [I, R, m] -> (rank
    [I, R*m], a permutation of 0 .. R*m-1 per instance; n_valid [I]), by
    npcd_tpu's counting sort (pointnerf.py:415-427): valid slots first,
    ordered by sample index j and then ray r (a valid (r, j) lands at the
    count of valid slots with a smaller j plus the valid rays before r at
    j), then the invalid slots in flat order."""
    i_dim = pts_mask.shape[0]
    mask_i = pts_mask.long()
    cnt_j = mask_i.sum(1)  # [I, m]
    offset_j = torch.cumsum(cnt_j, 1) - cnt_j
    prefix_r = torch.cumsum(mask_i, 1) - mask_i  # [I, R, m]
    n_valid = cnt_j.sum(1)
    inv = 1 - mask_i.reshape(i_dim, -1)
    inv_prefix = torch.cumsum(inv, 1) - inv
    rank = torch.where(pts_mask.reshape(i_dim, -1),
                       (offset_j[:, None, :] + prefix_r).reshape(i_dim, -1),
                       n_valid[:, None] + inv_prefix)
    return rank, n_valid


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
        if self.cfg.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                             f"{self.cfg.compute_dtype}")
        if self.cfg.validity not in ("knn", "voxel"):
            raise ValueError(f"validity must be 'knn' or 'voxel', got {self.cfg.validity!r}")
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        agg_in = o.feat_dim + posenc_dim(3, o.aggregator.n_freqs)
        # the heads read the feature's encoding with feat_freqs, as npcd_tpu's
        # field_heads does (its init_params sizes them by out_dim alone)
        head_in = posenc_dim(o.aggregator.out_dim, o.field.feat_freqs)
        channel_in = head_in
        if o.field.use_dir:
            channel_in += posenc_dim(3, o.field.dir_freqs) if o.field.dir_freqs > 0 else 3
        self.local_field = _mlp_module(
            init_mlp(o.aggregator.layers, agg_in, o.aggregator.out_dim, g))
        self.shape_net = _mlp_module(init_mlp(o.field.shape_layers, head_in, 1, g))
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

    def _shade(self, pts, msk, kpp, kpf, neighbors, ray_dir, return_weights=False):
        """kNN aggregation + field heads on the compacted slots pts
        [I, r, s, 3] (mask msk [I, r, s]), their ``_neighbors`` and the ray
        directions ray_dir [I, r, 3] -> (sigma [I, r, s], rgb [I, r, s, 3],
        valid [I, r, s]), and with ``return_weights`` the pair weights and
        neighbour indices [I, r, s, k]."""
        o = self.opts
        n_i, n_r, n_s = msk.shape
        cd = self.cfg.compute_dtype
        agg = aggregate_features(
            _layers(self.local_field), o.aggregator, pts.reshape(n_i, -1, 3),
            msk.reshape(n_i, -1), kpp, kpf, neighbors, cd, return_weights)
        feat = agg[0].reshape(n_i, n_r, n_s, -1)
        valid_pt = agg[1].reshape(n_i, n_r, n_s)
        sigma, rgb = field_heads(
            {"shape_net": _layers(self.shape_net), "channel_net": _layers(self.channel_net)},
            o.field, feat, valid_pt, ray_dir, cd)
        if return_weights:
            return sigma, rgb, valid_pt, *(a.reshape(n_i, n_r, n_s, -1) for a in agg[2:])
        return sigma, rgb, valid_pt

    def _field_chunk(self, d_c, msk, r_o, r_d, r_e, kpp, kpf, kp_weights=False):
        n_i, n_r, m = d_c.shape
        pts = r_o[:, :, None, :] + d_c[..., None] * r_d[:, :, None, :]
        sb = self.cfg.eval_slot_block or 0
        if kp_weights:
            sigma, rgb, valid_pt, agg_w, nb_idx = self._shade(
                pts, msk, kpp, kpf, self._neighbors(pts, msk, kpp), r_d, True)
            out = ray_march(sigma, fix_shading_depths(d_c, valid_pt, r_e), rgb,
                            self.opts.renderer.white_back, return_weights=True)
            out["kp_weights"] = composite_kp_weights(out.pop("sample_weights"), agg_w, nb_idx,
                                                     kpp.shape[1])
            return out
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
                        p_b, m_b, kpp, kpf, self._neighbors(p_b, m_b, kpp), r_d)
        else:
            sigma, rgb, valid_pt = self._shade(pts, msk, kpp, kpf,
                                               self._neighbors(pts, msk, kpp), r_d)
        d_fixed = fix_shading_depths(d_c, valid_pt, r_e)
        return ray_march(sigma, d_fixed, rgb, self.opts.renderer.white_back)

    def _train_chunk(self, d_c, msk, pts, r_d, r_e, kpp, kpf, nb_idx, nb_mask):
        """One chunk of instances, every slot shaded -> (mask, depth, channels)."""
        sigma, rgb, valid_pt = self._shade(pts, msk, kpp, kpf, (nb_idx, nb_mask), r_d)
        out = ray_march(sigma, fix_shading_depths(d_c, valid_pt, r_e), rgb,
                        self.opts.renderer.white_back)
        return out["mask"], out["depth"], out["channels"]

    def _budget_chunk(self, d_c, r_e, rank, c_pts, c_rayd, c_mask, kpp, kpf, nb_idx, nb_mask):
        """One chunk of instances shaded on its packed slots c_pts [I, cap, 3]
        (ray directions c_rayd [I, cap, 3] or None, mask c_mask), then
        gathered back to the [I, R, m] slot grid through ``rank`` [I, R*m] ->
        (mask, depth, channels)."""
        n_i, n_r, m = d_c.shape
        sigma, rgb, valid_c = self._shade(
            c_pts[:, None], c_mask[:, None], kpp, kpf, (nb_idx, nb_mask),
            None if c_rayd is None else c_rayd[:, None])
        packed = torch.cat([sigma[:, 0, :, None], rgb[:, 0],
                            valid_c[:, 0, :, None].to(rgb.dtype)], dim=-1)  # [I, cap, 5]
        full = gather_rows(packed, rank).reshape(n_i, n_r, m, 5)
        valid_f = full[..., 4] > 0.5
        out = ray_march(full[..., 0], fix_shading_depths(d_c, valid_f, r_e), full[..., 1:4],
                        self.opts.renderer.white_back)
        return out["mask"], out["depth"], out["channels"]

    def _render_core(self, kp_pos, kp_feat, occ, rays_o, rays_d, max_shading_pts,
                     ray_chunk, jitter=None, scores=None,
                     select_rays: Optional[int] = None,
                     kp_weights: bool = False) -> Dict[str, torch.Tensor]:
        """Train branch when ``scores`` [I, R] are given (uniform draws that
        choose ``select_rays`` rays per instance), else the eval branch
        (with ``kp_weights``, each ray's composited aggregation weight per
        point, [I, R, P])."""
        o = self.opts
        i_dim, r_dim = rays_o.shape[:2]
        m = max_shading_pts
        ray_start, ray_end = get_ray_limits_box(rays_o, rays_d, o.renderer.cube_scale)
        ray_start, ray_end = fill_invalid_ray_limits(ray_start, ray_end)
        ray_start, ray_end = ray_start[..., 0], ray_end[..., 0]  # [I, R]
        depths = sample_depths(ray_start, ray_end, o.renderer.depth_resolution, jitter,
                               o.renderer.disparity_space_sampling)
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
                outs.append(self._field_chunk(d_c, msk, r_o, r_d, r_e, kp_pos, kp_feat,
                                              kp_weights))
            else:
                # what ray_march gives an all-invalid chunk of ray_chunk rays
                n = d_c.shape[1]
                bg = 1.0 if o.renderer.white_back else 0.0
                outs.append({
                    "mask": d_c.new_zeros((i_dim, n)),
                    "depth": r_e.max().expand(i_dim, n),
                    "channels": d_c.new_full((i_dim, n, 3), bg),
                })
                if kp_weights:
                    outs[-1]["kp_weights"] = d_c.new_zeros((i_dim, n, kp_pos.shape[1]))
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
        cap = self.cfg.shading_budget
        m = pts_mask.shape[-1]
        if cap is not None and cap < select_rays * m:
            # pack each instance's valid slots to the fixed budget (the
            # deepest samples drop first, evenly across rays, on overflow)
            rank, n_valid = budget_ranks(pts_mask)
            c_mask = torch.arange(cap, device=rank.device) < n_valid.clamp(max=cap)[:, None]
            table = pts.reshape(i_dim, -1, 3)
            if self.opts.field.use_dir:  # the ray directions packed with the points
                table = torch.cat([table, rays_d[:, :, None, :].expand(-1, -1, m, -1).reshape(
                    i_dim, -1, 3)], dim=-1)  # [I, R*m, 6]
            packed = pack_rows(table, rank, cap)
            c_pts = packed[..., :3]
            c_rayd = packed[..., 3:] if self.opts.field.use_dir else None
            nb_idx, nb_mask = knn_neighbors(c_pts, c_mask, kp_pos, self.opts.aggregator.k,
                                            self.opts.knn_radius)
            chunk_fn = self._budget_chunk
            arrays = (depths_c, ray_end, rank, c_pts, c_rayd, c_mask, kp_pos, kp_feat, nb_idx,
                      nb_mask)
        else:
            nb_idx, nb_mask = self._neighbors(pts, pts_mask, kp_pos)
            chunk_fn = self._train_chunk
            arrays = (depths_c, pts_mask, pts, rays_d, ray_end, kp_pos, kp_feat, nb_idx,
                      nb_mask)

        ic = min(self.cfg.train_instance_chunk, i_dim)
        remat = self.cfg.resolved_train_remat()
        outs = []
        for c0 in range(0, i_dim, ic):
            args = tuple(None if a is None else a[c0:c0 + ic] for a in arrays)
            if remat:
                outs.append(checkpoint(chunk_fn, *args, use_reentrant=False))
            else:
                outs.append(chunk_fn(*args))
        mask, depth, channels = (torch.cat(c, dim=0) for c in zip(*outs))
        return {"mask": mask, "depth": depth, "channels": channels,
                "ray_valid": pts_mask.any(-1), "sel_idx": sel_idx}

    # -- public API -----------------------------------------------------------

    def forward(self, obj_idx: torch.Tensor, intrinsics: torch.Tensor,
                extrinsics: torch.Tensor, pixel_idx: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None, mesh=None,
                table_rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
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
        [0, 1), as npcd_tpu's ``draws``, and ray_scores [B*V, R_pre] (the
        uniform scores whose descending order among the valid rays is the
        selection order). aux holds coords, feats (the means),
        feats_mean, feats_log_var and feats_std [B, P, ...].

        With ``mesh`` (parallel.Mesh) the objects are this rank's rows of a
        global batch of B x world: each draw is taken for the global batch
        (and ``draws`` gives the global batch's), and this rank keeps its
        rows. ``table_rows`` = (coords [B, P, 3], feats [B, P, 2F]) are the
        objects' rows in place of the tables' (the row-sharded tables'
        fetch, parallel/pointnerf_sharding.py)."""
        o = self.opts
        draws = draws or {}
        b, v = extrinsics.shape[:2]
        i_dim = b * v
        world = mesh_world(mesh)
        dev = extrinsics.device
        if table_rows is None:
            coords = self.tables.coords_table[obj_idx]
            f_mean, f_log_var, f_std = feats_mean_log_var_std(self.tables.feats_table, obj_idx)
        else:
            coords = table_rows[0]
            f_mean, f_log_var, f_std = mean_log_var_std(table_rows[1])
        eps = draws.get("feats_eps")
        if eps is None:
            eps = torch.randn((b * world, *f_std.shape[1:]), generator=generator, device=dev)
        feats = f_mean + f_std * shard_batch(eps, mesh)
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
            jitter = torch.rand((i_dim * world, r_dim, o.renderer.depth_resolution),
                                generator=generator, device=dev)
        scores = draws.get("ray_scores")
        if scores is None:
            scores = torch.rand((i_dim * world, r_dim), generator=generator, device=dev)
        out = self._render_core(rep(coords), rep(feats), occ, rays_o, rays_d,
                                o.aggregator.max_shading_pts, self.cfg.eval_ray_chunk,
                                shard_batch(jitter, mesh), shard_batch(scores, mesh),
                                self.cfg.train_rays)
        reshape = lambda a: a.reshape(b, v, *a.shape[1:])
        return {"mask": reshape(out["mask"])[..., None],
                "depth": reshape(out["depth"])[..., None],
                "channels": reshape(out["channels"]),
                "ray_valid": reshape(out["ray_valid"]),
                "ray_idx": reshape(pixel_idx[out["sel_idx"]]),
                "ray_sel": reshape(out["sel_idx"])}, aux

    @torch.no_grad()
    def eval_forward(self, obj_idx: torch.Tensor, intrinsics: torch.Tensor,
                     extrinsics: torch.Tensor, resolution: Optional[int] = None,
                     kp_weights: bool = False) -> Dict[str, torch.Tensor]:
        """npcd_tpu's ``forward(train=False)``: objects obj_idx [B] of the
        tables, their coords and the feats **mean**, rendered from
        intrinsics [B, V, 3, 3] and world2cam extrinsics [B, V, 4, 4] at
        ``resolution`` (default_resolution when None) -> ``render``'s dict."""
        return self.render(self.get_all_coords()[obj_idx], self.get_all_feats()[obj_idx],
                           extrinsics, intrinsics,
                           resolution=resolution or self.opts.default_resolution,
                           kp_weights=kp_weights)

    @torch.no_grad()
    def render(self, coords: torch.Tensor, feats: torch.Tensor, extrinsics: torch.Tensor,
               intrinsics: torch.Tensor, resolution: int = 128,
               max_shading_points: Optional[int] = None,
               kp_weights: bool = False) -> Dict[str, torch.Tensor]:
        """Render point clouds coords [B, P, 3], feats [B, P, F] from
        extrinsics [B, V, 4, 4] (world2cam) and intrinsics [B, V, 3, 3] ->
        {mask [B, V, R, 1], depth [B, V, R, 1], channels [B, V, R, 3],
        ray_valid [B, V, R]}, R = resolution**2. ``kp_weights``: also the
        point-attribution diagnostic kp_weights [B, V, R, P], each point's
        aggregation weight composited along the ray (npcd_tpu's render
        kp_weights=True; the chunks then shade every slot block). Runs under
        the render config's ``matmul_precision``."""
        with matmul_precision(self.cfg.matmul_precision):
            return self._render(coords, feats, extrinsics, intrinsics, resolution,
                                max_shading_points, kp_weights)

    def _render(self, coords, feats, extrinsics, intrinsics, resolution, max_shading_points,
                kp_weights) -> Dict[str, torch.Tensor]:
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
            max_shading_points or o.aggregator.max_shading_pts, self.cfg.eval_ray_chunk,
            kp_weights=kp_weights)
        reshape = lambda a: a.reshape(b, v, *a.shape[1:])
        res = {
            "mask": reshape(out["mask"])[..., None],
            "depth": reshape(out["depth"])[..., None],
            "channels": reshape(out["channels"]),
            "ray_valid": reshape(out["ray_valid"]),
        }
        if kp_weights:
            res["kp_weights"] = reshape(out["kp_weights"])
        return res
