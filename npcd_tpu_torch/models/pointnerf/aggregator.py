"""Dense masked kNN aggregation. Port of
npcd_tpu/models/pointnerf/aggregator.py (compact_valid_samples,
knn_neighbors, aggregate_features through _aggregate_posenc_fused). The
one-hot matmul gathers the TPU needed become index gathers; the per-pair
MLP, its positional encoding and the k-neighbour weighted sum run in
kernel K6 (ops/kernels/fused_mlp_posenc.py), forward and backward.

Gradient contract (npcd_tpu aggregator.py:197-211): the gradient reaches
kp_feat (through the neighbour gather) and the MLP weights only; kp_pos,
x_rel and the inverse-distance weights are detached. On CUDA the gather's
backward is a scatter-add with atomics, so kp_feat's gradient can differ
in its last bits from run to run."""
from __future__ import annotations

from typing import Tuple

import torch

from ...ops.kernels.fused_mlp_posenc import fused_mlp_posenc_wsum
from ...ops.knn import dense_knn_batched
from ...utils.config import AggregatorOptions
from .nn_core import Layers


def compact_valid_samples(valid: torch.Tensor, depths: torch.Tensor,
                          max_shading_pts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack the first ``max_shading_pts`` valid samples of each ray to the
    front in depth order: valid/depths [..., S] -> (depths_c [..., M],
    prefix mask [..., M]). Slots past the mask hold 0."""
    m = max_shading_pts
    csum = torch.cumsum(valid.to(torch.int32), dim=-1)
    keep = valid & (csum <= m)
    slot = torch.where(keep, csum - 1, torch.full_like(csum, m)).long()  # dropped -> slot m
    depths_c = depths.new_zeros(depths.shape[:-1] + (m + 1,))
    depths_c.scatter_(-1, slot, torch.where(keep, depths, torch.zeros_like(depths)))
    mask = torch.zeros(depths_c.shape, dtype=torch.bool, device=depths.device)
    mask.scatter_(-1, slot, keep)
    return depths_c[..., :m], mask[..., :m]


def knn_neighbors(shading_pts: torch.Tensor, pts_mask: torch.Tensor, kp_pos: torch.Tensor,
                  k: int, radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN indices [B, N, k] and the in-radius mask of each valid shading point."""
    idx, nb_mask = dense_knn_batched(shading_pts, kp_pos, k, radius)
    return idx, nb_mask & pts_mask[..., None]


def aggregate_features(layers: Layers, opts: AggregatorOptions,
                       shading_pts: torch.Tensor, pts_mask: torch.Tensor,
                       kp_pos: torch.Tensor, kp_feat: torch.Tensor,
                       neighbors: Tuple[torch.Tensor, torch.Tensor]):
    """shading_pts [B, N, 3], pts_mask [B, N], kp_pos [B, P, 3],
    kp_feat [B, P, F] -> (feat [B, N, out_dim], valid_pt [B, N]).

    Per (point, neighbour) pair: x_rel = point - neighbour, the normalized
    inverse-distance weight w over the in-radius neighbours, and
    mlp([feat | x_rel | posenc(x_rel)]); the point's feature is the
    w-weighted sum over its k pairs. ``neighbors``: (idx, nb_mask) [B, N, k]
    from ``knn_neighbors`` (training runs it once per step, outside its
    recomputed chunks)."""
    if opts.activation != "leaky_relu":
        raise ValueError(f"the aggregation kernel applies leaky_relu; got {opts.activation!r}")
    shading_pts, kp_pos = shading_pts.detach(), kp_pos.detach()
    idx, nb_mask = neighbors
    b, n, k = idx.shape
    flat = idx.reshape(b, 1, n * k).long()
    nb_pos_t = torch.gather(kp_pos.transpose(1, 2), 2, flat.expand(b, 3, -1))  # [B, 3, M]
    feat_t = torch.gather(kp_feat.transpose(1, 2), 2,
                          flat.expand(b, kp_feat.shape[-1], -1))  # [B, F, M]
    x_rel_t = (shading_pts.transpose(1, 2)[..., None]
               - nb_pos_t.reshape(b, 3, n, k)).reshape(b, 3, n * k)
    dist = torch.sqrt((x_rel_t * x_rel_t).sum(1)).reshape(b, n, k)
    w = (1.0 / (dist + 1e-5)) * nb_mask.to(dist.dtype)
    w_sum = w.sum(-1, keepdim=True)
    w = torch.where(w_sum > 0, w / w_sum, torch.zeros_like(w))
    pos_t = torch.cat([x_rel_t, w.reshape(b, 1, n * k),
                       x_rel_t.new_zeros((b, 4, n * k))], dim=1)  # [B, 8, M]
    feat = fused_mlp_posenc_wsum(
        feat_t.contiguous(), pos_t, [(l["w"], l["b"]) for l in layers], k,
        opts.n_freqs, opts.freq_mult, opts.posenc_method)
    return feat, pts_mask & nb_mask.any(-1)
