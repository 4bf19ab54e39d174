"""Dense masked kNN aggregation. Port of
npcd_tpu/models/pointnerf/aggregator.py (compact_valid_samples,
knn_neighbors, aggregate_features through _aggregate_posenc_fused and its
XLA branch, and the training shading budget's pack_rows and gather_rows).
The one-hot matmul gathers the TPU needed become index gathers; for the
kernel's activation, leaky_relu, the per-pair MLP, its positional encoding
and the k-neighbour weighted sum run in kernel K6
(ops/kernels/fused_mlp_posenc.py), forward and backward, in f32 or, under
compute_dtype bfloat16, in bf16 (kp_feat and the weights cast at use; x_rel,
distances and the weights w stay f32): the w-sum inside the kernel where
npcd_tpu's ``wsum_supported`` holds, else the kernel's no-reduction form
and the w-sum outside (fewer than 8 points). Any other activation runs
npcd_tpu's XLA branch as plain tensor code: the encoded pairs through
apply_mlp, then the w-sum.

Gradient contract (npcd_tpu aggregator.py:197-211): the gradient reaches
kp_feat (through the neighbour gather) and the MLP weights only; kp_pos,
x_rel and the inverse-distance weights are detached. On CUDA the gather's
backward is a scatter-add with atomics, so kp_feat's gradient can differ
in its last bits from run to run."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...ops.kernels.fused_mlp_posenc import fused_mlp_posenc, fused_mlp_posenc_wsum
from ...ops.knn import dense_knn_batched
from ...utils.config import AggregatorOptions
from .nn_core import Layers, apply_mlp, positional_encoding

WSUM_BLOCK = 1024  # npcd_tpu's _BLK: the pair block its w-sum kernel must fill with 8 k


def wsum_supported(m: int, k: int) -> bool:
    """npcd_tpu's gate of the w-summing kernel (fused_mlp.py:619) at m pairs
    of k neighbours: else the aggregator takes the no-reduction form."""
    return k > 0 and m % k == 0 and min(WSUM_BLOCK, m) >= 8 * k


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


def pack_rows(table: torch.Tensor, rank: torch.Tensor, cap: int) -> torch.Tensor:
    """out[b, rank[b, n]] = table[b, n] for rank < cap: table [B, N, C], rank
    [B, N] a permutation of 0 .. N-1 per row -> [B, cap, C]. A gather through
    the inverse permutation, so every output row has exactly one source and
    the backward (a scatter-add with distinct indices) is deterministic."""
    src = torch.empty_like(rank)
    src.scatter_(1, rank, torch.arange(rank.shape[1], device=rank.device).expand_as(rank))
    return torch.gather(table, 1, src[:, :cap, None].expand(-1, -1, table.shape[2]))


def gather_rows(packed: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """[B, N, C]: row n is packed[b, rank[b, n]] where rank < cap =
    packed.shape[1], else 0 (npcd_tpu's gather_rows(packed, min(rank, cap -
    1)) masked by rank < cap). The masked rows send exactly 0 back to the
    row they were clamped to."""
    cap = packed.shape[1]
    idx = rank.clamp(max=cap - 1)[..., None].expand(-1, -1, packed.shape[2])
    full = torch.gather(packed, 1, idx)
    return torch.where((rank < cap)[..., None], full, torch.zeros_like(full))


class _GatherColsBf16(torch.autograd.Function):
    """torch.gather(table_t, 2, idx) of a bf16 table whose backward sums the
    cotangent in f32 and rounds the table's gradient to bf16 once (npcd_tpu's
    one-hot matmul gather), where a bf16 scatter-add would round every add."""

    @staticmethod
    def forward(ctx, table_t, idx):
        ctx.save_for_backward(idx)
        ctx.n_cols = table_t.shape[2]
        return torch.gather(table_t, 2, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        dtable = g.new_zeros(g.shape[:2] + (ctx.n_cols,), dtype=torch.float32)
        dtable.scatter_add_(2, idx, g.float())
        return dtable.to(torch.bfloat16), None


def knn_neighbors(shading_pts: torch.Tensor, pts_mask: torch.Tensor, kp_pos: torch.Tensor,
                  k: int, radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN indices [B, N, k] and the in-radius mask of each valid shading point."""
    idx, nb_mask = dense_knn_batched(shading_pts, kp_pos, k, radius)
    return idx, nb_mask & pts_mask[..., None]


def _wsum(w: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """sum_j w[b, n, j] local[b, n, j] in local's dtype (npcd_tpu's einsum
    'bnk,bnkc->bnc' with w cast to it; bf16 summed in f32, rounded once)."""
    if local.dtype == torch.bfloat16:
        prod = w.to(torch.bfloat16).float()[..., None] * local.float()
        return prod.sum(2).to(torch.bfloat16)
    return torch.einsum("bnk,bnkc->bnc", w.to(local.dtype), local)


def aggregate_features(layers: Layers, opts: AggregatorOptions,
                       shading_pts: torch.Tensor, pts_mask: torch.Tensor,
                       kp_pos: torch.Tensor, kp_feat: torch.Tensor,
                       neighbors: Tuple[torch.Tensor, torch.Tensor],
                       compute_dtype: Optional[torch.dtype] = None,
                       return_weights: bool = False):
    """shading_pts [B, N, 3], pts_mask [B, N], kp_pos [B, P, 3],
    kp_feat [B, P, F] -> (feat [B, N, out_dim], valid_pt [B, N]), and with
    ``return_weights`` also the pair weights w [B, N, k] (0 at masked
    pairs) and the neighbour indices [B, N, k].

    Per (point, neighbour) pair: x_rel = point - neighbour, the normalized
    inverse-distance weight w over the in-radius neighbours, and
    mlp([feat | x_rel | posenc(x_rel)]); the point's feature is the
    w-weighted sum over its k pairs. ``neighbors``: (idx, nb_mask) [B, N, k]
    from ``knn_neighbors`` (training runs it once per step, outside its
    recomputed chunks). compute_dtype bfloat16: feat is bf16, and the
    gradient reaching kp_feat and the weights is a bf16 value upcast."""
    shading_pts, kp_pos = shading_pts.detach(), kp_pos.detach()
    idx, nb_mask = neighbors
    b, n, k = idx.shape
    flat = idx.reshape(b, 1, n * k).long()
    nb_pos_t = torch.gather(kp_pos.transpose(1, 2), 2, flat.expand(b, 3, -1))  # [B, 3, M]
    feat_idx = flat.expand(b, kp_feat.shape[-1], -1)
    weights = [(l["w"], l["b"]) for l in layers]
    if compute_dtype == torch.bfloat16:
        feat_t = _GatherColsBf16.apply(kp_feat.to(torch.bfloat16).transpose(1, 2), feat_idx)
        weights = [(w.to(torch.bfloat16), b_.to(torch.bfloat16)) for w, b_ in weights]
    else:
        feat_t = torch.gather(kp_feat.transpose(1, 2), 2, feat_idx)  # [B, F, M]
    x_rel_t = (shading_pts.transpose(1, 2)[..., None]
               - nb_pos_t.reshape(b, 3, n, k)).reshape(b, 3, n * k)
    dist = torch.sqrt((x_rel_t * x_rel_t).sum(1)).reshape(b, n, k)
    w = (1.0 / (dist + 1e-5)) * nb_mask.to(dist.dtype)
    w_sum = w.sum(-1, keepdim=True)
    w = torch.where(w_sum > 0, w / w_sum, torch.zeros_like(w))
    enc = (opts.n_freqs, opts.freq_mult, opts.posenc_method)
    if opts.activation != "leaky_relu":
        # npcd_tpu's XLA branch: [feat | x_rel | posenc(x_rel)] per pair
        field_in = torch.cat([feat_t.transpose(1, 2).float(),
                              positional_encoding(x_rel_t.transpose(1, 2), *enc)], dim=-1)
        local = apply_mlp(layers, field_in, act=opts.activation, compute_dtype=compute_dtype)
        feat = _wsum(w, local.reshape(b, n, k, -1))
    elif wsum_supported(n * k, k):
        pos_t = torch.cat([x_rel_t, w.reshape(b, 1, n * k),
                           x_rel_t.new_zeros((b, 4, n * k))], dim=1)  # [B, 8, M]
        feat = fused_mlp_posenc_wsum(feat_t.contiguous(), pos_t, weights, k, *enc)
    else:
        pos_t = torch.cat([x_rel_t, x_rel_t.new_zeros((b, 5, n * k))], dim=1)
        local = fused_mlp_posenc(feat_t.contiguous(), pos_t, weights, *enc)  # [B, M, out]
        feat = _wsum(w, local.reshape(b, n, k, -1))
    valid_pt = pts_mask & nb_mask.any(-1)
    if return_weights:
        return feat, valid_pt, w, idx
    return feat, valid_pt
