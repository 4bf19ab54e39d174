"""Stage-1 loss: reconstruction + KL + total variation. Port of
npcd_tpu/losses/pointnerf_loss.py:

  * reconstruction: squared error against the ground-truth pixels of the
    selected rays, gathered from the host-presampled pixels through
    pred['ray_sel'] (npcd_tpu's ``presampled_images=True``), a mean over the
    valid selected rays;
  * KL of the variational feature embeddings against N(0, 1);
  * TV: inverse-distance-weighted L1 feature difference over each point's
    k nearest in-radius neighbours in its own cloud (kNN through kernel K4).
    Self-pairs are kept: they add exactly 0.

With ``mesh`` (parallel.Mesh; data parallelism) each rank's loss is its
share of the global batch's: the reconstruction divides by the valid count
summed over the ranks (one all-reduce), KL and TV by the global batch, so
the sum of the ranks' losses, and of their gradients, is the global loss
and its gradient. A mean of per-rank means would weigh each rank's rays
equally whatever their valid counts.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..ops.knn import dense_knn_batched
from ..utils.config import PointNeRFOptions


class PointNeRFLossWeights(NamedTuple):
    image_reconstruction: float = 1.0
    neural_point_cloud_kl: float = 1.0
    neural_point_cloud_tv: float = 1.0


def image_reconstruction_loss(gt_images: torch.Tensor, pred: Dict[str, torch.Tensor],
                              weight: float = 1.0, mesh=None) -> torch.Tensor:
    """gt_images [B, V, R_pre, 3], the presampled pixels; each selected
    ray's pixel is gathered through pred['ray_sel']."""
    idx = pred["ray_sel"]
    gt = torch.gather(gt_images, 2, idx[..., None].long().expand(*idx.shape, gt_images.shape[-1]))
    err = (pred["channels"] - gt) ** 2  # [B, V, R, 3]
    valid = pred["ray_valid"][..., None].to(err.dtype)
    count = valid.sum()
    if mesh is not None:
        count = mesh.all_reduce_(count.detach().clone())
    denom = torch.clamp(count * err.shape[-1], min=1.0)
    return (err * valid).sum() / denom * weight


def neural_point_cloud_kl_loss(aux: Dict[str, torch.Tensor], weight: float = 1.0,
                               world: int = 1) -> torch.Tensor:
    mean, log_var = aux["feats_mean"], aux["feats_log_var"]
    kld = -0.5 * (1 + log_var - mean ** 2 - torch.exp(log_var)).sum(-1)
    return kld.mean() / world * weight


def neural_point_cloud_tv_loss(aux: Dict[str, torch.Tensor], opts: PointNeRFOptions,
                               weight: float = 1.0, world: int = 1) -> torch.Tensor:
    coords = aux["coords"].detach()  # [B, P, 3]
    feats = aux["feats"]  # [B, P, F], the mean embeddings
    idx, nb_mask = dense_knn_batched(coords, coords, opts.aggregator.k, opts.knn_radius)
    b, p, k = idx.shape
    flat = idx.reshape(b, p * k, 1).long()
    nb_pos = torch.gather(coords, 1, flat.expand(-1, -1, 3)).reshape(b, p, k, 3)
    nb_feat = torch.gather(feats, 1, flat.expand(-1, -1, feats.shape[-1])).reshape(b, p, k, -1)
    d = torch.linalg.vector_norm(nb_pos - coords[:, :, None, :], dim=-1)
    w = (1.0 / (d + 1e-5)) * nb_mask.to(d.dtype)
    feat_dist = (nb_feat - feats[:, :, None, :]).abs().sum(-1)  # L1
    return (w * feat_dist).sum(-1).mean() / world * weight


def pointnerf_loss(sample: Dict[str, torch.Tensor], pred: Dict[str, torch.Tensor],
                   aux: Dict[str, torch.Tensor], opts: PointNeRFOptions,
                   weights: PointNeRFLossWeights = PointNeRFLossWeights(), mesh=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    world = 1 if mesh is None else mesh.world
    recon = image_reconstruction_loss(sample["images"], pred, weights.image_reconstruction, mesh)
    kl = neural_point_cloud_kl_loss(aux, weights.neural_point_cloud_kl, world)
    tv = neural_point_cloud_tv_loss(aux, opts, weights.neural_point_cloud_tv, world)
    return recon + kl + tv, {"00_image_reconstruction_loss": recon,
                             "01_neural_point_cloud_kl": kl,
                             "02_neural_point_cloud_tv": tv}
