"""The explicit-reduce data-parallel stage-2 step. Port of
npcd_tpu/parallel/shard_map_step.py (make_shard_map_diffusion_step).

npcd_tpu's step on a mesh equals its step on the global batch: per-example
keys make each example's (t, noise) the same on every shard, and the psum
of the per-shard mean gradients over the shard count is the global mean.
Here every rank draws the step's (t, coords noise, feats noise) for the
whole global batch from the same seeded generator and keeps its own rows,
then one all-reduce of the flat gradient buffer over the data group,
divided by its size (the world at tp 1), gives the global gradient before
kernel K3 updates the replicated parameters, Adam's moments and the EMAs
on every rank (train/diffusion_training.py). The loss terms are means over
fixed counts, so the mean over ranks of their per-rank means is the global
mean.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .mesh import Mesh, shard_batch


def global_row_draws(model, n_local: int, coords_shape, feats_shape, generator: torch.Generator,
                     mesh: Optional[Mesh]):
    """This rank's rows of the step's (t, coords noise, feats noise), drawn
    for the global batch of n_local x dp examples (the model ranks of a data
    index keep the same rows)."""
    dp = 1 if mesh is None else mesh.dp
    draws = model.loss_draws(n_local * dp, coords_shape, feats_shape, generator)
    return shard_batch(draws, mesh)


def all_reduce_mean_(grads: torch.Tensor, metrics: Dict[str, torch.Tensor],
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The mean over the data group (every rank at tp 1) of the flat
    gradient buffer ``grads`` (in place, one all-reduce) and of the scalar
    ``metrics`` (one more) -> the metrics' means. Under tp the model ranks
    hold different shards, so the mean must not reach across them
    (parallel/tp_step.py)."""
    mesh.all_reduce_(grads, "data").div_(mesh.dp)
    names = list(metrics)
    values = mesh.all_reduce_(torch.stack([metrics[k].detach().float() for k in names]), "data")
    values = values / mesh.dp
    return {k: values[i] for i, k in enumerate(names)}
