"""Tensor-parallel sharding rules and collectives of the NPCD denoiser. Port
of npcd_tpu/parallel/tp.py and of the two Megatron operators of
npcd_tpu/models/diffusion/transformer.py (tp_replicate, RowParallelDense's
psum).

Over the 'model' axis of a (data, model) mesh (parallel/mesh.py) every
block's fused qkv projection and MLP up-projection, and time_embed's c_fc,
are split on their output columns; the grouped [Q|K|V] layout makes the
qkv split head-aligned (tp | qkv_groups), so attention runs on the local
heads alone. Their c_proj weights are split on their input rows, and the
partial products are summed over the model group before the replicated
bias is added once. Everything else is replicated.

The port's Dense weights are torch's [out, in]: a column split is dim 0 of
the weight (and the bias), a row split dim 1. Shard m of tp holds the m-th
of tp equal contiguous blocks, as a NamedSharding over 'model' does.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

_COL_PARALLEL = ("c_qkv", "c_fc")   # weight [out, in] -> split out (dim 0), bias too
_ROW_PARALLEL = ("c_proj",)          # weight [out, in] -> split in (dim 1)


def shard_dim(name: str) -> Optional[int]:
    """The dimension of parameter ``name`` (the port's NPCDTransformer
    state-dict name) that the model axis splits, or None (replicated)."""
    parts = name.split(".")
    if not (parts[0] in ("resblocks", "time_embed")) or len(parts) < 2:
        return None
    module, kind = parts[-2], parts[-1]
    if module in _COL_PARALLEL:
        return 0
    if module in _ROW_PARALLEL and kind == "weight":
        return 1
    return None


def denoiser_param_specs(names: Sequence[str]) -> Dict[str, Optional[int]]:
    """{name: the split dimension, or None when replicated}: npcd_tpu's
    denoiser_param_specs over the port's parameter names."""
    return {n: shard_dim(n) for n in names}


def shard(x: torch.Tensor, dim: Optional[int], tp: int, model_index: int) -> torch.Tensor:
    """Model rank ``model_index``'s block of ``x`` along ``dim`` (a view;
    ``x`` itself when dim is None)."""
    if dim is None or tp == 1:
        return x
    n = x.shape[dim]
    if n % tp:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not divide by tp={tp}")
    return x.narrow(dim, model_index * (n // tp), n // tp)


def shard_denoiser_state(full: Mapping[str, torch.Tensor], tp: int,
                         model_index: int) -> Dict[str, torch.Tensor]:
    """A full denoiser state dict -> this model rank's shards (contiguous
    copies; replicated leaves as they are)."""
    return {n: shard(torch.as_tensor(v), shard_dim(n), tp, model_index).contiguous()
            for n, v in full.items()}


def unshard_denoiser_state(shards: Sequence[Mapping[str, torch.Tensor]]
                           ) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_denoiser_state``: every model rank's shards, in
    model-index order -> the full state dict (replicated leaves from rank 0)."""
    out = {}
    for n, v in shards[0].items():
        dim = shard_dim(n)
        out[n] = v if dim is None or len(shards) == 1 else torch.cat(
            [torch.as_tensor(s[n]) for s in shards], dim)
    return out


class TPReplicate(torch.autograd.Function):
    """Megatron's "f": identity forward, the cotangent summed over the model
    group backward, so that a replicated activation entering a
    column-parallel branch gets its whole cotangent."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.mesh.all_reduce_(g, "model")
        return g, None


class TPReduce(torch.autograd.Function):
    """Megatron's "g" of a row-parallel projection: the partial products
    summed over the model group forward, identity backward (each rank's
    partial product takes the whole cotangent of the sum)."""

    @staticmethod
    def forward(ctx, y, mesh):
        y = y.contiguous().clone()
        mesh.all_reduce_(y, "model")
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_replicate(x: torch.Tensor, mesh) -> torch.Tensor:
    return TPReplicate.apply(x, mesh)


def tp_reduce(y: torch.Tensor, mesh) -> torch.Tensor:
    return TPReduce.apply(y, mesh)
