"""The tensor(+data)-parallel stage-2 step. Port of
npcd_tpu/parallel/tp_step.py (train_state_specs and shard_train_state:
``TPLayout``; make_tp_diffusion_train_step: the two reduces below, which
DiffusionTraining.train_step runs under tp).

Each rank holds its model rank's shards (parallel/tp.py) of the denoiser's
parameters, Adam's moments and the EMAs, as views of its own flat buffers
(``TPLayout``: the local flat buffer against the full one of a tp=1 run),
and runs the denoiser built with tp (models/diffusion/transformer.py) on
its data index's rows of the global batch. After the backward:

  * the gradients and the loss terms are averaged over the **data group**
    only (shard_map_step.all_reduce_mean_): the sharded leaves' gradients
    are shard-local by construction and the replicated leaves' already
    whole (tp_replicate's backward sum), so a reduce over the world would
    mix the columns of different shards;
  * grad_norm = sqrt(the model group's sum of the sharded leaves' squares +
    the replicated leaves' squares, counted once), which the fused update
    takes for the clip in place of its own buffer's norm;
  * kernel K3 updates the local buffers.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh
from .tp import shard, shard_dim


class TPLayout:
    """A model rank's flat buffer (its shards, in parameter order) against
    the full flat buffer of a tp=1 run (``names``, ``full_shapes``)."""

    def __init__(self, names: Sequence[str], full_shapes: Sequence[Tuple[int, ...]], tp: int,
                 model_index: int):
        self.names = list(names)
        self.full_shapes = [tuple(s) for s in full_shapes]
        self.tp, self.model_index = tp, model_index
        self.dims = [shard_dim(n) for n in self.names]
        self.local_shapes = [
            s if d is None else s[:d] + (s[d] // tp,) + s[d + 1:]
            for s, d in zip(self.full_shapes, self.dims)]
        self.full_offsets = np.concatenate(
            [[0], np.cumsum([int(np.prod(s)) for s in self.full_shapes])]).tolist()
        self.local_offsets = np.concatenate(
            [[0], np.cumsum([int(np.prod(s)) for s in self.local_shapes])]).tolist()
        self._replicated: Dict[torch.device, torch.Tensor] = {}

    @property
    def full_numel(self) -> int:
        return self.full_offsets[-1]

    def full_view(self, flat: torch.Tensor, i: int) -> torch.Tensor:
        return flat[self.full_offsets[i]:self.full_offsets[i + 1]].view(self.full_shapes[i])

    def local_view(self, flat: torch.Tensor, i: int) -> torch.Tensor:
        return flat[self.local_offsets[i]:self.local_offsets[i + 1]].view(self.local_shapes[i])

    def full_as_dict(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: self.full_view(flat, i) for i, n in enumerate(self.names)}

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This model rank's flat buffer of a full flat buffer (a copy)."""
        return torch.cat([shard(self.full_view(full, i), d, self.tp, self.model_index).reshape(-1)
                          for i, d in enumerate(self.dims)])

    def full(self, local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        """The full flat buffer of every model rank's ``local`` buffer: each
        places its shards (and model index 0 the replicated leaves) in a
        zeroed buffer, summed over the model group (exact: every element
        has one writer) -> on every rank of the group."""
        out = torch.zeros(self.full_numel, device=local.device, dtype=local.dtype)
        for i, d in enumerate(self.dims):
            if d is None and self.model_index:
                continue
            shard(self.full_view(out, i), d, self.tp, self.model_index).copy_(
                self.local_view(local, i))
        return mesh.all_reduce_(out, "model")

    def replicated_index(self, device) -> torch.Tensor:
        """int64 [n]: the local buffer's elements of replicated leaves."""
        device = torch.device(device)
        if device not in self._replicated:
            self._replicated[device] = torch.cat(
                [torch.arange(self.local_offsets[i], self.local_offsets[i + 1])
                 for i, d in enumerate(self.dims) if d is None]).to(device)
        return self._replicated[device]


def tp_grad_norm(grads: torch.Tensor, layout: TPLayout, mesh: Mesh) -> torch.Tensor:
    """The global norm of the whole (unsharded) gradient: the sharded
    leaves' sum of squares summed over the model group, the replicated
    leaves' (the same on every model rank) counted once (npcd_tpu
    tp_step.py:160-172). One read of the local buffer and a gather of the
    replicated leaves, with no temporary of the buffer's size."""
    rep = torch.linalg.vector_norm(grads[layout.replicated_index(grads.device)]).square()
    sharded = torch.linalg.vector_norm(grads).square() - rep
    return torch.sqrt(mesh.all_reduce_(sharded.reshape(1), "model")[0] + rep)
