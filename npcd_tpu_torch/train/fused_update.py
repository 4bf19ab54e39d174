"""One-pass fused AdamW + EMA parameter update. Port of
npcd_tpu/train/fused_update.py (FusedAdamWEma): the same math as
optax.chain([clip_by_global_norm,] adamw(...)) followed by the EMA lerps,
in the same op order, run by kernel K3 (ops/kernels/fused_adamw.py) over
the trainer's flat buffers in place. The optimizer state is
{count, mu, nu}, optax's ScaleByAdamState.

Order of operations, as npcd_tpu's:
  1. count_inc = count + 1;
  2. bc1 = 1 - b1**f32(count_inc), bc2 likewise, both in f32;
  3. the EMA decays from the train-state ``step`` before its increment;
  4. with clipping, the global grad norm first (a pre-pass, as optax's
     global_norm) and g * min(1, max_norm / norm);
  5. p2 = p + (-lr) (mu_hat / (sqrt(nu_hat) + eps) + wd p), every leaf
     decayed (optax adamw has no mask here);
  6. ema = ema d + p2 (1 - d);
  7. grad_norm = sqrt(sum g^2), pre-clip.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.fused_adamw import adamw_ema
from ..utils.ema import EmaConfig, ema_decay


class AdamState(NamedTuple):
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FusedAdamWEma:
    """AdamW (+ optional global-norm clip) + N EMA copies, one pass."""

    learning_rate: float
    weight_decay: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip_max_norm: Optional[float] = None
    ema_cfgs: Tuple[EmaConfig, ...] = ()

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(0, torch.zeros_like(params), torch.zeros_like(params))

    def update(self, grads: torch.Tensor, params: torch.Tensor, adam: AdamState,
               emas: Optional[torch.Tensor], step: int,
               grad_norm: Optional[torch.Tensor] = None):
        """One step in place on params, adam.mu, adam.nu and emas
        [n_ema, *params.shape]; ``step`` is the train-state step counter
        (the EMA update count) -> (AdamState with count + 1, grad_norm).
        ``grad_norm`` (a device scalar) replaces the norm of ``grads`` for
        the clip and is returned: the tensor-parallel step's norm over every
        model rank's shards (parallel/tp_step.py), as npcd_tpu's
        ``update(grad_norm=)``."""
        count_inc = adam.count + 1
        # [bc1, bc2, clip scale, decays...] in f32, as npcd_tpu computes them
        # (fused_update.py:127-130)
        f32 = np.float32
        bc1 = f32(1.0) - f32(self.b1) ** f32(count_inc)
        bc2 = f32(1.0) - f32(self.b2) ** f32(count_inc)
        decays = [ema_decay(cfg, step) for cfg in self.ema_cfgs]
        scalars = torch.tensor(np.asarray([bc1, bc2, 1.0, *decays], np.float32),
                               device=params.device)
        if self.clip_max_norm:
            if grad_norm is None:
                grad_norm = torch.linalg.vector_norm(grads)
            scalars[2] = torch.where(grad_norm < self.clip_max_norm,
                                     torch.ones_like(grad_norm), self.clip_max_norm / grad_norm)
        sumsq = adamw_ema(grads, params, adam.mu, adam.nu, emas, scalars, b1=self.b1,
                          b2=self.b2, eps=self.eps, lr=self.learning_rate,
                          wd=self.weight_decay, use_clip=bool(self.clip_max_norm))
        if grad_norm is None:
            grad_norm = torch.sqrt(sumsq)
        return AdamState(count_inc, adam.mu, adam.nu), grad_norm
