"""EMA configuration and decay schedule. Port of npcd_tpu/utils/ema.py
without JAX: the decay ``1 - (1 + n/inv_gamma)^-power`` clamped to
[min_value, max_value] is computed in float32 with numpy scalars, as the
JAX package computes it in f32 on the device. The lerp
``ema = ema*d + params*(1-d)`` itself runs inside kernel K3
(ops/kernels/fused_adamw.py)."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class EmaConfig:
    power: float = 1.0
    min_value: float = 0.0
    max_value: float = 1.0
    ema_on_buffers: bool = False  # kept for checkpoint-name parity
    inv_gamma: float = 1.0
    start_at: int = 0

    @classmethod
    def from_tuple(cls, t: Sequence) -> "EmaConfig":
        power, min_value, max_value, buffers = t
        return cls(power=float(power), min_value=float(min_value),
                   max_value=float(max_value), ema_on_buffers=bool(buffers))

    def param_string(self) -> str:
        """Checkpoint-name encoding (reference ema.py:52-56):
        power1_0min0_9999max0_9999buffers0."""
        s = (f"power{float(self.power)}min{float(self.min_value)}"
             f"max{float(self.max_value)}buffers{int(self.ema_on_buffers)}")
        return s.replace(".", "_")


def ema_decay(cfg: EmaConfig, step: int) -> np.float32:
    """Decay at the (0-indexed) update count ``step``, in float32."""
    f32 = np.float32
    epoch = f32(max(0, int(step) - cfg.start_at))
    value = f32(1.0) - (f32(1.0) + epoch / f32(cfg.inv_gamma)) ** f32(-cfg.power)
    return np.clip(value, f32(cfg.min_value), f32(cfg.max_value)).astype(f32)
