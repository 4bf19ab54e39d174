"""NPCD facade: the PointNeRF decoder and the diffusion model. Port of
npcd_tpu/models/npcd.py (``NPCD.from_config``), generation parts only."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..utils.builders import build_diffusion_model, build_pointnerf
from .diffusion.diffusion_model import DiffusionModel, DiffusionState
from .pointnerf.pointnerf import PointNeRF


class NPCD(nn.Module):
    def __init__(self, pointnerf: PointNeRF, diffusion: DiffusionModel):
        super().__init__()
        self.pointnerf = pointnerf
        self.diffusion = diffusion

    @classmethod
    def from_config(cls, config: Dict[str, Any], validity: Optional[str] = None,
                    seed: int = 0) -> "NPCD":
        """Build from a config dict of the repo's YAML schema; ``validity``
        overrides ``render_config.validity``. Weights are drawn from ``seed``
        (see ``init_seeded``)."""
        generator = torch.Generator().manual_seed(seed)
        pointnerf = build_pointnerf(config, generator)
        if validity is not None:
            pointnerf.cfg = dataclasses.replace(pointnerf.cfg, validity=validity)
        model = cls(pointnerf, build_diffusion_model(config))
        model.diffusion.denoiser.init_seeded(generator)
        return model

    def seeded_state(self, seed: int = 0, num_clouds: int = 16) -> DiffusionState:
        """Normalizer stats fitted on seeded stand-in latents, for runs
        without trained weights: coords on jittered ellipsoid surfaces inside
        the voxel grid's [-1, 1]^3, feats standard normal. The sampler's x0
        clip then keeps samples bounded and inside the render volume."""
        rng = np.random.default_rng(seed)
        p = self.diffusion.num_points
        d = rng.normal(size=(num_clouds, p, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        coords = d * np.array([0.45, 0.3, 0.8]) + rng.normal(scale=0.02, size=d.shape)
        feats = rng.normal(size=(num_clouds, p, self.diffusion.feats_dim))
        return DiffusionState.fit(coords.reshape(-1, 3).T, feats.reshape(-1, feats.shape[-1]).T)
